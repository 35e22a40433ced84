"""The port's LM archs beyond Gemma-2B (GLM4-9B, Gemma-7B,
DeepSeek-Coder-33B, RecurrentGemma-2B, RWKV-6-3B) against the JAX
package, on the reference's SMOKE configs and its own weights
(``init_params(PRNGKey(0))``, carried across with
``carry.lm_params_from_numpy``).  The MoE archs and Whisper / Qwen2-VL
have their own files (``test_torch_lm_moe.py``,
``test_torch_lm_encdec.py``) and join the config, tree and cache tests
here.

* the registry holds all ten archs; configs equal field for field;
  ``init_params`` trees and ``init_cache`` equal in structure, shapes and
  dtypes (caches in value too);
* blocks in float32 to 1e-5 relative L2: windowed ``attention`` and
  windowed ``decode_attention``, ``conv1d_causal`` (full and streaming),
  ``_rglru_scan`` (a log-depth scan here, ``lax.associative_scan``
  there) and ``rglru_block``, ``_rwkv_chunk_scan`` (two chunks and an
  irregular S), ``_rwkv_step``, ``rwkv6_block``, ``rwkv6_channel_mix``,
  the ungated ``ffn``s; the ring ``cache_update`` exact at wrapping slots;
* prefill plus 4 decode steps against the reference's own, at the
  reference's bar (rtol = atol = 2e-4, ``tests/test_lm_archs.py``), and
  the ring-buffer mirror of ``test_recurrentgemma_ring_buffer_wraps``;
* with ``quant="radix"`` (T = 4, packed KV, packed decode attention), the
  port's kernel path (the plain versions on the CPU) against the
  reference's kernels backend (Pallas in interpret mode): 1e-3 relative
  L2 and the same greedy tokens at every step;
* ``check_supported`` rejects what is not ported (MoE mesh dispatch) or
  unknown (a block type).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.configs import get_config as jget
from repro.lm import blocks as jblocks
from repro.lm import model as jmodel
from repro.lm import radix as jradix
from repro_torch import carry, configs
from repro_torch.configs import get_config as tget
from repro_torch.lm import blocks as tblocks
from repro_torch.lm import model as tmodel
from repro_torch.lm import radix as tradix
from repro_torch.lm.config import ArchConfig, MoEConfig

ARCHS = ["glm4_9b", "gemma_7b", "deepseek_coder_33b", "recurrentgemma_2b",
         "rwkv6_3b"]
LATER = ["grok_1_314b", "kimi_k2_1t_a32b", "whisper_medium", "qwen2_vl_72b"]
B = 2
RADIX = dict(quant="radix", radix_steps=4, radix_kv_pack=True,
             packed_attn=True)


def _t(a):
    return torch.from_numpy(np.array(a))


def _j(a):
    return jnp.asarray(np.asarray(a))


def _close(got, want, rtol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)
    assert err <= rtol, f"relative L2 error {err:.3g} > {rtol}"
    return err


def _tree_leaves(t, path=()):
    if isinstance(t, dict):
        for k in sorted(t):
            yield from _tree_leaves(t[k], path + (k,))
    elif isinstance(t, (tuple, list)):
        for i, v in enumerate(t):
            yield from _tree_leaves(v, path + (i,))
    else:
        yield path, t


def _tree_close(got, want, rtol):
    got, want = dict(_tree_leaves(got)), dict(_tree_leaves(want))
    assert set(got) == set(want)
    for path in got:
        assert tuple(got[path].shape) == want[path].shape, path
        _close(got[path].numpy(), want[path], rtol)


_WEIGHTS = {}


def _weights(arch):
    """The reference's SMOKE params (JAX tree, numpy tree), made once."""
    if arch not in _WEIGHTS:
        p = jmodel.init_params(jax.random.PRNGKey(0), jget(arch, smoke=True))
        _WEIGHTS[arch] = (p, jax.tree.map(np.asarray, p))
    return _WEIGHTS[arch]


def _layer(arch, slot):
    """Layer 0 of pattern slot ``slot`` of segment 0, both sides."""
    _, npar = _weights(arch)
    lp = jax.tree.map(lambda a: a[0], npar["segments"][0][slot])
    return (jax.tree.map(jnp.asarray, lp),
            carry.lm_params_from_numpy(lp, tget(arch, smoke=True)))


def _rng(seed):
    return np.random.default_rng(seed)


# ---------------------------------------------------------------------------
# Configs, parameter trees, caches.
# ---------------------------------------------------------------------------


def test_registry_holds_ported_archs():
    assert configs.LM_ARCHS == ["gemma_2b"] + ARCHS + LATER
    assert sorted(configs.LM_ARCHS) == sorted(jconfigs.LM_ARCHS)


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", ARCHS + LATER)
def test_configs_equal_reference(arch, smoke):
    want, got = jget(arch, smoke=smoke), tget(arch.replace("_", "-"),
                                              smoke=smoke)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.params_total() == want.params_total()
    assert got.layer_types == want.layer_types


@pytest.mark.parametrize("arch", ARCHS + LATER)
def test_init_params_tree_matches_reference(arch):
    _, want = _weights(arch)
    cfg = tget(arch, smoke=True)
    got = dict(_tree_leaves(tmodel.init_params(
        torch.Generator().manual_seed(0), cfg)))
    want = dict(_tree_leaves(want))
    assert set(got) == set(want)
    for path, leaf in got.items():
        assert tuple(leaf.shape) == want[path].shape, path
        assert str(leaf.dtype).split(".")[-1] == want[path].dtype.name, path
    # carrying keeps every leaf's dtype, the float32 recurrent ones too
    carried = dict(_tree_leaves(carry.lm_params_from_numpy(
        _weights(arch)[1], cfg)))
    for path, leaf in carried.items():
        np.testing.assert_array_equal(leaf.numpy(), want[path],
                                      err_msg=str(path))
        assert str(leaf.dtype).split(".")[-1] == want[path].dtype.name, path


@pytest.mark.parametrize("kw", [dict(), dict(quant="radix"),
                                dict(quant="radix", radix_kv_pack=True)],
                         ids=["exact", "radix", "packed"])
@pytest.mark.parametrize("arch", ARCHS + LATER)
def test_init_cache_matches_reference(arch, kw):
    jcfg = dataclasses.replace(jget(arch, smoke=True), **kw)
    tcfg = dataclasses.replace(tget(arch, smoke=True), **kw)
    want = dict(_tree_leaves(jax.tree.map(np.asarray,
                                          jmodel.init_cache(jcfg, B, 20))))
    got = dict(_tree_leaves(tmodel.init_cache(tcfg, B, 20, device="cpu")))
    assert set(got) == set(want)
    for path, leaf in got.items():
        assert leaf.numpy().dtype == want[path].dtype, path
        np.testing.assert_array_equal(leaf.numpy(), want[path],
                                      err_msg=str(path))


@pytest.mark.parametrize("arch,change,error,match", [
    ("kimi_k2_1t_a32b", dict(impl="ep_psum"), NotImplementedError,
     "'ep_psum' over a device mesh is not ported yet"),
    ("kimi_k2_1t_a32b", dict(impl="ep_a2a"), NotImplementedError,
     "'ep_a2a' over a device mesh is not ported yet"),
    ("grok_1_314b", dict(impl="tp"), NotImplementedError,
     "'tp' over a device mesh is not ported yet"),
    ("glm4_9b", dict(block_pattern=("attn", "mamba")), ValueError,
     "unknown block types"),
], ids=["ep_psum", "ep_a2a", "tp", "unknown_block"])
def test_check_supported_still_rejects(arch, change, error, match):
    """What still raises: the MoE mesh dispatches (ROADMAP.md item 7), on
    a config built from the reference's fields, and a block type no arch
    has.  Every reference arch's published config is admitted."""
    fields = dataclasses.asdict(jget(arch, smoke=True))
    if fields["moe"] is not None:
        fields["moe"] = MoEConfig(**dict(fields["moe"], impl=change["impl"]))
    else:
        fields.update(change)
    cfg = ArchConfig(**fields)
    with pytest.raises(error, match=match):
        tmodel.check_supported(cfg)
    for name in configs.LM_ARCHS:
        tmodel.check_supported(tget(name))


# ---------------------------------------------------------------------------
# Local attention and the ring cache.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("s_len", [12, 32])
@pytest.mark.parametrize("window", [3, 8])
def test_windowed_attention(window, s_len):
    jlp, tlp = _layer("recurrentgemma_2b", 2)          # the local_attn slot
    cfg = jget("recurrentgemma_2b", smoke=True)
    x = _rng(0).normal(size=(B, s_len, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s_len), (B, s_len))
    want, (wk, wv) = jblocks.attention(_j(x), jlp["mix"], cfg, _j(pos),
                                       window=window, return_kv=True)
    got, (gk, gv) = tblocks.attention(
        _t(x), tlp["mix"], tget("recurrentgemma_2b", smoke=True), _t(pos),
        window=window, return_kv=True)
    _close(got.numpy(), want, 1e-5)
    _close(gk.numpy(), wk, 1e-5)
    _close(gv.numpy(), wv, 1e-5)


@pytest.mark.parametrize("kw", [dict(), dict(quant="radix"),
                                dict(quant="radix", radix_kv_pack=True)],
                         ids=["exact", "radix", "packed"])
def test_ring_cache_update_wraps(kw):
    window, hkv, hd = 8, 1, 32
    jcfg = dataclasses.replace(jget("recurrentgemma_2b", smoke=True), **kw)
    tcfg = dataclasses.replace(tget("recurrentgemma_2b", smoke=True), **kw)
    jc = jradix.init_cache_entry(jcfg, B, window, jnp.float32)
    tc = tradix.init_cache_entry(tcfg, B, window, torch.float32)
    rng = _rng(1)
    for pos in (3, 7, 8, 13, 21, 24):              # slots 3 7 0 5 5 0
        k, v = (rng.normal(size=(B, 1, hkv, hd)).astype(np.float32)
                for _ in range(2))
        jc = jradix.cache_update(jc, _j(k), _j(v), jnp.int32(pos), jcfg,
                                 window=window)
        out = tradix.cache_update(tc, _t(k), _t(v), pos, tcfg, window=window)
        assert out is tc                           # written in place
        for name in jc:
            np.testing.assert_array_equal(tc[name].numpy(),
                                          np.asarray(jc[name]),
                                          err_msg=f"{name} after {pos}")


@pytest.mark.parametrize("packed_attn", [False, True])
@pytest.mark.parametrize("pos", [5, 8, 19])
def test_windowed_decode_attention(pos, packed_attn):
    """One decode step over a ring cache holding earlier, random levels:
    every slot written (pos >= window) or only some (pos < window)."""
    kw = dict(RADIX, packed_attn=packed_attn)
    jcfg = dataclasses.replace(jget("recurrentgemma_2b", smoke=True), **kw)
    tcfg = dataclasses.replace(tget("recurrentgemma_2b", smoke=True), **kw)
    window = jcfg.window
    jlp, tlp = _layer("recurrentgemma_2b", 2)
    rng = _rng(2)
    kv = rng.normal(size=(B, window, 1, jcfg.hd)).astype(np.float32)
    jc = jradix.encode_cache_bulk(_j(kv), _j(kv[:, ::-1]), jcfg, jnp.float32)
    tc = tradix.encode_cache_bulk(_t(kv), _t(kv[:, ::-1].copy()), tcfg,
                                  torch.float32)
    x = rng.normal(size=(B, 1, jcfg.d_model)).astype(np.float32)
    want, jc = jblocks.decode_attention(_j(x), jlp["mix"], jcfg, jc,
                                        jnp.int32(pos), window=window)
    got, tc = tblocks.decode_attention(_t(x), tlp["mix"], tcfg, tc, pos,
                                       window=window)
    _close(got.numpy(), want, 1e-5)
    for name in jc:
        np.testing.assert_array_equal(tc[name].numpy(), np.asarray(jc[name]))


# ---------------------------------------------------------------------------
# RG-LRU.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("s_len", [1, 2, 9])
@pytest.mark.parametrize("streaming", [False, True])
def test_conv1d_causal(streaming, s_len):
    rng = _rng(3)
    x = rng.normal(size=(B, s_len, 16)).astype(np.float32)
    w = rng.normal(size=(4, 16)).astype(np.float32)
    if not streaming:
        _close(tblocks.conv1d_causal(_t(x), _t(w)).numpy(),
               jblocks.conv1d_causal(_j(x), _j(w)), 1e-5)
        return
    st = rng.normal(size=(B, 3, 16)).astype(np.float32)
    wy, ws = jblocks.conv1d_causal(_j(x), _j(w), _j(st))
    gy, gs = tblocks.conv1d_causal(_t(x), _t(w), _t(st))
    _close(gy.numpy(), wy, 1e-5)
    np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))


@pytest.mark.parametrize("s_len", [1, 7, 16, 33])
@pytest.mark.parametrize("with_h0", [False, True])
def test_rglru_scan(with_h0, s_len):
    rng = _rng(4)
    a = rng.uniform(0.5, 1.0, size=(B, s_len, 24)).astype(np.float32)
    bx = rng.normal(size=(B, s_len, 24)).astype(np.float32)
    h0 = rng.normal(size=(B, 24)).astype(np.float32) if with_h0 else None
    want = jblocks._rglru_scan(_j(a), _j(bx),
                               None if h0 is None else _j(h0))
    got = tblocks._rglru_scan(_t(a), _t(bx), None if h0 is None else _t(h0))
    _close(got.numpy(), want, 1e-5)
    # the recurrence itself, step by step
    h = np.zeros((B, 24)) if h0 is None else h0.astype(np.float64)
    for t in range(s_len):
        h = a[:, t] * h + bx[:, t]
    _close(got[:, -1].numpy(), h, 1e-5)


@pytest.mark.parametrize("s_len", [2, 13])
def test_rglru_block_prefill_and_decode(s_len):
    jlp, tlp = _layer("recurrentgemma_2b", 0)
    jcfg = jget("recurrentgemma_2b", smoke=True)
    tcfg = tget("recurrentgemma_2b", smoke=True)
    rng = _rng(5)
    x = rng.normal(size=(B, s_len, jcfg.d_model)).astype(np.float32)
    want, wst = jblocks.rglru_block(_j(x), jlp["mix"], jcfg,
                                    return_state=True)
    got, gst = tblocks.rglru_block(_t(x), tlp["mix"], tcfg,
                                   return_state=True)
    _close(got.numpy(), want, 1e-5)
    _tree_close(gst, jax.tree.map(np.asarray, wst), 1e-5)
    _close(tblocks.rglru_block(_t(x), tlp["mix"], tcfg).numpy(), want, 1e-5)
    x1 = rng.normal(size=(B, 1, jcfg.d_model)).astype(np.float32)
    want, wst = jblocks.rglru_block(_j(x1), jlp["mix"], jcfg, state=wst)
    got, gst = tblocks.rglru_block(_t(x1), tlp["mix"], tcfg, state=gst)
    _close(got.numpy(), want, 1e-5)
    _tree_close(gst, jax.tree.map(np.asarray, wst), 1e-5)


# ---------------------------------------------------------------------------
# RWKV-6.
# ---------------------------------------------------------------------------


def _rwkv_inputs(seed, s_len, h=2, hd=8):
    rng = _rng(seed)
    r, k, v = (rng.normal(size=(B, h, s_len, hd)).astype(np.float32)
               for _ in range(3))
    w = rng.uniform(0.05, 0.999, size=(B, h, s_len, hd)).astype(np.float32)
    u = rng.normal(size=(1, h, 1, hd)).astype(np.float32)
    return r, k, v, w, u


@pytest.mark.parametrize("s_len,chunk", [(16, 8), (13, 13)],
                         ids=["two_chunks", "irregular"])
def test_rwkv_chunk_scan(s_len, chunk):
    r, k, v, w, u = _rwkv_inputs(6, s_len)
    wo, ws = jblocks._rwkv_chunk_scan(*map(_j, (r, k, v, w, u)), chunk=chunk)
    go, gs = tblocks._rwkv_chunk_scan(*map(_t, (r, k, v, w, u)), chunk)
    _close(go.numpy(), wo, 1e-5)
    _close(gs.numpy(), ws, 1e-5)
    # the same recurrence as S decode steps
    st = torch.zeros((B, 2, 8, 8))
    for t in range(s_len):
        o, st = tblocks._rwkv_step(*(_t(a[:, :, t]) for a in (r, k, v, w)),
                                   _t(u[:, :, 0]), st)
        _close(o.numpy(), go[:, :, t].numpy(), 1e-5)
    _close(st.numpy(), gs.numpy(), 1e-5)


def test_rwkv_step():
    r, k, v, w, u = (a[:, :, 0] for a in _rwkv_inputs(7, 1))
    s0 = _rng(8).normal(size=(B, 2, 8, 8)).astype(np.float32)
    wo, ws = jblocks._rwkv_step(*map(_j, (r, k, v, w, u, s0)))
    go, gs = tblocks._rwkv_step(*map(_t, (r, k, v, w, u, s0)))
    _close(go.numpy(), wo, 1e-5)
    _close(gs.numpy(), ws, 1e-5)


@pytest.mark.parametrize("s_len,chunk", [(16, 8), (13, 64)],
                         ids=["two_chunks", "irregular"])
def test_rwkv6_block_prefill_and_decode(s_len, chunk):
    jlp, tlp = _layer("rwkv6_3b", 0)
    jcfg = dataclasses.replace(jget("rwkv6_3b", smoke=True), rwkv_chunk=chunk)
    tcfg = dataclasses.replace(tget("rwkv6_3b", smoke=True), rwkv_chunk=chunk)
    rng = _rng(9)
    x = rng.normal(size=(B, s_len, jcfg.d_model)).astype(np.float32)
    want, wst = jblocks.rwkv6_block(_j(x), jlp["mix"], jcfg,
                                    return_state=True)
    got, gst = tblocks.rwkv6_block(_t(x), tlp["mix"], tcfg,
                                   return_state=True)
    _close(got.numpy(), want, 1e-5)
    _tree_close(gst, jax.tree.map(np.asarray, wst), 1e-5)
    x1 = rng.normal(size=(B, 1, jcfg.d_model)).astype(np.float32)
    want, wst = jblocks.rwkv6_block(_j(x1), jlp["mix"], jcfg, state=wst)
    got, gst = tblocks.rwkv6_block(_t(x1), tlp["mix"], tcfg, state=gst)
    _close(got.numpy(), want, 1e-5)
    _tree_close(gst, jax.tree.map(np.asarray, wst), 1e-5)


def test_rwkv6_channel_mix():
    jlp, tlp = _layer("rwkv6_3b", 0)
    d = jget("rwkv6_3b", smoke=True).d_model
    rng = _rng(10)
    x = rng.normal(size=(B, 7, d)).astype(np.float32)
    want, wst = jblocks.rwkv6_channel_mix(_j(x), jlp["ffn"],
                                          return_state=True)
    got, gst = tblocks.rwkv6_channel_mix(_t(x), tlp["ffn"],
                                         return_state=True)
    _close(got.numpy(), want, 1e-5)
    np.testing.assert_array_equal(gst["last_x"].numpy(),
                                  np.asarray(wst["last_x"]))
    x1 = rng.normal(size=(B, 1, d)).astype(np.float32)
    want, _ = jblocks.rwkv6_channel_mix(_j(x1), jlp["ffn"], state=wst)
    got, _ = tblocks.rwkv6_channel_mix(_t(x1), tlp["ffn"], state=gst)
    _close(got.numpy(), want, 1e-5)


@pytest.mark.parametrize("act", ["relu_sq", "gelu_mlp"])
def test_ungated_ffn(act):
    jcfg = dataclasses.replace(jget("rwkv6_3b", smoke=True), act=act)
    tcfg = dataclasses.replace(tget("rwkv6_3b", smoke=True), act=act)
    rng = _rng(11)
    p = {"w_up": rng.normal(size=(64, 128)).astype(np.float32) * 0.1,
         "w_down": rng.normal(size=(128, 64)).astype(np.float32) * 0.1}
    x = rng.normal(size=(B, 5, 64)).astype(np.float32)
    want = jblocks.ffn(_j(x), jax.tree.map(_j, p), jcfg)
    got = tblocks.ffn(_t(x), {k: _t(v) for k, v in p.items()}, tcfg)
    _close(got.numpy(), want, 1e-5)


# ---------------------------------------------------------------------------
# Whole models.
# ---------------------------------------------------------------------------


def _serve_pair(arch, jcfg, tcfg, tokens, s0, decode_tokens, max_len):
    """Prefill ``tokens[:, :s0]`` and decode ``decode_tokens`` (a callable
    of the step and both sides' logits -> the (B, 1) tokens to feed) on
    both sides; yields (step, port logits, reference logits)."""
    jparams, nparams = _weights(arch)
    tparams = carry.lm_params_from_numpy(nparams, tcfg)
    jparams = jmodel.radixify_params(jparams, jcfg)
    tparams = tmodel.kmajor_params(tmodel.radixify_params(tparams, tcfg))
    jl, jc = jmodel.prefill(jparams, {"tokens": _j(tokens[:, :s0 + 1])},
                            jcfg, None, max_len=max_len)
    tl, tc = tmodel.prefill(tparams, {"tokens": _t(tokens[:, :s0 + 1])},
                            tcfg, max_len=max_len)
    yield 0, tl, jl
    for i, pos in enumerate(range(s0, max_len)):
        tok = decode_tokens(pos, tl, jl)
        if tok is None:
            return
        jl, jc = jmodel.decode_step(jparams, jc, _j(tok).astype(jnp.int32),
                                    jnp.int32(pos), jcfg, None)
        tl, tc = tmodel.decode_step(tparams, tc, _t(tok).long(), pos, tcfg)
        yield i + 1, tl, jl


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_matches_reference(arch):
    jcfg, tcfg = jget(arch, smoke=True), tget(arch, smoke=True)
    tokens = _rng(12).integers(0, jcfg.vocab, size=(B, 17))
    s0 = 12

    def feed(pos, tl, jl):
        return tokens[:, pos:pos + 1] if pos < s0 + 4 else None

    steps = 0
    for step, tl, jl in _serve_pair(arch, jcfg, tcfg, tokens, s0, feed, 20):
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=2e-4,
                                   atol=2e-4, err_msg=f"step {step}")
        steps += 1
    assert steps == 5


def test_recurrentgemma_ring_buffer_wraps():
    """Mirror of the reference's test: decode past the local-attention
    window (ring slot reuse) stays consistent with the reference's
    teacher-forced forward."""
    jcfg = jget("recurrentgemma_2b", smoke=True)        # window = 8
    tcfg = tget("recurrentgemma_2b", smoke=True)
    seq, s0 = 24, 13                                    # s0 % window != 0
    tokens = np.asarray(jax.random.randint(jax.random.PRNGKey(1),
                                           (B, seq + 1), 0, jcfg.vocab))
    logits_tf, _, _ = jmodel.forward_train(
        _weights("recurrentgemma_2b")[0], {"tokens": _j(tokens)}, jcfg, None)
    logits_tf = np.asarray(logits_tf)

    def feed(pos, tl, jl):
        return tokens[:, pos:pos + 1] if pos < seq else None

    for step, tl, _ in _serve_pair("recurrentgemma_2b", jcfg, tcfg, tokens,
                                   s0, feed, seq + 4):
        np.testing.assert_allclose(tl.numpy(), logits_tf[:, s0 - 1 + step],
                                   rtol=2e-4, atol=2e-4,
                                   err_msg=f"step {step}")
    assert step == seq - s0


@pytest.mark.parametrize("arch", ARCHS)
def test_radix_serving_matches_reference_kernels(arch):
    """T = 4 radix weights and activations, packed KV and packed decode
    attention, fused dataflow: the port's kernel path on the CPU against
    the reference's Pallas kernels in interpret mode, greedy."""
    kw = dict(RADIX, use_kernel=True, kernel_dataflow="fused")
    jcfg = dataclasses.replace(jget(arch, smoke=True), **kw)
    tcfg = dataclasses.replace(tget(arch, smoke=True), **kw)
    tokens = _rng(13).integers(0, jcfg.vocab, size=(B, 12))
    s0 = 11

    def feed(pos, tl, jl):
        return np.asarray(jl).argmax(-1)[:, None] if pos < s0 + 4 else None

    for step, tl, jl in _serve_pair(arch, jcfg, tcfg, tokens, s0, feed, 16):
        err = _close(tl.numpy(), jl, 1e-3)
        np.testing.assert_array_equal(
            tl.numpy().argmax(-1), np.asarray(jl).argmax(-1),
            err_msg=f"step {step}: greedy tokens (rel L2 {err:.3g})")
    assert step == 4
