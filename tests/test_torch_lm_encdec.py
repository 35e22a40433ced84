"""The port's Whisper-medium (encoder-decoder, learned positions) and
Qwen2-VL-72B (M-RoPE, embedding inputs) against the JAX package, on the
reference's SMOKE configs and its own weights (``init_params(
PRNGKey(0))``, carried across with ``carry.lm_params_from_numpy``).

* blocks in float32 to 1e-5 relative L2: ``rope_apply`` with M-RoPE
  sections on distinct streams, and the mirror of
  ``test_mrope_equals_rope_on_text``; non-causal and cross
  ``attention``; M-RoPE ``attention`` (query positions ``positions[0,
  0]``); cross ``decode_attention`` over the float cross cache;
  ``_encode_whisper``;
* prefill plus decode against the reference's own, and Whisper's against
  its teacher-forced ``forward_train`` logits, at the reference's bar
  (rtol = atol = 2e-4); Qwen2-VL prefill and decode on embeds; the
  mirror of ``test_qwen_vl_decode_runs``;
* with ``quant="radix"`` (T = 4, packed KV and packed decode attention)
  the port's kernel path (the plain versions on the CPU) against the
  reference's Pallas kernels in interpret mode: 1e-3 relative L2 and the
  same greedy tokens.  The reference's Whisper decode raises there (its
  ``cache_read`` reads the float cross cache as radix levels: a
  ``KeyError`` on the scales, or a ``TypeError`` unpacking floats); the
  port's cross decode reads that cache as float, and the test gives the
  reference's ``cache_read`` a pass-through for it.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.lm import blocks as jblocks
from repro.lm import model as jmodel
from repro.lm import radix as jradix
from repro_torch import carry
from repro_torch.configs import get_config as tget
from repro_torch.lm import blocks as tblocks
from repro_torch.lm import model as tmodel

B = 2
RADIX = dict(quant="radix", radix_steps=4, radix_kv_pack=True,
             packed_attn=True)
ENCDEC = ["whisper_medium", "qwen2_vl_72b"]


def _t(a):
    return torch.from_numpy(np.array(a))


def _j(a):
    return jnp.asarray(np.asarray(a))


def _rng(seed):
    return np.random.default_rng(seed)


def _close(got, want, rtol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)
    assert err <= rtol, f"relative L2 error {err:.3g} > {rtol}"
    return err


_WEIGHTS = {}


def _weights(arch):
    """The reference's SMOKE params (JAX tree, numpy tree), made once."""
    if arch not in _WEIGHTS:
        p = jmodel.init_params(jax.random.PRNGKey(0), jget(arch, smoke=True))
        _WEIGHTS[arch] = (p, jax.tree.map(np.asarray, p))
    return _WEIGHTS[arch]


def _layer(arch, key="segments", field=None):
    """Layer 0 of slot 0 of segment 0 of ``params[key]``, both sides."""
    _, npar = _weights(arch)
    lp = jax.tree.map(lambda a: a[0], npar[key][0][0])
    if field is not None:
        lp = lp[field]
    return (jax.tree.map(jnp.asarray, lp),
            carry.lm_params_from_numpy(lp, tget(arch, smoke=True)))


def _cfgs(arch, **kw):
    return (dataclasses.replace(jget(arch, smoke=True), **kw),
            dataclasses.replace(tget(arch, smoke=True), **kw))


# ---------------------------------------------------------------------------
# M-RoPE.
# ---------------------------------------------------------------------------


def test_mrope_matches_reference():
    """Three distinct position streams (a patch grid's t, h, w)."""
    rng = _rng(0)
    x = rng.normal(size=(B, 8, 4, 32)).astype(np.float32)
    pos3 = rng.integers(0, 50, size=(3, B, 8))
    want = jblocks.rope_apply(_j(x), _j(pos3), 1e6, (4, 6, 6))
    got = tblocks.rope_apply(_t(x), _t(pos3), 1e6, (4, 6, 6))
    _close(got.numpy(), want, 1e-5)
    with pytest.raises(ValueError, match="M-RoPE wants"):
        tblocks.rope_apply(_t(x), _t(pos3[0]), 1e6, (4, 6, 6))


def test_mrope_equals_rope_on_text():
    """Mirror of the reference's test: identical streams == plain RoPE."""
    x = torch.from_numpy(_rng(1).normal(size=(2, 8, 4, 32)).astype(
        np.float32))
    pos = torch.arange(8).expand(2, 8)
    a = tblocks.rope_apply(x, pos, 10_000.0)
    b = tblocks.rope_apply(x, pos.expand(3, 2, 8), 10_000.0, (4, 6, 6))
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6)


def test_mrope_attention_matches_reference():
    jlp, tlp = _layer("qwen2_vl_72b", field="mix")
    jcfg, tcfg = _cfgs("qwen2_vl_72b")
    rng = _rng(2)
    x = rng.normal(size=(B, 32, jcfg.d_model)).astype(np.float32)
    pos3 = np.broadcast_to(np.arange(32), (3, B, 32))
    want, (wk, _) = jblocks.attention(_j(x), jlp, jcfg, _j(pos3),
                                      return_kv=True)
    got, (gk, _) = tblocks.attention(_t(x), tlp, tcfg, _t(pos3.copy()),
                                     return_kv=True)
    _close(got.numpy(), want, 1e-5)
    _close(gk.numpy(), wk, 1e-5)


# ---------------------------------------------------------------------------
# Non-causal and cross attention.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("s_len", [12, 32])
def test_noncausal_attention_matches_reference(s_len):
    jlp, tlp = _layer("whisper_medium", "enc_segments", "mix")
    jcfg, tcfg = _cfgs("whisper_medium")
    x = _rng(3).normal(size=(B, s_len, jcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s_len), (B, s_len))
    want = jblocks.attention(_j(x), jlp, jcfg, _j(pos), causal=False)
    got = tblocks.attention(_t(x), tlp, tcfg, _t(pos.copy()), causal=False)
    _close(got.numpy(), want, 1e-5)
    causal = tblocks.attention(_t(x), tlp, tcfg, _t(pos.copy()))
    assert not np.allclose(causal.numpy(), got.numpy())


@pytest.mark.parametrize("s_len", [5, 32])
def test_cross_attention_matches_reference(s_len):
    jlp, tlp = _layer("whisper_medium", field="xattn")
    jcfg, tcfg = _cfgs("whisper_medium")
    rng = _rng(4)
    x = rng.normal(size=(B, s_len, jcfg.d_model)).astype(np.float32)
    kv = rng.normal(size=(2, B, jcfg.encoder_ctx, jcfg.n_kv_heads,
                          jcfg.hd)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s_len), (B, s_len))
    want = jblocks.attention(_j(x), jlp, jcfg, _j(pos),
                             cross_kv=(_j(kv[0]), _j(kv[1])))
    got = tblocks.attention(_t(x), tlp, tcfg, _t(pos.copy()),
                            cross_kv=(_t(kv[0]), _t(kv[1])))
    _close(got.numpy(), want, 1e-5)


def test_cross_decode_attention_matches_reference():
    jlp, tlp = _layer("whisper_medium", field="xattn")
    jcfg, tcfg = _cfgs("whisper_medium")
    rng = _rng(5)
    x = rng.normal(size=(B, 1, jcfg.d_model)).astype(np.float32)
    kv = rng.normal(size=(2, B, jcfg.encoder_ctx, jcfg.n_kv_heads,
                          jcfg.hd)).astype(np.float32)
    jc = {"k": _j(kv[0]), "v": _j(kv[1])}
    tc = {"k": _t(kv[0]), "v": _t(kv[1])}
    want, _ = jblocks.decode_attention(_j(x), jlp, jcfg, jc, jnp.int32(3),
                                       cross=True)
    got, out = tblocks.decode_attention(_t(x), tlp, tcfg, tc, 3, cross=True)
    _close(got.numpy(), want, 1e-5)
    assert out is tc
    np.testing.assert_array_equal(tc["k"].numpy(), kv[0])   # not written


def test_encode_whisper_matches_reference():
    jparams, nparams = _weights("whisper_medium")
    jcfg, tcfg = _cfgs("whisper_medium")
    enc = _rng(6).normal(size=(B, jcfg.encoder_ctx,
                               jcfg.d_model)).astype(np.float32)
    want = jmodel._encode_whisper(jparams, _j(enc), jcfg, None)
    got = tmodel._encode_whisper(carry.lm_params_from_numpy(nparams, tcfg),
                                 _t(enc), tcfg)
    _close(got.numpy(), want, 1e-5)


# ---------------------------------------------------------------------------
# Whole models.
# ---------------------------------------------------------------------------


def _inputs(cfg, seed, s_len):
    """Seeded numpy inputs: (prefill batch of S positions, a callable of
    the step giving the (B, 1) tokens or (B, 1, d) embeds to feed)."""
    rng = _rng(seed)
    if cfg.embedding_inputs:
        emb = rng.normal(size=(B, s_len + 8, cfg.d_model)).astype(np.float32)
        labels = rng.integers(0, cfg.vocab, size=(B, s_len))
        return ({"embeds": emb[:, :s_len], "labels": labels},
                lambda pos: emb[:, pos:pos + 1])
    tokens = rng.integers(0, cfg.vocab, size=(B, s_len + 9))
    batch = {"tokens": tokens[:, :s_len + 1]}
    if cfg.encoder_layers:
        batch["enc_embeds"] = rng.normal(
            size=(B, cfg.encoder_ctx, cfg.d_model)).astype(np.float32)
    return batch, lambda pos: tokens[:, pos:pos + 1]


def _serve_pair(arch, jcfg, tcfg, batch, feed, s0, steps, max_len):
    """Prefill ``batch`` and decode ``steps`` steps of ``feed(pos, port
    logits, reference logits)`` on both sides; yields (step, port logits,
    reference logits)."""
    jparams, nparams = _weights(arch)
    tparams = carry.lm_params_from_numpy(nparams, tcfg)
    jparams = jmodel.radixify_params(jparams, jcfg)
    tparams = tmodel.kmajor_params(tmodel.radixify_params(tparams, tcfg))
    jl, jc = jmodel.prefill(jparams, {k: _j(v) for k, v in batch.items()},
                            jcfg, None, max_len=max_len)
    tl, tc = tmodel.prefill(tparams, {k: _t(v) for k, v in batch.items()},
                            tcfg, max_len=max_len)
    yield 0, tl, jl
    for i in range(steps):
        pos = s0 + i
        x = feed(pos, tl, jl)
        jx, tx = _j(x), _t(x)
        if not tcfg.embedding_inputs:
            jx, tx = jx.astype(jnp.int32), tx.long()
        jl, jc = jmodel.decode_step(jparams, jc, jx, jnp.int32(pos), jcfg,
                                    None)
        tl, tc = tmodel.decode_step(tparams, tc, tx, pos, tcfg)
        yield i + 1, tl, jl


@pytest.mark.parametrize("arch", ENCDEC)
def test_prefill_decode_matches_reference(arch):
    jcfg, tcfg = _cfgs(arch)
    s0 = 10
    batch, nxt = _inputs(jcfg, 7, s0)
    steps = 0
    for step, tl, jl in _serve_pair(arch, jcfg, tcfg, batch,
                                    lambda pos, *_: nxt(pos), s0, 5, 20):
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=2e-4,
                                   atol=2e-4, err_msg=f"step {step}")
        steps += 1
    assert steps == 6


def test_whisper_matches_teacher_forcing():
    """Whisper's prefill and decode against the reference's teacher-forced
    ``forward_train`` logits (the serving path computes the training
    function)."""
    jcfg, tcfg = _cfgs("whisper_medium")
    seq, s0 = 16, 8
    batch, _ = _inputs(jcfg, 8, seq)
    tokens = batch["tokens"]
    logits_tf, _, _ = jmodel.forward_train(
        _weights("whisper_medium")[0], {k: _j(v) for k, v in batch.items()},
        jcfg, None)
    pre = dict(batch, tokens=tokens[:, :s0 + 1])
    for step, tl, _ in _serve_pair(
            "whisper_medium", jcfg, tcfg, pre,
            lambda pos, *_: tokens[:, pos:pos + 1], s0, seq - s0, seq + 4):
        np.testing.assert_allclose(
            tl.numpy(), np.asarray(logits_tf[:, s0 - 1 + step]), rtol=2e-4,
            atol=2e-4, err_msg=f"step {step}")
    assert step == seq - s0


def test_qwen_vl_decode_runs():
    """Mirror of the reference's test: decode consumes embedding
    vectors."""
    cfg = tget("qwen2_vl_72b", smoke=True)
    gen = torch.Generator().manual_seed(0)
    params = tmodel.init_params(gen, cfg)
    emb = torch.randn((B, 16, cfg.d_model), generator=gen)
    labels = torch.randint(0, cfg.vocab, (B, 16), generator=gen)
    last, caches = tmodel.prefill(params, {"embeds": emb, "labels": labels},
                                  cfg, max_len=20)
    e = torch.randn((B, 1, cfg.d_model), generator=gen)
    lg, caches = tmodel.decode_step(params, caches, e, 16, cfg)
    assert tuple(lg.shape) == (B, cfg.vocab)
    assert bool(torch.isfinite(lg).all())


@pytest.mark.parametrize("pack,error", [(False, KeyError),
                                        (True, TypeError)])
def test_reference_whisper_radix_decode_raises(pack, error):
    """The mismatch the port repairs: under ``radix_kv`` the reference's
    cross decode reads the float cross cache as radix levels: it looks
    for their scales (``KeyError``), or first unpacks the floats as
    nibbles (``TypeError``)."""
    jcfg, _ = _cfgs("whisper_medium", **dict(RADIX, radix_kv_pack=pack))
    batch, nxt = _inputs(jcfg, 9, 6)
    jparams = jmodel.radixify_params(_weights("whisper_medium")[0], jcfg)
    _, jc = jmodel.prefill(jparams, {k: _j(v) for k, v in batch.items()},
                           jcfg, None, max_len=8)
    with pytest.raises(error):
        jmodel.decode_step(jparams, jc, _j(nxt(6)).astype(jnp.int32),
                           jnp.int32(6), jcfg, None)


@pytest.mark.parametrize("arch", ENCDEC)
def test_radix_serving_matches_reference_kernels(arch, monkeypatch):
    """T = 4 radix weights and activations (Whisper's encoder and decoder
    FFNs, Qwen2-VL's FFN and unembed), packed KV and packed decode
    attention, fused dataflow: the port's kernel path on the CPU against
    the reference's Pallas kernels in interpret mode, greedy."""
    read = jradix.cache_read

    def cache_read(cache, cfg, dtype=None):
        if "k_scale" not in cache:          # the float cross cache
            return cache["k"], cache["v"]
        return read(cache, cfg, dtype)

    monkeypatch.setattr(jradix, "cache_read", cache_read)
    jcfg, tcfg = _cfgs(arch, use_kernel=True, kernel_dataflow="fused",
                       **RADIX)
    s0 = 11
    batch, nxt = _inputs(jcfg, 10, s0)

    def feed(pos, tl, jl):
        if tcfg.embedding_inputs:
            return nxt(pos)
        return np.asarray(jl).argmax(-1)[:, None]

    for step, tl, jl in _serve_pair(arch, jcfg, tcfg, batch, feed, s0, 4,
                                    16):
        err = _close(tl.numpy(), jl, 1e-3)
        np.testing.assert_array_equal(
            tl.numpy().argmax(-1), np.asarray(jl).argmax(-1),
            err_msg=f"step {step}: greedy tokens (rel L2 {err:.3g})")
    assert step == 4
