"""The port's LM modules (``repro_torch.lm``, ``repro_torch.configs``)
against the JAX package, stage by stage, on the same numpy inputs.

* configs: ``gemma_2b.ARCH`` / ``SMOKE`` equal the reference's field for
  field; ``init_params`` builds the reference's tree, shapes and dtypes;
  ``init_cache`` the reference's zero caches;
* integer stages, exact: ``quantize_weight`` (scale to 1 ulp),
  ``_radix_activation``, ``_encode_kv`` / ``_pack4`` / ``encode_cache_bulk``
  / ``cache_update``, ``radixify_params`` of carried-over weights;
* ``maybe_radix_matmul`` with ``use_kernel`` on and off, both dataflows,
  to 1e-6 relative;
* float blocks to 1e-5 relative: ``norm`` (three kinds), ``rope_apply``,
  ``attention`` (chunked and unchunked, and with radix QKV/out
  projections), ``ffn`` (GeGLU; ``jax.nn.gelu`` is the tanh
  approximation).
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
from repro_torch.configs import gemma_2b as tgemma
from repro_torch.configs import get_config as tget
from repro_torch.lm import blocks as tblocks
from repro_torch.lm import model as tmodel
from repro_torch.lm import radix as tradix

JCFG = jget("gemma_2b", smoke=True)
TCFG = tget("gemma_2b", smoke=True)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, rtol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)
    assert err <= rtol, f"relative L2 error {err:.3g} > {rtol}"


def _tree_leaves(t, path=()):
    if isinstance(t, dict):
        for k in sorted(t):
            yield from _tree_leaves(t[k], path + (k,))
    elif isinstance(t, (tuple, list)):
        for i, v in enumerate(t):
            yield from _tree_leaves(v, path + (i,))
    else:
        yield path, t


@pytest.fixture(scope="module")
def ref_params():
    return jax.tree.map(np.asarray,
                        jmodel.init_params(jax.random.PRNGKey(0), JCFG))


# ---------------------------------------------------------------------------
# Configs and parameter trees.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("smoke", [False, True])
def test_configs_equal_reference(smoke):
    want = dataclasses.asdict(jget("gemma_2b", smoke=smoke))
    assert dataclasses.asdict(tget("gemma-2b", smoke=smoke)) == want
    assert tget("gemma_2b", smoke=smoke) is (tgemma.SMOKE if smoke
                                             else tgemma.ARCH)
    assert TCFG.params_total() == JCFG.params_total()
    with pytest.raises(ValueError, match="unknown LM arch"):
        tget("whisper_large")


def test_init_params_tree_matches_reference(ref_params):
    got = tmodel.init_params(torch.Generator().manual_seed(0), TCFG)
    want = dict(_tree_leaves(ref_params))
    have = dict(_tree_leaves(got))
    assert set(have) == set(want)
    for path, leaf in have.items():
        assert tuple(leaf.shape) == want[path].shape, path
        assert str(leaf.dtype).split(".")[-1] == want[path].dtype.name, path
    # the scales follow the reference's init: d^-0.5 for the in-projections
    w = have[("segments", 0, 0, "ffn", "w_gate")]
    assert abs(float(w.std()) - TCFG.d_model ** -0.5) < 0.01


@pytest.mark.parametrize("pack", [False, True])
def test_init_cache_matches_reference(pack):
    kw = dict(quant="radix", radix_kv_pack=pack)
    want = dict(_tree_leaves(jax.tree.map(np.asarray, jmodel.init_cache(
        dataclasses.replace(JCFG, **kw), 2, 24))))
    got = dict(_tree_leaves(tmodel.init_cache(
        dataclasses.replace(TCFG, **kw), 2, 24, device="cpu")))
    assert set(got) == set(want)
    for path, leaf in got.items():
        np.testing.assert_array_equal(leaf.numpy(), want[path],
                                      err_msg=str(path))


def test_radixify_carried_params_equal(ref_params):
    jcfg = dataclasses.replace(JCFG, quant="radix", radix_attn=True)
    tcfg = dataclasses.replace(TCFG, quant="radix", radix_attn=True)
    want = dict(_tree_leaves(jax.tree.map(np.asarray, jmodel.radixify_params(
        jax.tree.map(jnp.asarray, ref_params), jcfg))))
    got = dict(_tree_leaves(tmodel.radixify_params(
        carry.lm_params_from_numpy(ref_params, tcfg), tcfg)))
    assert set(got) == set(want)
    for path, leaf in got.items():
        if path[-1] == "scale":
            np.testing.assert_array_max_ulp(leaf.numpy(), want[path], 1)
        else:
            np.testing.assert_array_equal(leaf.numpy(), want[path],
                                          err_msg=str(path))


# ---------------------------------------------------------------------------
# Integer stages: exact.
# ---------------------------------------------------------------------------


def test_quantize_weight_equal():
    w = np.random.default_rng(0).normal(size=(3, 24, 40)).astype(np.float32)
    w[0, :, 0] = 0.0                      # an all-zero channel: the 1e-12 floor
    want = jradix.quantize_weight(jnp.asarray(w))
    got = tradix.quantize_weight(_t(w))
    np.testing.assert_array_equal(got["q"].numpy(), np.asarray(want["q"]))
    np.testing.assert_array_max_ulp(got["scale"].numpy(),
                                    np.asarray(want["scale"]), 1)


@pytest.mark.parametrize("t", [3, 4, 6])
def test_radix_activation_equal(t):
    x = np.random.default_rng(t).normal(size=(2, 5, 48)).astype(np.float32)
    x[0, 0] = np.linspace(-1, 1, 48, dtype=np.float32)
    qj, sj = jradix._radix_activation(jnp.asarray(x), t)
    qt, st = tradix._radix_activation(_t(x), t)
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))


@pytest.mark.parametrize("pack", [False, True])
def test_kv_cache_encoding_equal(pack):
    rng = np.random.default_rng(5)
    jcfg = dataclasses.replace(JCFG, quant="radix", radix_kv_pack=pack)
    tcfg = dataclasses.replace(TCFG, quant="radix", radix_kv_pack=pack)
    k = rng.normal(size=(2, 6, 1, 32)).astype(np.float32)
    v = rng.normal(size=(2, 6, 1, 32)).astype(np.float32)
    qj, sj = jradix._encode_kv(jnp.asarray(k), 4)
    qt, st = tradix._encode_kv(_t(k), 4)
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    np.testing.assert_array_equal(tradix._pack4(qt).numpy(),
                                  np.asarray(jradix._pack4(qj)))
    np.testing.assert_array_equal(tradix._unpack4(tradix._pack4(qt)).numpy(),
                                  qt.numpy())
    bulk_j = jradix.encode_cache_bulk(jnp.asarray(k), jnp.asarray(v), jcfg,
                                      jnp.float32)
    bulk_t = tradix.encode_cache_bulk(_t(k), _t(v), tcfg, torch.float32)
    for name in bulk_j:
        np.testing.assert_array_equal(bulk_t[name].numpy(),
                                      np.asarray(bulk_j[name]))
    # one decode write at slot 4, then read back dequantized
    kn = rng.normal(size=(2, 1, 1, 32)).astype(np.float32)
    vn = rng.normal(size=(2, 1, 1, 32)).astype(np.float32)
    upd_j = jradix.cache_update(bulk_j, jnp.asarray(kn), jnp.asarray(vn),
                                jnp.int32(4), jcfg)
    upd_t = tradix.cache_update(bulk_t, _t(kn), _t(vn), 4, tcfg)
    for name in upd_j:
        np.testing.assert_array_equal(upd_t[name].numpy(),
                                      np.asarray(upd_j[name]))
    for a, b in zip(tradix.cache_read(upd_t, tcfg),
                    jradix.cache_read(upd_j, jcfg)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("dataflow", ["fused", "bitserial"])
def test_maybe_radix_matmul_matches(use_kernel, dataflow):
    rng = np.random.default_rng(11)
    x = rng.normal(size=(2, 7, 64)).astype(np.float32)
    w = rng.normal(size=(64, 96)).astype(np.float32) * 0.1
    kw = dict(quant="radix", use_kernel=use_kernel, kernel_dataflow=dataflow)
    jcfg = dataclasses.replace(JCFG, **kw)
    tcfg = dataclasses.replace(TCFG, **kw)
    want = jradix.maybe_radix_matmul(
        jnp.asarray(x), jradix.quantize_weight(jnp.asarray(w)), cfg=jcfg)
    got = tradix.maybe_radix_matmul(_t(x), tradix.quantize_weight(_t(w)),
                                    cfg=tcfg)
    _close(got.numpy(), want, 1e-6)
    # the kernel and the plain integer product give one accumulator
    other = tradix.maybe_radix_matmul(_t(x), tradix.quantize_weight(_t(w)),
                                      cfg=tcfg, use_kernel=not use_kernel)
    assert torch.equal(got, other)


# ---------------------------------------------------------------------------
# Float blocks: 1e-5 relative.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["rmsnorm", "gemma_rmsnorm", "layernorm"])
def test_norm_matches(kind):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 5, 64)).astype(np.float32) * 3
    p = {"w": rng.normal(size=(64,)).astype(np.float32),
         "b": rng.normal(size=(64,)).astype(np.float32)}
    want = jblocks.norm(jnp.asarray(x), jax.tree.map(jnp.asarray, p), kind)
    got = tblocks.norm(_t(x), {k: _t(v) for k, v in p.items()}, kind)
    _close(got.numpy(), want, 1e-5)


def test_rope_matches():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 9, 2, 32)).astype(np.float32)
    pos = np.broadcast_to(np.arange(9) + 100, (2, 9)).astype(np.int32)
    want = jblocks.rope_apply(jnp.asarray(x), jnp.asarray(pos), 10_000.0)
    got = tblocks.rope_apply(_t(x), _t(pos), 10_000.0)
    _close(got.numpy(), want, 1e-5)


@pytest.mark.parametrize("chunk,radix_attn", [(4, False), (16, False),
                                              (16, True)])
def test_attention_matches(ref_params, chunk, radix_attn):
    """Chunked and unchunked; with ``radix_attn`` the QKV/out projections
    run as radix matmuls over the flattened views (``_attn_proj``)."""
    kw = dict(attn_chunk=chunk, quant="radix", radix_attn=radix_attn)
    jcfg = dataclasses.replace(JCFG, **kw)
    tcfg = dataclasses.replace(TCFG, **kw)
    mix = {k: v[1] for k, v in ref_params["segments"][0][0]["mix"].items()}
    if radix_attn:
        mix = {k: jax.tree.map(np.asarray, v) for k, v in jmodel.radixify_params(
            {"mix": jax.tree.map(jnp.asarray, mix)}, jcfg)["mix"].items()}
    x = np.random.default_rng(4).normal(size=(2, 8, 64)).astype(np.float32)
    pos = np.broadcast_to(np.arange(8), (2, 8)).astype(np.int32)
    want, (kj, vj) = jblocks.attention(
        jnp.asarray(x), jax.tree.map(jnp.asarray, mix), jcfg,
        jnp.asarray(pos), return_kv=True)
    got, (kt, vt) = tblocks.attention(
        _t(x), {k: (_t(v) if not isinstance(v, dict) else
                    {n: _t(a) for n, a in v.items()})
                for k, v in mix.items()}, tcfg, _t(pos), return_kv=True)
    _close(got.numpy(), want, 1e-5)
    _close(kt.numpy(), kj, 1e-5)
    _close(vt.numpy(), vj, 1e-5)


def test_ffn_geglu_matches(ref_params):
    ffn = {k: v[2] for k, v in ref_params["segments"][0][0]["ffn"].items()}
    x = np.random.default_rng(6).normal(size=(2, 5, 64)).astype(np.float32)
    want = jblocks.ffn(jnp.asarray(x), jax.tree.map(jnp.asarray, ffn), JCFG)
    got = tblocks.ffn(_t(x), {k: _t(v) for k, v in ffn.items()}, TCFG)
    _close(got.numpy(), want, 1e-5)
