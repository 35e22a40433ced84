"""The port's decode attention over the radix KV cache against the JAX
package.

``repro_torch.kernels.ops.radix_decode_attention`` on CPU tensors runs the
kernel wrapper's plain version; the reference's runs the Pallas kernel in
interpret mode (its default strategy), as its own tests run it.  Both are
also held against both packages' plane-level oracle ``decode_attn_ref``.
Cases cover both dataflows, packed (T = 3, 4) and unpacked (T = 4, 6)
caches, occupancy with an empty plane, a causal prefix, a ring window
with wraparound and a fully masked batch row, S not a multiple of 128 and
g in {1, 2, 4}.  Tolerance: the reference's own bar for decode attention,
3e-5 (the integer parts are exact; the float softmax reassociates).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import radix_attn as jra
from repro.kernels import ref as jref
from repro.lm import blocks as jblocks
from repro_torch.kernels import ops as tops
from repro_torch.kernels import radix_attn as tra
from repro_torch.kernels import ref as tref
from repro_torch.lm import blocks as tblocks

TOL = dict(rtol=3e-5, atol=3e-5)


def _pack4(lv):
    return ((lv[..., 0::2] << 4) | lv[..., 1::2]).astype(np.uint8)


def _mask(kind, b, s_len, seed):
    """(B, S) bool: a causal prefix, a ring window that has wrapped, or a
    prefix with batch row 0 fully masked."""
    if kind == "ring":
        window = s_len
        pos = s_len + 7 + seed % 5          # wrapped past the ring's end
        m = np.asarray(jblocks.decode_mask(jnp.int32(pos), s_len, window))
        return np.broadcast_to(m, (b, s_len)).copy()
    n_valid = max(1, (2 * s_len) // 3)
    m = np.zeros((b, s_len), bool)
    m[:, :n_valid] = True
    if kind == "allmasked":
        m[0] = False
    return m


def _problem(seed, b, s_len, hkv, g, hd, t, mask_kind, empty_plane):
    rng = np.random.default_rng(seed)
    lvl = (1 << t) - 1
    q = rng.normal(size=(b, hkv * g, hd)).astype(np.float32)
    k_q = rng.integers(0, lvl + 1, size=(b, s_len, hkv, hd))
    v_q = rng.integers(0, lvl + 1, size=(b, s_len, hkv, hd))
    if empty_plane:                         # plane 1 empty in K and V
        k_q &= ~0b10
        v_q &= ~0b10
    k_s = rng.uniform(0.25, 2.0, size=(b, s_len, hkv)).astype(np.float32)
    v_s = rng.uniform(0.25, 2.0, size=(b, s_len, hkv)).astype(np.float32)
    return (q, k_q.astype(np.uint8), k_s, v_q.astype(np.uint8), v_s,
            _mask(mask_kind, b, s_len, seed))


CASES = [
    # T, packed, method, g, hkv, B, S, mask, empty plane
    (4, True, "bitserial", 2, 2, 2, 130, "prefix", True),
    (4, True, "fused", 4, 1, 2, 130, "ring", False),
    (3, True, "fused", 1, 2, 3, 40, "allmasked", True),
    (4, False, "bitserial", 4, 2, 2, 130, "allmasked", True),
    (4, False, "fused", 1, 1, 2, 129, "ring", False),
    (6, False, "bitserial", 2, 1, 3, 77, "prefix", True),
]


@pytest.mark.parametrize("t,packed,method,g,hkv,b,s_len,mask_kind,empty",
                         CASES)
def test_decode_attention_matches_reference(t, packed, method, g, hkv, b,
                                            s_len, mask_kind, empty):
    hd = 16
    q, k_q, k_s, v_q, v_s, mask = _problem(
        t * 100 + g * 10 + s_len, b, s_len, hkv, g, hd, t, mask_kind, empty)
    kc, vc = (_pack4(k_q), _pack4(v_q)) if packed else (k_q, v_q)
    want = np.asarray(jops.radix_decode_attention(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(k_s), jnp.asarray(vc),
        jnp.asarray(v_s), jnp.asarray(mask), t, packed=packed,
        method=method))
    got = tops.radix_decode_attention(
        torch.from_numpy(q), torch.from_numpy(kc), torch.from_numpy(k_s),
        torch.from_numpy(vc), torch.from_numpy(v_s), torch.from_numpy(mask),
        t, packed=packed, method=method).numpy()
    oracle_j = np.asarray(jref.decode_attn_ref(
        jnp.asarray(q), jnp.asarray(k_q), jnp.asarray(k_s), jnp.asarray(v_q),
        jnp.asarray(v_s), jnp.asarray(mask), t))
    oracle_t = tref.decode_attn_ref(
        torch.from_numpy(q), torch.from_numpy(k_q), torch.from_numpy(k_s),
        torch.from_numpy(v_q), torch.from_numpy(v_s), torch.from_numpy(mask),
        t).numpy()
    assert got.dtype == np.float32 and got.shape == (b, hkv * g, hd)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got, oracle_j, **TOL)
    np.testing.assert_allclose(oracle_t, oracle_j, **TOL)
    if mask_kind == "allmasked":
        assert not got[0].any()             # a fully masked row gives 0


@pytest.mark.parametrize("seed", [0, 1])
def test_quantize_q_levels_equal(seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(3, 4, 32)).astype(np.float32)
    q[0, 0, :] = np.linspace(-1.0, 1.0, 32, dtype=np.float32)  # x.5 ties
    lv_j, s_j = jra.quantize_q(jnp.asarray(q))
    lv_t, s_t = tra.quantize_q(torch.from_numpy(q))
    np.testing.assert_array_equal(lv_t.numpy(), np.asarray(lv_j))
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))


@pytest.mark.parametrize("pos,s_len,window", [
    (0, 8, 0), (5, 8, 0), (7, 8, 0), (3, 8, 8), (8, 8, 8), (13, 8, 8),
    (20, 6, 6), (2, 5, 5)])
def test_decode_mask_matches_simulation(pos, s_len, window):
    got = tblocks.decode_mask(pos, s_len, window).numpy()
    assert got.shape == (1, s_len)
    np.testing.assert_array_equal(got[0], tref.decode_mask_ref(
        pos, s_len, window).numpy())
    np.testing.assert_array_equal(got[0], np.asarray(jref.decode_mask_ref(
        pos, s_len, window)))
    np.testing.assert_array_equal(got, np.asarray(jblocks.decode_mask(
        jnp.int32(pos), s_len, window)))
    per_row = tblocks.decode_mask(torch.tensor([pos, 0]), s_len, window)
    np.testing.assert_array_equal(per_row[0].numpy(), got[0])


def test_plain_config_and_wrapper_agree():
    """``KernelConfig(impl="plain")`` (the packed LM path with
    ``use_kernel=False``) and the wrapper's CPU path are one function."""
    q, k_q, k_s, v_q, v_s, mask = _problem(7, 2, 50, 1, 4, 16, 4, "ring",
                                           True)
    args = [torch.from_numpy(a) for a in (q, _pack4(k_q), k_s, _pack4(v_q),
                                          v_s, mask)]
    a = tops.radix_decode_attention(*args, 4, packed=True)
    b = tops.radix_decode_attention(
        *args, 4, packed=True, config=tops.KernelConfig(impl="plain"))
    assert torch.equal(a, b)
    with pytest.raises(NotImplementedError, match="autotune"):
        tops.radix_decode_attention(*args, 4, packed=True, autotune=True)


def test_osm_all_masked_block_is_stable():
    state = tra.osm_init((1, 2, 1), (1, 2, 3))
    scores = torch.full((1, 2, 4), 5.0)
    mask = torch.zeros((1, 1, 4), dtype=torch.bool)
    state = tra.osm_update(state, scores, mask,
                           lambda p: torch.ones((1, 2, 3)) * p.sum())
    out = tra.osm_finalize(state)
    assert torch.equal(out, torch.zeros((1, 2, 3)))


@pytest.mark.parametrize("n", [1, 5, 32, 37])
def test_tree_sum_is_the_warp_butterfly_order(n):
    """``tree_sum`` repeats the kernel's reduction order bit for bit: lane
    k adds lane k + w for w = 16, 8, 4, 2, 1 over a zero-padded tile."""
    x = torch.from_numpy(np.random.default_rng(n).lognormal(
        0.0, 3.0, size=(3, n)).astype(np.float32))
    width = 1 << max(n - 1, 0).bit_length()
    lanes = [x[:, j] if j < n else torch.zeros(3) for j in range(width)]
    w = width // 2
    while w:
        lanes = [lanes[k] + lanes[k + w] for k in range(w)]
        w //= 2
    assert torch.equal(tra.tree_sum(x)[:, 0], lanes[0])
