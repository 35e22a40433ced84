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
from _hyp import given, settings, st

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


def test_plain_config_and_wrapper_agree(monkeypatch):
    """``KernelConfig(impl="plain")`` (the packed LM path with
    ``use_kernel=False``) and the wrapper's CPU path are one function, and
    so is ``autotune=True`` on a CPU tensor, whose one candidate is the
    plain version."""
    from repro_torch.kernels import autotune as tat

    q, k_q, k_s, v_q, v_s, mask = _problem(7, 2, 50, 1, 4, 16, 4, "ring",
                                           True)
    args = [torch.from_numpy(a) for a in (q, _pack4(k_q), k_s, _pack4(v_q),
                                          v_s, mask)]
    a = tops.radix_decode_attention(*args, 4, packed=True)
    b = tops.radix_decode_attention(
        *args, 4, packed=True, config=tops.KernelConfig(impl="plain"))
    assert torch.equal(a, b)
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", "")
    tat.reset_default_cache()
    try:
        c = tops.radix_decode_attention(*args, 4, packed=True, autotune=True)
        assert torch.equal(a, c)
        assert tat.default_cache().stats.sweeps == 1
    finally:
        tat.reset_default_cache()


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


# ---------------------------------------------------------------------------
# Split-KV: the cache cut into SPLIT_SLOTS-slot splits and combined.
# ---------------------------------------------------------------------------


def _ring_wrap_mask(b, s_len):
    """Row 0: the window of a ring buffer that has wrapped (valid at both
    ends, the middle masked); row 1 fully masked; further rows causal."""
    slots = np.arange(s_len)
    m = np.zeros((b, s_len), bool)
    m[0] = ((39 - slots) % s_len) < max(1, min(110, s_len))
    for i in range(2, b):
        m[i] = slots <= (s_len * i) // (b + 1)
    return m


SPLIT_CASES = [
    # T, packed, method, S
    (4, True, "fused", 300),
    (4, True, "bitserial", 300),
    (8, False, "fused", 300),
    (8, False, "bitserial", 300),
    (4, True, "bitserial", 1),
    (8, False, "fused", 1),
]


@pytest.mark.parametrize("t,packed,method,s_len", SPLIT_CASES)
def test_split_kv_matches_reference(t, packed, method, s_len):
    """More than one split (S = 300: ten, the last ragged) and one (S =
    1), GQA (Hkv = 2, g = 4) in the cache's (B, S, Hkv, ·) layout, a ring
    mask whose middle splits are fully masked and an all-masked row."""
    b, hkv, g, hd = 3, 2, 4, 16
    q, k_q, k_s, v_q, v_s, _ = _problem(s_len + t, b, s_len, hkv, g, hd, t,
                                        "prefix", False)
    mask = _ring_wrap_mask(b, s_len)
    step = tra.split_slots(s_len)
    if s_len > tra.SPLIT_SLOTS:
        assert s_len % step and -(-s_len // step) > 2   # ragged, several
        dead = [j0 for j0 in range(0, s_len, step)
                if not mask[0, j0:j0 + step].any()]
        assert dead and 0 < dead[0] and dead[-1] + step < s_len
    kc, vc = (_pack4(k_q), _pack4(v_q)) if packed else (k_q, v_q)
    want = np.asarray(jops.radix_decode_attention(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(k_s), jnp.asarray(vc),
        jnp.asarray(v_s), jnp.asarray(mask), t, packed=packed,
        method=method))
    got = tops.radix_decode_attention(
        torch.from_numpy(q), torch.from_numpy(kc), torch.from_numpy(k_s),
        torch.from_numpy(vc), torch.from_numpy(v_s), torch.from_numpy(mask),
        t, packed=packed, method=method).numpy()
    assert got.shape == (b, hkv * g, hd) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **TOL)
    assert not got[1].any()                 # the all-masked row gives 0


@settings(max_examples=12, deadline=None)
@given(seed=st.integers(0, 2**16), t=st.sampled_from([2, 3, 4, 6]),
       method=st.sampled_from(["fused", "bitserial"]),
       s_len=st.integers(1, 80), extra_k=st.integers(0, 255),
       extra_v=st.integers(0, 255))
def test_gating_on_any_occupancy_superset_is_exact(seed, t, method, s_len,
                                                   extra_k, extra_v):
    """An empty plane adds exactly +0, so gating the plane passes on any
    superset of the occupied planes (the tight row, extra bits, all ones)
    gives the same bits as not gating (``sparsity=False``)."""
    packed = t <= 4
    rng = np.random.default_rng(seed)
    b, hkv, g, hd = 2, 1 + seed % 2, 2, 8
    q, k_q, k_s, v_q, v_s, mask = _problem(seed, b, s_len, hkv, g, hd, t,
                                           "prefix", False)
    for lv in (k_q, v_q):                   # clear a random set of planes
        lv &= np.uint8(~rng.integers(0, 1 << t) & 0xFF)
    kc, vc = (_pack4(k_q), _pack4(v_q)) if packed else (k_q, v_q)
    args = [torch.from_numpy(a) for a in (q, kc, k_s, vc, v_s, mask)]
    kw = dict(num_steps=t, method=method, packed=packed)
    want = tra.radix_decode_attn_plain(*args, **kw, sparsity=False)
    occ_k, occ_v = tra.occupancy_rows(args[1], args[3], t, packed)
    ones = torch.ones_like(occ_k)

    def widen(row, extra):
        bits = torch.tensor([(extra >> s) & 1 for s in range(8)],
                            dtype=torch.int32)
        out = row.clone()
        out[0, :8] |= bits
        return out

    for occ in ((occ_k, occ_v), (widen(occ_k, extra_k),
                                 widen(occ_v, extra_v)), (ones, ones)):
        got = tra.radix_decode_attn_plain(*args, **kw, sparsity=True,
                                          occupancy=occ)
        assert torch.equal(got, want)
    assert torch.equal(tra.radix_decode_attn_plain(*args, **kw), want)


@pytest.mark.parametrize("s_len", [1, 17, 32])
@pytest.mark.parametrize("method", ["fused", "bitserial"])
def test_one_split_is_the_unsplit_tile_loop(s_len, method):
    """At S <= SPLIT_SLOTS the split version is one split, and its combine
    is the identity: bit for bit the tile loop alone, finalized."""
    assert s_len <= tra.SPLIT_SLOTS and tra.split_slots(s_len) >= s_len
    b, hkv, g, hd, t = 2, 2, 4, 16, 4
    q, k_q, k_s, v_q, v_s, mask = _problem(s_len, b, s_len, hkv, g, hd, t,
                                           "allmasked", True)
    args = [torch.from_numpy(a) for a in (q, _pack4(k_q), k_s, _pack4(v_q),
                                          v_s, mask)]
    got = tra.radix_decode_attn_plain(*args, num_steps=t, method=method,
                                      packed=True)
    n = b * hkv
    qq, qs = tra.quantize_q(args[0])
    qq = qq.reshape(n, g, hd)

    def rows(a):                            # (B, S, Hkv, ...) -> (N, S, ...)
        moved = a.movedim(2, 1)
        return moved.reshape((n,) + tuple(moved.shape[2:]))

    occ_k, occ_v = tra.occupancy_rows(args[1], args[3], t, True)
    state = tra._attend_split(
        qq, qs.reshape(n, g, 1), qq.sum(-1, keepdim=True, dtype=torch.int32),
        rows(args[1]), rows(args[2]), rows(args[3]), rows(args[4]),
        args[5][:, None].expand(b, hkv, s_len).reshape(n, s_len),
        occ_k[0], occ_v[0], num_steps=t, q_bits=tra.Q_BITS, hd=hd,
        method=method, packed=True)
    assert torch.equal(got, tra.osm_finalize(state).reshape(got.shape))


@pytest.mark.parametrize("splits", [1, 3, 8])
def test_combine_splits_matches_float64(splits):
    """The tree combine of hand-built split states, with all-masked splits
    (m = MASKED, l = 0, o = 0) and one all-masked row, against the merge
    formula in float64."""
    rng = np.random.default_rng(splits)
    n, g, hd = 3, 2, 5
    m = rng.normal(scale=4.0, size=(n, splits, g, 1)).astype(np.float32)
    l = rng.uniform(1.0, 40.0, size=(n, splits, g, 1)).astype(np.float32)
    o = rng.normal(scale=10.0, size=(n, splits, g, hd)).astype(np.float32)
    dead = rng.random((n, splits)) < 0.4
    dead[2] = True                          # row 2: every split masked
    if splits > 1:
        dead[0, 0], dead[0, 1] = True, False
    m[dead], l[dead], o[dead] = tra.MASKED, 0.0, 0.0
    got = tra.combine_splits(torch.from_numpy(m), torch.from_numpy(l),
                             torch.from_numpy(o)).numpy()
    m64, l64, o64 = (a.astype(np.float64) for a in (m, l, o))
    w = np.exp(m64 - m64.max(axis=1, keepdims=True))
    lt = (l64 * w).sum(axis=1)
    ot = (o64 * w).sum(axis=1)
    want = ot / np.where(lt > 0, lt, 1.0)
    assert got.shape == (n, g, hd) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert not got[2].any()


@pytest.mark.parametrize("s_len", [1, 31, 32, 33, 300, 1024, 1025, 8192,
                                   40000])
def test_split_slots_shape_rule(s_len):
    """Whole tiles, one split up to SPLIT_SLOTS, at most MAX_SPLITS, the
    least split that keeps to that bound, and nothing but the length."""
    step = tra.split_slots(s_len)
    nsplit = -(-s_len // step)
    assert step % tra.SLOTS == 0 and step % tra.SPLIT_SLOTS == 0
    assert nsplit <= tra.MAX_SPLITS
    assert (nsplit == 1) == (s_len <= step)
    if s_len <= tra.SPLIT_SLOTS:
        assert nsplit == 1
    if step > tra.SPLIT_SLOTS:
        assert -(-s_len // (step - tra.SPLIT_SLOTS)) > tra.MAX_SPLITS


def test_cuda_wrapper_refuses_other_devices():
    q, k_q, k_s, v_q, v_s, mask = _problem(3, 1, 8, 1, 2, 8, 4, "prefix",
                                           False)
    args = [torch.from_numpy(a).to("meta") for a in (q, _pack4(k_q), k_s,
                                                     _pack4(v_q), v_s, mask)]
    with pytest.raises(ValueError, match="CPU or CUDA"):
        tra.radix_decode_attn_cuda(*args, num_steps=4, packed=True)


WIDE_CASES = [
    # T, packed, method, g, hkv, hd, B, S: RecurrentGemma-2B's group (g =
    # 10, hd = 256), GLM4-9B's (g = 16 over 2 kv heads, hd = 128), and
    # heads past 256 dims (hd = 512), which the kernel's lanes loop over
    (4, True, "bitserial", 10, 1, 256, 2, 70),
    (4, True, "fused", 10, 1, 256, 1, 33),
    (4, True, "fused", 16, 2, 128, 2, 70),
    (4, True, "bitserial", 16, 2, 128, 1, 40),
    (8, False, "fused", 2, 1, 512, 2, 70),
    (4, True, "bitserial", 2, 1, 512, 1, 40),
]


@pytest.mark.parametrize("t,packed,method,g,hkv,hd,b,s_len", WIDE_CASES)
def test_wide_groups_and_heads_match_reference(t, packed, method, g, hkv, hd,
                                               b, s_len):
    """Groups past 8 query heads and heads past 256 dims: the plain
    version (which the kernel repeats bit for bit on the card) against
    the reference's Pallas kernel in interpret mode and both packages'
    oracle, at the reference's 3e-5, with an all-masked row and an empty
    plane; several splits (S > SPLIT_SLOTS) and one."""
    q, k_q, k_s, v_q, v_s, mask = _problem(g * 1000 + hd + s_len, b, s_len,
                                           hkv, g, hd, t, "allmasked", True)
    kc, vc = (_pack4(k_q), _pack4(v_q)) if packed else (k_q, v_q)
    want = np.asarray(jops.radix_decode_attention(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(k_s), jnp.asarray(vc),
        jnp.asarray(v_s), jnp.asarray(mask), t, packed=packed,
        method=method))
    args = [torch.from_numpy(a) for a in (q, kc, k_s, vc, v_s, mask)]
    got = tops.radix_decode_attention(*args, t, packed=packed,
                                      method=method).numpy()
    oracle = np.asarray(jref.decode_attn_ref(
        jnp.asarray(q), jnp.asarray(k_q), jnp.asarray(k_s), jnp.asarray(v_q),
        jnp.asarray(v_s), jnp.asarray(mask), t))
    assert got.shape == (b, hkv * g, hd) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got, oracle, **TOL)
    assert not got[0].any()                 # the all-masked row gives 0
    # the kernel's shared memory at these shapes fits one block
    assert tra.smem_bytes(g, hd, packed, tra.split_slots(s_len)) \
        <= tra.MAX_SMEM


SPLIT_OVERRIDES = [(32, 32), (64, 32), (32, 16), (64, 16), (96, 4), (32, 1)]


@pytest.mark.parametrize("s_len", [32, 33, 64, 65, 96, 97, 1024, 1025])
def test_split_override_on_exact_inputs_equals_default(s_len):
    """A named KV split, at split boundaries, gives the default's bits when
    every float op is exact: T = 1 (the value constant 2/lvl is 2), unit
    v-scales and k-scales of 0 (every valid score 0, so p = 1 and the
    merge weights exp(0) = 1): the sums are integers below 2^24 in any
    order."""
    b, hkv, g, hd, t = 2, 1, 3, 8, 1
    q, k_q, _, v_q, _, mask = _problem(s_len, b, s_len, hkv, g, hd, t,
                                       "allmasked", False)
    zeros = np.zeros((b, s_len, hkv), np.float32)
    args = [torch.from_numpy(a) for a in (q, k_q, zeros, v_q, zeros + 1.0,
                                          mask)]
    for method in ("fused", "bitserial"):
        kw = dict(num_steps=t, method=method)
        want = tra.radix_decode_attn_plain(*args, **kw)
        for splits in SPLIT_OVERRIDES:
            got = tra.radix_decode_attn_plain(*args, **kw, splits=splits)
            assert torch.equal(got, want), (splits, method)
            cfg = tops.KernelConfig(split_slots=splits[0],
                                    max_splits=splits[1])
            assert torch.equal(tops.radix_decode_attention(
                *args, t, method=method, config=cfg), want)
        # the exact answer: mean over valid slots of 2 v - 1
        v = 2.0 * v_q[..., 0, :].astype(np.float64) - 1.0
        cnt = mask.sum(axis=1)
        ref = (v * mask[..., None]).sum(axis=1) / np.maximum(cnt, 1)[:, None]
        np.testing.assert_array_equal(
            want.numpy(), np.broadcast_to(ref[:, None, :],
                                          want.shape).astype(np.float32))


@pytest.mark.parametrize("splits", SPLIT_OVERRIDES)
def test_split_override_matches_reference(splits):
    """Every named split of a random problem (S = 300, GQA, ring mask)
    agrees with the reference at 3e-5, as the default split does."""
    b, hkv, g, hd, t, s_len = 2, 2, 4, 16, 4, 300
    q, k_q, k_s, v_q, v_s, _ = _problem(7, b, s_len, hkv, g, hd, t, "prefix",
                                        True)
    mask = _ring_wrap_mask(b, s_len)
    kc, vc = _pack4(k_q), _pack4(v_q)
    want = np.asarray(jops.radix_decode_attention(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(k_s), jnp.asarray(vc),
        jnp.asarray(v_s), jnp.asarray(mask), t, packed=True,
        method="bitserial"))
    args = [torch.from_numpy(a) for a in (q, kc, k_s, vc, v_s, mask)]
    got = tra.radix_decode_attn_plain(*args, num_steps=t, packed=True,
                                      method="bitserial", splits=splits)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_kernel_shape_limits():
    """The kernel takes any group and head size whose block fits the card's
    shared memory (``smem_bytes``, which the CUDA wrapper checks before a
    launch), and KV splits of whole tiles, at most the combine's 32."""
    assert tra.smem_bytes(8, 256, True, 32) < 48 * 1024
    assert tra.smem_bytes(16, 128, True, 32) < 48 * 1024
    assert tra.smem_bytes(64, 1024, False, 32) > tra.MAX_SMEM
    with pytest.raises(ValueError):
        tra.check_splits(48, 32)
    with pytest.raises(ValueError):
        tra.check_splits(32, tra.KERNEL_MAX_SPLITS + 1)
