"""The tensor-core GEMM's weight layout and launch plan (``repro_torch.kernels.gemm``).

The radix matmul and conv kernels read their int8 weights K-major, prepared
once where a plan takes them.  These CPU tests hold:

* the K-major preparation of matmul, conv and stacked LM weights, and its
  inverse view, round-trip exactly;
* the kernels' plain versions, given the prepared layout, equal the JAX
  reference's oracles (``repro.kernels.ref``) with ``np.array_equal`` on
  seeded numpy inputs: uint8 levels up to 255 (T = 8), int32 levels of 10
  bits, ``periods=2``, ``out_grid="pow2"``, occupancy rows with an empty
  plane, ragged M/N/K and Cin = 3;
* the launch's arithmetic twin (``gemm.emulate``: split-K ranges, byte
  groups of int32 levels, one byte-masked pass per plane) equals the
  oracle, and every launch plan covers K with no gap or overlap;
* the LM's K-major serving weights give the same product as the
  reference-layout ones.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.configs import gemma_2b
from repro_torch.kernels import gemm
from repro_torch.kernels import ops as tops
from repro_torch.kernels.radix_conv import radix_conv2d_cuda, radix_conv2d_plain
from repro_torch.kernels.radix_matmul import (radix_matmul_cuda,
                                              radix_matmul_plain)
from repro_torch.lm import model as tmodel
from repro_torch.lm import radix as tradix


def _t(a):
    return torch.from_numpy(np.array(a))


def _levels(rng, shape, bits, empty):
    """Seeded levels below 2^bits (plane ``empty`` cleared when given):
    uint8 up to 8 bits, int32 above."""
    x = rng.integers(0, 1 << bits, size=shape)
    if empty is not None:
        x &= ~(1 << empty)
    return x.astype(np.uint8 if bits <= 8 else np.int32)


def _epilogue_rows(rng, n, bits):
    bias = rng.integers(-60, 60, size=(n,)).astype(np.int32)
    scale = 1e-4 if bits <= 8 else 2e-6
    mult = rng.uniform(scale, 20 * scale, size=(n,)).astype(np.float32)
    return bias, mult


def _occupancy(x, bits, empty):
    if empty is None:
        return None
    row = tops.plane_occupancy(_t(x), bits)[0]
    assert int(row[0, empty]) == 0
    return row


# ---------------------------------------------------------------------------
# The layout.
# ---------------------------------------------------------------------------


def test_matmul_kmajor_round_trips():
    w = _t(np.random.default_rng(0).integers(-127, 128, (37, 21))
           .astype(np.int8))
    wk = gemm.matmul_kmajor(w)
    assert wk.shape == (21, 37) and wk.is_contiguous()
    assert torch.equal(wk[5], w[:, 5])               # row n = column n
    assert torch.equal(gemm.matmul_logical(wk), w)


def test_conv_kmajor_round_trips():
    w = _t(np.random.default_rng(1).integers(-127, 128, (3, 2, 5, 7))
           .astype(np.int8))
    wk = gemm.conv_kmajor(w)
    assert wk.shape == (7, 3, 2, 5) and wk.is_contiguous()
    # each output channel's K = KH*KW*Cin taps in (r, c, ci) order
    assert torch.equal(wk.reshape(7, -1)[4], w[..., 4].reshape(-1))
    assert torch.equal(gemm.conv_logical(wk), w)


def test_lm_kmajor_params_round_trip():
    """Stacked (layers, d_in, d_out) levels become (layers, d_out, d_in)
    under ``"qt"``, in place of ``"q"``; other leaves are shared."""
    cfg = dataclasses.replace(gemma_2b.SMOKE, quant="radix")
    params = tmodel.init_params(torch.Generator().manual_seed(0), cfg)
    rad = tmodel.radixify_params(params, cfg)
    prep = tmodel.kmajor_params(rad)
    ffn, ffn_k = rad["segments"][0][0]["ffn"], prep["segments"][0][0]["ffn"]
    for name in ("w_gate", "w_up", "w_down"):
        assert set(ffn_k[name]) == {"qt", "scale"}
        assert ffn_k[name]["qt"].is_contiguous()
        assert torch.equal(ffn_k[name]["qt"].transpose(-1, -2),
                           ffn[name]["q"])
        assert ffn_k[name]["scale"] is ffn[name]["scale"]
    assert prep["embed"] is params["embed"]


# ---------------------------------------------------------------------------
# The plain versions on the prepared layout against the reference oracles.
# ---------------------------------------------------------------------------


MATMUL_CASES = [
    # m, k, n, bits, method, periods, grid, epilogue, empty plane
    (5, 27, 10, 8, "fused", 1, "dense", True, None),
    (5, 27, 10, 8, "bitserial", 1, "dense", True, 6),
    (3, 33, 17, 10, "fused", 1, "dense", False, 4),
    (3, 33, 17, 10, "bitserial", 1, "dense", True, 4),
    (3, 33, 17, 10, "bitserial", 2, "dense", False, None),
    (7, 50, 19, 4, "bitserial", 2, "dense", True, 2),
    (1, 19, 6, 4, "fused", 1, "pow2", True, 1),
    (6, 40, 12, 6, "bitserial", 1, "pow2", True, 0),
]


@pytest.mark.parametrize("m,k,n,bits,method,periods,grid,epi,empty",
                         MATMUL_CASES)
def test_matmul_plain_kmajor_matches_reference(m, k, n, bits, method,
                                               periods, grid, epi, empty):
    rng = np.random.default_rng(m * 1000 + k + bits)
    x = _levels(rng, (m, k), bits, empty)
    w = rng.integers(-127, 128, size=(k, n)).astype(np.int8)
    wk = gemm.matmul_kmajor(_t(w))
    occ = _occupancy(x, bits, empty)
    kw = dict(num_steps=bits, method=method, periods=periods,
              occupancy=occ, kmajor=True)
    acc = jref.radix_matmul_ref(jnp.asarray(x), jnp.asarray(w), bits,
                                periods=periods)
    if not epi:
        got = radix_matmul_plain(_t(x), wk, **kw)
        np.testing.assert_array_equal(got.numpy(), np.asarray(acc))
        return
    bias, mult = _epilogue_rows(rng, n, bits)
    out_steps = min(bits, 8)
    got = radix_matmul_plain(_t(x), wk, bias=_t(bias), mult=_t(mult),
                             out_steps=out_steps, out_grid=grid, **kw)
    if bits <= 8:
        want = jref.radix_matmul_epilogue_ref(
            jnp.asarray(x), jnp.asarray(w), jnp.asarray(bias),
            jnp.asarray(mult), bits, periods=periods, grid=grid)
    else:   # a wide carry requantizes onto T = 8 output levels
        want = jref.requantize_ref(acc + jnp.asarray(bias), out_steps,
                                   jnp.asarray(mult), grid=grid)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the CPU wrapper runs the same plain version on either layout
    assert torch.equal(radix_matmul_cuda(
        _t(x), _t(w), bias=_t(bias), mult=_t(mult), out_steps=out_steps,
        out_grid=grid, **dict(kw, kmajor=False)), got)


CONV_CASES = [
    # x shape, w shape, stride, bits, method, periods, grid, epi, empty
    ((2, 9, 11, 3), (3, 3, 3, 7), 1, 8, "fused", 1, "dense", True, 5),
    ((2, 9, 11, 3), (3, 3, 3, 7), 2, 8, "bitserial", 1, "dense", True, None),
    ((1, 7, 7, 6), (5, 5, 6, 5), 1, 10, "bitserial", 1, "dense", False, 3),
    ((1, 7, 7, 6), (5, 5, 6, 5), 1, 10, "fused", 1, "dense", True, 3),
    ((2, 8, 8, 16), (3, 3, 16, 9), 2, 4, "bitserial", 2, "dense", True, 1),
    ((3, 6, 5, 1), (2, 3, 1, 4), 1, 4, "fused", 1, "pow2", True, 0),
    ((3, 6, 5, 1), (2, 3, 1, 4), 1, 6, "bitserial", 2, "pow2", True, 2),
]


@pytest.mark.parametrize("xs,ws,stride,bits,method,periods,grid,epi,empty",
                         CONV_CASES)
def test_conv_plain_kmajor_matches_reference(xs, ws, stride, bits, method,
                                             periods, grid, epi, empty):
    rng = np.random.default_rng(sum(xs) + sum(ws) + bits)
    x = _levels(rng, xs, bits, empty)
    w = rng.integers(-127, 128, size=ws).astype(np.int8)
    wk = gemm.conv_kmajor(_t(w))
    occ = _occupancy(x, bits, empty)
    kw = dict(num_steps=bits, method=method, stride=stride, periods=periods,
              occupancy=occ, kmajor=True)
    acc = jref.radix_conv2d_ref(jnp.asarray(x), jnp.asarray(w), bits,
                                stride=stride, periods=periods)
    if not epi:
        got = radix_conv2d_plain(_t(x), wk, **kw)
        np.testing.assert_array_equal(got.numpy(), np.asarray(acc))
        return
    bias, mult = _epilogue_rows(rng, ws[-1], bits)
    out_steps = min(bits, 8)
    got = radix_conv2d_plain(_t(x), wk, bias=_t(bias), mult=_t(mult),
                             out_steps=out_steps, out_grid=grid, **kw)
    if bits <= 8:
        want = jref.radix_conv2d_epilogue_ref(
            jnp.asarray(x), jnp.asarray(w), jnp.asarray(bias),
            jnp.asarray(mult), bits, stride=stride, periods=periods,
            grid=grid)
    else:
        want = jref.requantize_ref(acc + jnp.asarray(bias), out_steps,
                                   jnp.asarray(mult), grid=grid)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert torch.equal(radix_conv2d_cuda(
        _t(x), _t(w), bias=_t(bias), mult=_t(mult), out_steps=out_steps,
        out_grid=grid, **dict(kw, kmajor=False)), got)


# ---------------------------------------------------------------------------
# The launch plan and the launch's arithmetic.
# ---------------------------------------------------------------------------


PLAN_CASES = [
    # m, n, k, SMs: Gemma-2B decode and prefill FFN, VGG-11 fc1 at buckets
    # 1 and 8, its logits layer, LeNet's fc, a conv, ragged and tiny shapes
    (8, 16384, 2048, 132), (8, 2048, 16384, 132),
    (2048, 16384, 2048, 132), (2048, 2048, 16384, 132),
    (1, 4096, 25088, 132), (8, 4096, 25088, 132), (8, 100, 4096, 132),
    (8, 120, 400, 132), (401408, 64, 27, 132), (196, 512, 4608, 132),
    (33, 300, 1000, 132), (1, 8, 16, 132), (5, 3, 1, 4), (40, 70, 333, 16),
]


@pytest.mark.parametrize("m,n,k,sms", PLAN_CASES)
def test_plan_covers_k(m, n, k, sms):
    launch = gemm.plan(m, n, k, sms)
    assert launch.tile is (gemm.SMALL if m <= gemm.SMALL_M else
                           gemm.MID if n <= 64 else gemm.LARGE)
    assert gemm.TILES[launch.index] is launch.tile
    assert launch.k_chunk % launch.tile.bk == 0 and launch.split >= 1
    ranges = gemm.k_ranges(k, launch)
    assert len(ranges) == launch.split
    assert ranges[0][0] == 0 and ranges[-1][1] == k
    for (lo, hi), (lo2, _) in zip(ranges, ranges[1:]):
        assert lo < hi == lo2                 # no gap, no overlap, none empty
    tiles = -(-m // launch.tile.act) * -(-n // launch.tile.w)
    if launch.split > 1:                      # split only to fill the card
        assert tiles < sms


def test_plan_splits_decode_weight_stream():
    """Gemma-2B's w_down at decode has 16 weight tiles: split K so that
    at least two blocks per SM stream the weights."""
    launch = gemm.plan(8, 2048, 16384, 132)
    assert launch.tile is gemm.SMALL and launch.split * 16 >= 2 * 132 - 16


EMULATE_CASES = [
    # m, k, n, bits, fused, periods, empty, forced k_chunk (None: planned)
    (6, 300, 20, 8, True, 1, None, 128),
    (6, 300, 20, 8, False, 1, 3, 128),
    (6, 300, 20, 4, False, 2, 1, 256),
    (9, 70, 11, 20, True, 1, 12, 64),        # three byte groups
    (9, 70, 11, 20, False, 1, 12, 64),
    (9, 70, 11, 10, False, 2, None, None),
    (40, 333, 70, 6, True, 1, 2, None),
    (1, 16, 3, 8, False, 1, 7, None),
]


@pytest.mark.parametrize("m,k,n,bits,fused,periods,empty,k_chunk",
                         EMULATE_CASES)
def test_emulated_launch_matches_reference(m, k, n, bits, fused, periods,
                                           empty, k_chunk):
    rng = np.random.default_rng(m + k + n + bits)
    x = _levels(rng, (m, k), bits, empty)
    w = rng.integers(-127 if bits <= 10 else -3, 128 if bits <= 10 else 4,
                     size=(k, n)).astype(np.int8)
    launch = gemm.plan(m, n, k, 132)
    if k_chunk is not None:
        launch = gemm.Launch(launch.tile, -(-k // k_chunk), k_chunk)
    occ = _occupancy(x, bits, empty)
    got = gemm.emulate(_t(x), gemm.matmul_kmajor(_t(w)), num_steps=bits,
                       fused=fused, periods=periods, occupancy=occ,
                       launch=launch)
    want = jref.radix_matmul_ref(jnp.asarray(x), jnp.asarray(w), bits,
                                 periods=periods)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# The LM on K-major weights.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("use_kernel", [False, True])
def test_lm_kmajor_weight_same_product(use_kernel):
    cfg = dataclasses.replace(gemma_2b.SMOKE, quant="radix",
                              use_kernel=use_kernel)
    rng = np.random.default_rng(3)
    x = _t(rng.normal(size=(2, 5, 48)).astype(np.float32))
    w = tradix.quantize_weight(_t(rng.normal(size=(48, 80))
                                  .astype(np.float32)))
    got = tradix.maybe_radix_matmul(x, tradix.kmajor_weight(w), cfg=cfg)
    assert torch.equal(got, tradix.maybe_radix_matmul(x, w, cfg=cfg))
