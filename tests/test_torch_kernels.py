"""The radix kernels' wrappers (CPU tensors: their plain versions) against
the Pallas kernels and the reference oracles.

Each case runs ``repro_torch.kernels.ops`` (or the kernel entry point, for
the phase and TTFS schedules) on the CPU and ``repro.kernels.ops`` with
``sparsity=True`` (Pallas in interpret mode, as the reference's own tests
run it), and both oracle modules.  Cases cover both dataflows, epilogue
on and off, 4- and 6-bit inputs, occupancy rows with empty planes,
``periods=2``, ``out_grid="pow2"``, stride 2, SAME pads, channel counts
that are not multiples of 8, and M = 1.  All comparisons are exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.encoding import PhaseEncoding, TTFSEncoding
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.radix_conv import radix_conv2d_cuda
from repro_torch.kernels.radix_matmul import radix_matmul_cuda


def _inputs(seed, x_shape, w_shape, bits, empty):
    """Seeded levels (planes ``bits-1`` and 1 cleared when ``empty``),
    int8 weights, bias and a float32 multiplier row."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 1 << bits, size=x_shape)
    if empty:
        x &= ~((1 << (bits - 1)) | 0b10)
    x = x.astype(np.uint8)
    w = rng.integers(-3, 4, size=w_shape).astype(np.int8)
    n = w_shape[-1]
    b = rng.integers(-60, 60, size=(n,)).astype(np.int32)
    mult = rng.uniform(0.002, 0.05, size=(n,)).astype(np.float32)
    return x, w, b, mult


def _t(a):
    return torch.from_numpy(np.array(a))


def _eq(got, *wants):
    for want in wants:
        want = np.asarray(want)
        assert got.numpy().dtype == want.dtype
        np.testing.assert_array_equal(got.numpy(), want)


MATMUL_CASES = [
    # m, k, n, bits, method, epilogue, empty planes
    (13, 27, 10, 4, "fused", False, True),
    (13, 27, 10, 4, "bitserial", False, True),
    (1, 50, 19, 6, "fused", True, False),
    (1, 50, 19, 6, "bitserial", True, True),
    (16, 130, 70, 6, "fused", True, True),
    (9, 40, 12, 4, "bitserial", True, False),
]


@pytest.mark.parametrize("m,k,n,bits,method,epi,empty", MATMUL_CASES)
def test_radix_matmul_matches_pallas(m, k, n, bits, method, epi, empty):
    x, w, b, mult = _inputs(m * 7 + k, (m, k), (k, n), bits, empty)
    mkw = dict(mult=mult) if epi else {}
    want = jops.radix_matmul(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                             bits, method=method, sparsity=True, **mkw)
    got = tops.radix_matmul(_t(x), _t(w), _t(b), bits, method=method,
                            sparsity=True, **{k_: _t(v) for k_, v in
                                              mkw.items()})
    if epi:
        oracles = (jref.radix_matmul_epilogue_ref(
            jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), mult, bits),
            tref.radix_matmul_epilogue_ref(_t(x), _t(w), _t(b), _t(mult),
                                           bits).numpy())
    else:
        oracles = (jref.radix_matmul_ref(jnp.asarray(x), jnp.asarray(w),
                                         bits) + b,
                   (tref.radix_matmul_ref(_t(x), _t(w), bits)
                    + _t(b)).numpy())
    _eq(got, want, *oracles)


CONV_CASES = [
    # n, h, w, cin, cout, k, stride, padding, bits, method, epi, empty
    (2, 9, 9, 3, 10, 3, 1, "SAME", 4, "fused", False, True),
    (2, 9, 9, 3, 10, 3, 1, "SAME", 4, "bitserial", True, True),
    (1, 11, 10, 5, 6, 3, 2, "VALID", 6, "bitserial", False, False),
    (1, 11, 10, 5, 6, 3, 2, "SAME", 6, "fused", True, True),
    (2, 8, 7, 9, 13, 5, 1, "VALID", 4, "fused", True, False),
    (1, 7, 7, 9, 13, 3, 2, "SAME", 6, "bitserial", True, True),
]


@pytest.mark.parametrize("n,h,w,cin,cout,k,stride,padding,bits,method,epi,"
                         "empty", CONV_CASES)
def test_radix_conv2d_matches_pallas(n, h, w, cin, cout, k, stride, padding,
                                     bits, method, epi, empty):
    x, wq, b, mult = _inputs(h * 13 + cin, (n, h, w, cin),
                             (k, k, cin, cout), bits, empty)
    mkw = dict(mult=mult) if epi else {}
    want = jops.radix_conv2d(jnp.asarray(x), jnp.asarray(wq), jnp.asarray(b),
                             bits, stride=stride, padding=padding,
                             method=method, sparsity=True, **mkw)
    got = tops.radix_conv2d(_t(x), _t(wq), _t(b), bits, stride=stride,
                            padding=padding, method=method, sparsity=True,
                            **{k_: _t(v) for k_, v in mkw.items()})
    xp = x
    if padding == "SAME":
        ph = tops.same_pads(h, k, stride)
        pw = tops.same_pads(w, k, stride)
        xp = np.pad(x, ((0, 0), ph, pw, (0, 0)))
    if epi:
        oracles = (jref.radix_conv2d_epilogue_ref(
            jnp.asarray(xp), jnp.asarray(wq), jnp.asarray(b), mult, bits,
            stride=stride),
            tref.radix_conv2d_epilogue_ref(_t(xp), _t(wq), _t(b), _t(mult),
                                           bits, stride=stride).numpy())
    else:
        oracles = (jref.radix_conv2d_ref(jnp.asarray(xp), jnp.asarray(wq),
                                         bits, stride=stride) + b,
                   (tref.radix_conv2d_ref(_t(xp), _t(wq), bits,
                                          stride=stride) + _t(b)).numpy())
    _eq(got, want, *oracles)


# the phase (periods=2) and TTFS (out_grid="pow2") schedules: the reference
# reaches them through its Phase/TTFS specs, the port through the kernel
# entry points (those specs come with a later slice)
SCHEDULES = {
    "periods2": (PhaseEncoding(8, periods=2), dict(periods=2), "dense", 2),
    "pow2": (TTFSEncoding(4), dict(out_grid="pow2"), "pow2", 1),
}


# the fused dataflow never replays periods, so phase runs bitserial only
SCHEDULE_CASES = [("periods2", "bitserial"), ("pow2", "fused"),
                  ("pow2", "bitserial")]


@pytest.mark.parametrize("sched,method", SCHEDULE_CASES)
def test_matmul_schedules_match_pallas(sched, method):
    spec, kw, grid, periods = SCHEDULES[sched]
    x, w, b, mult = _inputs(5, (11, 45), (45, 21), 4, True)
    want = jops.radix_matmul(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                             spec, method=method, mult=mult, sparsity=True)
    occ = tops.plane_occupancy(_t(x), 4)[0]
    bias, mrow = tops.epilogue_rows(_t(b), _t(mult), 21, 21)
    got = radix_matmul_cuda(_t(x), _t(w), num_steps=4, method=method,
                            bias=bias, mult=mrow, occupancy=occ,
                            out_level=15, **kw)
    oracle = jref.radix_matmul_epilogue_ref(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), mult, 4,
        periods=periods, grid=grid)
    _eq(got, want, oracle, tref.radix_matmul_epilogue_ref(
        _t(x), _t(w), _t(b), _t(mult), 4, periods=periods,
        grid=grid).numpy())


@pytest.mark.parametrize("sched,method", SCHEDULE_CASES)
def test_conv_schedules_match_pallas(sched, method):
    spec, kw, grid, periods = SCHEDULES[sched]
    x, w, b, mult = _inputs(6, (2, 9, 8, 5), (3, 3, 5, 11), 4, True)
    want = jops.radix_conv2d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                             spec, stride=2, method=method, mult=mult,
                             sparsity=True)
    occ = tops.plane_occupancy(_t(x), 4)[0]
    bias, mrow = tops.epilogue_rows(_t(b), _t(mult), 11, 11)
    got = radix_conv2d_cuda(_t(x), _t(w), num_steps=4, method=method,
                            stride=2, bias=bias, mult=mrow, occupancy=occ,
                            out_level=15, **kw)
    oracle = jref.radix_conv2d_epilogue_ref(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), mult, 4, stride=2,
        periods=periods, grid=grid)
    _eq(got, want, oracle, tref.radix_conv2d_epilogue_ref(
        _t(x), _t(w), _t(b), _t(mult), 4, stride=2, periods=periods,
        grid=grid).numpy())


@pytest.mark.parametrize("bits,clear", [(4, ()), (4, (3,)), (6, (0, 5)),
                                        (10, (9,))])
def test_plane_occupancy_matches_reference(bits, clear):
    rng = np.random.default_rng(bits)
    x = rng.integers(0, 1 << bits, size=(3, 5, 7))
    for s in clear:
        x &= ~(1 << s)
    x = x.astype(np.uint8 if bits <= 8 else np.int32)
    row, occ_bits = tops.plane_occupancy(_t(x), bits)
    jrow, jbits = jops.plane_occupancy(jnp.asarray(x), bits)
    _eq(row, jrow)
    _eq(occ_bits, jbits)
    assert int(occ_bits.sum()) == bits - len(clear)


def test_epilogue_rows_match_reference():
    b = np.arange(-3, 4, dtype=np.int32)
    mult = np.linspace(0.01, 0.07, 7, dtype=np.float32)
    for m in (mult, np.float32(0.5)):
        got = tops.epilogue_rows(_t(b), _t(m), 7, 12)
        want = jops.epilogue_rows(jnp.asarray(b), jnp.asarray(m), 7, 12)
        for g, w in zip(got, want):
            _eq(g, w)


def test_int32_levels_and_phase_divide_on_plain_path():
    """Wide (avg-pool carry) int32 levels and negative phase sums: the plain
    version floor-divides, and agrees with the oracle."""
    x, w, b, mult = _inputs(9, (6, 33), (33, 9), 10, False)
    x = x.astype(np.int32) * 3
    for periods in (1, 2, 3):
        got = radix_matmul_cuda(_t(x), _t(w), num_steps=10,
                                method="bitserial", periods=periods)
        _eq(got, tref.radix_matmul_ref(_t(x), _t(w), 10,
                                       periods=periods).numpy(),
            jref.radix_matmul_ref(jnp.asarray(x), jnp.asarray(w), 10,
                                  periods=periods))


def test_wrappers_reject_bad_arguments():
    x = torch.zeros((4, 8), dtype=torch.uint8)
    w = torch.zeros((8, 3), dtype=torch.int8)
    with pytest.raises(ValueError):     # no compiled tile of that shape
        tops.radix_matmul(x, w, None, 4,
                          config=tops.KernelConfig(bm=64, bn=64, bk=64))
    with pytest.raises(ValueError):
        radix_matmul_cuda(x, w, num_steps=4, method="rowwise")
    with pytest.raises(ValueError):
        tops.radix_conv2d(x.reshape(1, 2, 2, 8), w.reshape(1, 1, 8, 3),
                          None, 4, padding="FULL")
