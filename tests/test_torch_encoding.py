"""repro_torch.core.encoding against repro.core.encoding, exhaustively.

For T = 1..8 every level goes through encode/decode, pack/unpack and
pow2_floor on both sides; quantize runs on a grid of floats that holds the
exact level boundaries (and their float32 neighbours) for several scales.
All comparisons are exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import encoding as jenc
from repro_torch.core import encoding as tenc

STEPS = list(range(1, 9))
SCALES = [1.0, 0.37, 2.5, 0.1]


def _boundary_grid(num_steps: int, scale: float) -> np.ndarray:
    """Floats around every level boundary ``k * scale / 2^T`` plus a
    uniform sweep past both clip ends; 4096 values for every T, so the
    reference's eager ops compile once."""
    levels = 1 << num_steps
    edges = (np.arange(-1, levels + 2) * scale / levels).astype(np.float32)
    up = np.nextafter(edges, np.float32(np.inf))
    down = np.nextafter(edges, np.float32(-np.inf))
    sweep = np.linspace(-0.5 * scale, 1.5 * scale, 4096 - 3 * edges.size,
                        dtype=np.float32)
    return np.concatenate([edges, up, down, sweep]).astype(np.float32)


def _all_levels(num_steps: int) -> np.ndarray:
    """Every level of T bits, repeated to 256 entries."""
    return (np.arange(256) % (1 << num_steps)).astype(np.uint8)


@pytest.mark.parametrize("scale", SCALES)
@pytest.mark.parametrize("num_steps", STEPS)
def test_quantize_matches_reference(num_steps, scale):
    x = _boundary_grid(num_steps, scale)
    want = np.asarray(jenc.quantize(jnp.asarray(x), num_steps, scale))
    got = tenc.quantize(torch.from_numpy(x), num_steps, scale).numpy()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    spec_got = tenc.RadixEncoding(num_steps).quantize(torch.from_numpy(x),
                                                      scale).numpy()
    np.testing.assert_array_equal(spec_got, want)


@pytest.mark.parametrize("num_steps", STEPS)
def test_dequantize_matches_reference(num_steps):
    q = _all_levels(num_steps)
    for scale in SCALES:
        want = np.asarray(jenc.dequantize(jnp.asarray(q), num_steps, scale))
        got = tenc.dequantize(torch.from_numpy(q), num_steps, scale).numpy()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("num_steps", STEPS)
def test_encode_decode_every_level(num_steps):
    q = _all_levels(num_steps)
    want = np.asarray(jenc.encode(jnp.asarray(q), num_steps))
    got = tenc.encode(torch.from_numpy(q), num_steps)
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(tenc.decode(got).numpy(),
                                  np.asarray(jenc.decode(jnp.asarray(want))))
    np.testing.assert_array_equal(tenc.decode(got).numpy(), q.astype(np.int32))


@pytest.mark.parametrize("num_steps", STEPS)
def test_pack_unpack_every_level(num_steps):
    q = _all_levels(num_steps)
    planes = tenc.unpack_planes(torch.from_numpy(q), num_steps)
    np.testing.assert_array_equal(
        planes.numpy(),
        np.asarray(jenc.unpack_planes(jnp.asarray(q), num_steps)))
    packed = tenc.pack_planes(planes)
    want = jenc.pack_planes(jnp.asarray(planes.numpy()))
    assert packed.numpy().dtype == np.asarray(want).dtype
    np.testing.assert_array_equal(packed.numpy(), np.asarray(want))


@pytest.mark.parametrize("num_steps", STEPS)
def test_pow2_floor_every_level(num_steps):
    q = _all_levels(num_steps).astype(np.int32)
    np.testing.assert_array_equal(
        tenc.pow2_floor(torch.from_numpy(q), num_steps).numpy(),
        np.asarray(jenc.pow2_floor(jnp.asarray(q), num_steps)))


@pytest.mark.parametrize("num_steps", STEPS)
def test_spec_schedule_and_requantize(num_steps):
    tspec, jspec = tenc.RadixEncoding(num_steps), jenc.RadixEncoding(num_steps)
    assert (tspec.levels, tspec.max_level, tspec.packed_bits) == (
        jspec.levels, jspec.max_level, jspec.packed_bits)
    assert tspec.kernel_schedule() == tenc.KernelSchedule(
        **vars(jspec.kernel_schedule()))
    for df in (None, "fused", "bitserial"):
        assert tspec.validate_dataflow(df) == jspec.validate_dataflow(df)
    with pytest.raises(ValueError):
        tspec.validate_dataflow("rowwise")
    acc = np.random.default_rng(num_steps).integers(
        -5000, 5000, size=(64,), dtype=np.int32)
    mult = np.float32(0.0173)
    np.testing.assert_array_equal(
        tspec.requantize(torch.from_numpy(acc), torch.tensor(mult)).numpy(),
        np.asarray(jspec.requantize(jnp.asarray(acc), jnp.asarray(mult))))
    planes = tenc.encode(torch.from_numpy(_all_levels(num_steps)), num_steps)
    np.testing.assert_array_equal(
        tspec.reduce_planes(planes).numpy(),
        np.asarray(jspec.reduce_planes(jnp.asarray(planes.numpy()))))


def test_spec_validates_pools_and_steps():
    spec = tenc.RadixEncoding(4)
    spec.validate_static((("pool", {"window": 2, "mode": "or"}),))
    with pytest.raises(ValueError, match="pool mode"):
        spec.validate_static((("pool", {"window": 2, "mode": "median"}),))
    with pytest.raises(ValueError):
        tenc.RadixEncoding(0)
