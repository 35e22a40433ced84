"""The port's spike encoder (``ops.radix_encode``; on CPU tensors the
kernel wrapper's plain version) against the reference's
``ops.radix_encode`` (the Pallas kernel in interpret mode): equal levels
for T = 1..8 at three scales, on inputs placed on level boundaries, next
to them, below 0 and above ``scale``, in several shapes.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.core.encoding import RadixEncoding
from repro_torch.kernels import ops as tops
from repro_torch.kernels.spike_encode import (spike_encode_cuda,
                                              spike_encode_plain)

SCALES = (1.0, 0.37, 0.813)


def _inputs(t, scale, seed):
    """Uniform values over [-0.25, 1.25] * scale, every level boundary
    k * scale / 2^T (in float32) and its float32 neighbours; 24 | size."""
    rng = np.random.default_rng(seed)
    k = np.arange(-2, (1 << t) + 3, dtype=np.float32)
    x = rng.uniform(-0.25 * scale, 1.25 * scale,
                    size=192 + (-3 * k.size) % 24).astype(np.float32)
    edges = (k * np.float32(scale) / np.float32(1 << t)).astype(np.float32)
    near = np.concatenate([edges, np.nextafter(edges, np.float32(-np.inf)),
                           np.nextafter(edges, np.float32(np.inf))])
    return np.concatenate([x, near]).astype(np.float32)


@pytest.mark.parametrize("scale", SCALES)
@pytest.mark.parametrize("t", range(1, 9))
def test_radix_encode_matches_reference(t, scale):
    x = _inputs(t, scale, t * 7 + int(scale * 1000))
    for shape in ((x.size,), (2, x.size // 24, 3, 4)):
        xs = x.reshape(shape)
        want = np.asarray(jops.radix_encode(jnp.asarray(xs), t, scale))
        got = tops.radix_encode(torch.from_numpy(xs), t, scale)
        assert got.dtype == torch.uint8 and tuple(got.shape) == shape
        np.testing.assert_array_equal(got.numpy(), want)


def test_encoding_spec_and_wrapper_paths_agree():
    x = torch.from_numpy(_inputs(4, 0.37, 3))
    a = tops.radix_encode(x, RadixEncoding(4), 0.37)
    assert torch.equal(a, spike_encode_cuda(x, num_steps=4, scale=0.37))
    assert torch.equal(a, spike_encode_plain(x, num_steps=4, scale=0.37))
    assert int(a.max()) == 15 and int(a.min()) == 0
