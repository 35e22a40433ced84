"""repro_torch.core.{layers,neuron} against repro.core.{layers,neuron}.

Every twin pair and pool on seeded uint8 levels / int8 weights; odd
spatial sizes hit the VALID crop of the pools and the SAME pads of the
convs.  All comparisons are exact.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import encoding as jenc
from repro.core import layers as jl
from repro.core import neuron as jn
from repro_torch.core import encoding as tenc
from repro_torch.core import layers as tl
from repro_torch.core import neuron as tn

T = 4


def _levels(rng, shape, bits=T):
    return rng.integers(0, 1 << bits, size=shape).astype(np.uint8)


def _weights(rng, shape):
    return rng.integers(-3, 4, size=shape).astype(np.int8)


@functools.partial(jax.jit, static_argnames=("stride", "padding"))
def _jax_conv(x, w, b, *, stride, padding):
    """The reference's packed and spiking convs, one XLA program."""
    return (jl.q_conv2d(x, w, b, stride=stride, padding=padding),
            jl.snn_conv2d(jenc.encode(x, T), w, b, stride=stride,
                          padding=padding))


@jax.jit
def _jax_linear(x, w, b):
    return jl.q_linear(x, w, b), jl.snn_linear(jenc.encode(x, T), w, b)


@functools.partial(jax.jit, static_argnames=("window",))
def _jax_pools(x, wide, *, window):
    planes = jenc.encode(x, T)
    return dict(avg=jl.q_avg_pool(x, window), max=jl.q_max_pool(x, window),
                orp=jl.q_or_pool(x, window),
                wide_or=jl.q_or_pool(wide, window),
                wide_avg=jl.q_avg_pool(wide, window),
                snn_avg=jl.snn_avg_pool(planes, window),
                snn_or=jl.snn_or_pool(planes, window),
                snn_max=jl.snn_max_pool(planes, window))


def _eq(got: torch.Tensor, want):
    want = np.asarray(want)
    assert got.numpy().dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("hw,k,stride,padding", [
    ((9, 9), 3, 1, "SAME"), ((11, 10), 3, 2, "SAME"),
    ((12, 7), 5, 1, "VALID"), ((13, 13), 3, 2, "VALID")])
def test_conv_twins(hw, k, stride, padding):
    rng = np.random.default_rng(hash((hw, k, stride, padding)) % 2**32)
    x = _levels(rng, (2,) + hw + (5,))
    w = _weights(rng, (k, k, 5, 7))
    b = rng.integers(-40, 40, size=(7,)).astype(np.int32)
    want, want_snn = _jax_conv(jnp.asarray(x), jnp.asarray(w),
                               jnp.asarray(b), stride=stride, padding=padding)
    _eq(tl.q_conv2d(torch.from_numpy(x), torch.from_numpy(w),
                    torch.from_numpy(b), stride=stride, padding=padding), want)
    planes = tenc.encode(torch.from_numpy(x), T)
    got_snn = tl.snn_conv2d(planes, torch.from_numpy(w),
                            torch.from_numpy(b), stride=stride,
                            padding=padding)
    _eq(got_snn, want_snn)
    np.testing.assert_array_equal(got_snn.numpy(), np.asarray(want))


@pytest.mark.parametrize("m,f,g", [(1, 27, 10), (6, 120, 84), (5, 33, 13)])
def test_linear_twins(m, f, g):
    rng = np.random.default_rng(m * 1000 + f)
    x = _levels(rng, (m, f))
    w = _weights(rng, (f, g))
    b = rng.integers(-40, 40, size=(g,)).astype(np.int32)
    want, want_snn = _jax_linear(jnp.asarray(x), jnp.asarray(w),
                                 jnp.asarray(b))
    _eq(tl.q_linear(torch.from_numpy(x), torch.from_numpy(w),
                    torch.from_numpy(b)), want)
    _eq(tl.snn_linear(tenc.encode(torch.from_numpy(x), T),
                      torch.from_numpy(w), torch.from_numpy(b)), want_snn)


@pytest.mark.parametrize("num_steps", [3, 4, 8])
def test_requantize_and_fire(num_steps):
    rng = np.random.default_rng(num_steps)
    acc = rng.integers(-20000, 20000, size=(4, 33)).astype(np.int32)
    for mult in (np.float32(0.00731), rng.uniform(0, 0.02, 33).astype(
            np.float32)):
        want = jl.q_requantize(jnp.asarray(acc), num_steps, jnp.asarray(mult))
        _eq(tl.q_requantize(torch.from_numpy(acc), num_steps,
                            torch.from_numpy(np.asarray(mult))), want)
        _eq(tn.radix_fire(torch.from_numpy(acc), num_steps,
                          torch.from_numpy(np.asarray(mult))),
            jn.radix_fire(jnp.asarray(acc), num_steps, jnp.asarray(mult)))


def test_radix_membrane():
    rng = np.random.default_rng(7)
    cur = rng.integers(-300, 300, size=(6, 3, 11)).astype(np.int32)
    _eq(tn.radix_membrane(torch.from_numpy(cur)),
        jn.radix_membrane(jnp.asarray(cur)))


@pytest.mark.parametrize("bits", range(1, 11))
@pytest.mark.parametrize("window", [1, 2, 3])
def test_sum_pool_bits(bits, window):
    assert tl.sum_pool_bits(bits, window) == jl.sum_pool_bits(bits, window)


@pytest.mark.parametrize("hw,window", [((8, 8), 2), ((7, 9), 2),
                                       ((11, 10), 3), ((5, 5), 2)])
def test_pool_twins(hw, window):
    rng = np.random.default_rng(hw[0] * 31 + hw[1] + window)
    x = _levels(rng, (2,) + hw + (3,))
    wide = rng.integers(0, 1 << 10, size=x.shape).astype(np.int32)
    want = _jax_pools(jnp.asarray(x), jnp.asarray(wide), window=window)
    tx, twide = torch.from_numpy(x), torch.from_numpy(wide)
    _eq(tl.q_avg_pool(tx, window), want["avg"])
    _eq(tl.q_max_pool(tx, window), want["max"])
    _eq(tl.q_or_pool(tx, window), want["orp"])
    _eq(tl.q_or_pool(twide, window), want["wide_or"])
    _eq(tl.q_avg_pool(twide, window), want["wide_avg"])

    tp = tenc.encode(tx, T)
    _eq(tl.snn_avg_pool(tp, window), want["snn_avg"])
    _eq(tl.snn_or_pool(tp, window), want["snn_or"])
    _eq(tl.snn_max_pool(tp, window), want["snn_max"])
    # the spiking twins agree with the packed ones
    np.testing.assert_array_equal(
        tl.snn_max_pool(tp, window).numpy().astype(np.uint8),
        tl.q_max_pool(tx, window).numpy())
    np.testing.assert_array_equal(
        tenc.decode(tl.snn_or_pool(tp, window)).numpy(),
        tl.q_or_pool(tx, window).numpy().astype(np.int32))
