"""repro_torch.carry and repro_torch.core.conversion against repro.core.conversion.

First, a converted net carries across and back unchanged.  Second, the
port's own ``convert`` on the reference's float params (carried) and the
same calibration batch: ``w_q`` and ``b_int`` are equal; ``input_scale``,
``mult`` and ``logit_scale`` agree to ``rtol=1e-5``.  That tolerance is
needed because the float calibration forward (convs, matmuls, pool sums)
adds in another order in the two frameworks, which moves the percentile
scales by a few float32 ulps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import conversion as jconv
from repro.models import lenet as jlenet
from repro_torch import carry
from repro_torch.core import conversion as tconv
from repro_torch.core.encoding import RateEncoding

RTOL = 1e-5


def _jax_net(pool_mode, seed, *, biases):
    static, params, hw = jlenet.make(jax.random.PRNGKey(seed),
                                     pool_mode=pool_mode, width_mult=0.5)
    if biases:
        rng = np.random.default_rng(seed)
        params = [None if p is None else
                  {"w": p["w"], "b": jnp.asarray(rng.normal(
                      0, 0.05, p["b"].shape), jnp.float32)}
                  for p in params]
    calib = np.random.default_rng(seed + 1).uniform(
        0, 1, (6,) + hw).astype(np.float32)
    return static, params, calib


def _fields(qnet):
    if isinstance(qnet, tconv.QuantizedNet):
        return carry.qnet_to_numpy(qnet)
    return dict(
        static=qnet.static,
        qlayers=[None if qp is None else {
            k: None if qp[k] is None else np.asarray(qp[k])
            for k in ("w_q", "b_int", "mult")} for qp in qnet.qlayers],
        num_steps=qnet.num_steps, weight_bits=qnet.weight_bits,
        input_scale=qnet.input_scale,
        logit_scale=np.asarray(qnet.logit_scale) if np.ndim(
            qnet.logit_scale) else qnet.logit_scale,
        encoding=qnet.spec.name)


CASES = [("or", 4, 3, False, False), ("avg", 4, 3, True, False),
         ("avg", 3, 4, True, True), ("max", 6, 3, False, True)]


@pytest.fixture(scope="module", params=CASES,
                ids=lambda c: "-".join(map(str, c)))
def converted(request):
    pool, T, wbits, biases, per_channel = request.param
    static, params, calib = _jax_net(pool, T * 10 + wbits, biases=biases)
    jnet = jconv.convert(static, params, jnp.asarray(calib), num_steps=T,
                         weight_bits=wbits, per_channel=per_channel)
    tnet = tconv.convert(static, carry.float_params_from_numpy(params),
                         torch.from_numpy(calib), num_steps=T,
                         weight_bits=wbits, per_channel=per_channel)
    return _fields(jnet), tnet


def test_carry_round_trips(converted):
    want, _ = converted
    back = carry.qnet_to_numpy(carry.qnet_from_numpy(
        want["static"], want["qlayers"], num_steps=want["num_steps"],
        weight_bits=want["weight_bits"], input_scale=want["input_scale"],
        logit_scale=want["logit_scale"]))
    assert back["static"] == want["static"]
    for k in ("num_steps", "weight_bits", "input_scale", "encoding"):
        assert back[k] == want[k]
    np.testing.assert_array_equal(back["logit_scale"], want["logit_scale"])
    for b, w in zip(back["qlayers"], want["qlayers"]):
        assert (b is None) == (w is None)
        if w is None:
            continue
        for k in ("w_q", "b_int", "mult"):
            if w[k] is None:
                assert b[k] is None
            else:
                assert b[k].dtype == w[k].dtype
                np.testing.assert_array_equal(b[k], w[k])


def test_convert_matches_reference(converted):
    want, tnet = converted
    got = carry.qnet_to_numpy(tnet)
    assert got["static"] == want["static"]
    assert got["num_steps"] == want["num_steps"]
    np.testing.assert_allclose(got["input_scale"], want["input_scale"],
                               rtol=RTOL)
    np.testing.assert_allclose(got["logit_scale"], want["logit_scale"],
                               rtol=RTOL)
    for g, w in zip(got["qlayers"], want["qlayers"]):
        assert (g is None) == (w is None)
        if w is None:
            continue
        np.testing.assert_array_equal(g["w_q"], w["w_q"])
        np.testing.assert_array_equal(g["b_int"], w["b_int"])
        assert (g["mult"] is None) == (w["mult"] is None)
        if w["mult"] is not None:
            np.testing.assert_allclose(g["mult"], w["mult"], rtol=RTOL)


def test_float_forward_and_calibrate_match_reference():
    static, params, calib = _jax_net("avg", 3, biases=True)
    tparams = carry.float_params_from_numpy(params)
    want, want_acts = jconv.float_forward(static, params, jnp.asarray(calib),
                                          return_activations=True)
    got, got_acts = tconv.float_forward(static, tparams,
                                        torch.from_numpy(calib),
                                        return_activations=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=1e-5)
    for g, w in zip(got_acts, want_acts):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=1e-5)
    for pct in (99.9, 50.0, 100.0):
        np.testing.assert_allclose(
            tconv.calibrate(static, tparams, torch.from_numpy(calib), pct),
            jconv.calibrate(static, params, jnp.asarray(calib), pct),
            rtol=RTOL)


def test_percentile_matches_reference_on_exact_input():
    """On identical float32 input the sort-based percentile is the
    reference's, bit for bit (no forward in between)."""
    a = np.random.default_rng(0).gamma(2.0, 1.0, 100_003).astype(np.float32)
    for pct in (99.9, 99.0, 50.0, 0.1):
        want = float(jnp.percentile(jnp.asarray(a), pct))
        assert tconv._percentile(torch.from_numpy(a), pct) == want


def test_quantize_weights_matches_reference():
    w = np.random.default_rng(1).normal(0, 0.2, (5, 5, 3, 8)).astype(
        np.float32)
    for bits in (2, 3, 5):
        for per_channel in (False, True):
            tq, ts = tconv.quantize_weights(torch.from_numpy(w), bits,
                                            per_channel)
            jq, js = jconv.quantize_weights(jnp.asarray(w), bits,
                                            per_channel)
            np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
            np.testing.assert_array_equal(np.asarray(ts, np.float32),
                                          np.asarray(js, np.float32))


def test_convert_argument_errors():
    static, params, calib = _jax_net("or", 0, biases=False)
    tparams = carry.float_params_from_numpy(params)
    with pytest.raises(ValueError):
        tconv.convert(static, tparams, torch.from_numpy(calib))
    with pytest.raises(ValueError):
        tconv.convert(static, tparams, torch.from_numpy(calib), num_steps=3,
                      encoding=tconv.RadixEncoding(4))
    # every spec now carries across ("rate" did not before); an unknown
    # name, a spec with fields beside it, or a contradicting T is refused
    fields = dict(num_steps=4, weight_bits=3, input_scale=1.0,
                  logit_scale=1.0)
    rate = carry.qnet_from_numpy(static, [], encoding="rate", scale=2.0,
                                 **fields)
    assert rate.spec == RateEncoding(4, scale=2.0)
    with pytest.raises(ValueError):
        carry.qnet_from_numpy(static, [], encoding="delta", **fields)
    with pytest.raises(ValueError):
        carry.qnet_from_numpy(static, [], encoding=rate.spec, scale=2.0,
                              **fields)
    with pytest.raises(ValueError):
        carry.qnet_from_numpy(static, [], encoding=RateEncoding(5),
                              **fields)
