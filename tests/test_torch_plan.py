"""The port's compiled plans (CPU: the kernels' plain versions) against the
reference's kernels Executable and spike-plane oracle.

LeNet-5 (width 0.25, T=4, "or" and "avg" pools, both dataflows) is
converted by the reference and carried across; its plan must equal the
reference's kernels ``Executable`` (Pallas in interpret mode) and
``repro.api.oracle(mode="snn")``.  VGG-11 at ``SMOKE_KWARGS`` (channel
counts that are not multiples of 8, T=4, avg pool) is checked against the
oracle only: the reference's interpret-mode plan is slow at that depth.
Requests of 1, 3, 8 and 11 images run through buckets (1, 8), exercising
padding and chunking, and a second round must build no plan.  The
reference's oracle runs jitted: one XLA program per net instead of one
per eager op, with the same integer arithmetic.
"""

import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.core import conversion as jconv
from repro.core.encoding import RadixEncoding as JRadix
from repro.models import lenet as jlenet
from repro_torch import api, carry
from repro_torch.core import conversion as tconv
from repro_torch.models import vgg

T = 4
REQUESTS = (1, 3, 8, 11)
BUCKETS = (1, 8)


def _images(seed, hw, n=sum(REQUESTS)):
    return np.random.default_rng(seed).uniform(0, 1, (n,) + hw).astype(
        np.float32)


def _to_jax(tnet):
    """The port's net as the reference's QuantizedNet."""
    f = carry.qnet_to_numpy(tnet)
    qlayers = [None if qp is None else {
        k: None if qp[k] is None else jnp.asarray(qp[k])
        for k in ("w_q", "b_int", "mult")} for qp in f["qlayers"]]
    return jconv.QuantizedNet(
        static=f["static"], num_steps=f["num_steps"],
        weight_bits=f["weight_bits"], qlayers=qlayers,
        input_scale=f["input_scale"], logit_scale=f["logit_scale"],
        encoding=JRadix(f["num_steps"]))


def _jax_oracle(jnet, x):
    return np.asarray(jax.jit(
        lambda x: japi.oracle(jnet, x, mode="snn"))(jnp.asarray(x)))


def _serve(exe, x):
    """Requests of REQUESTS sizes, concatenated."""
    outs, off = [], 0
    for n in REQUESTS:
        outs.append(exe(torch.from_numpy(x[off:off + n])))
        off += n
    return torch.cat(outs).numpy()


def _check_rounds(exe, x, want):
    """Two rounds of requests equal ``want``; the second builds no plan."""
    got = _serve(exe, x)
    np.testing.assert_array_equal(got, want)
    stats = exe.stats()
    assert stats["compiles"] == len(BUCKETS)
    np.testing.assert_array_equal(_serve(exe, x), want)
    again = exe.stats()
    assert again["compiles"] == stats["compiles"]
    assert again["executions"] == 2 * stats["executions"]
    return got


@pytest.fixture(scope="module", params=["or", "avg"])
def lenet_net(request):
    static, params, hw = jlenet.make(jax.random.PRNGKey(5),
                                     pool_mode=request.param,
                                     width_mult=0.25)
    calib = _images(17, hw, 8)
    jnet = jconv.convert(static, params, jnp.asarray(calib), num_steps=T)
    tnet = carry.qnet_from_numpy(
        jnet.static,
        [None if qp is None else {k: None if qp[k] is None
                                  else np.asarray(qp[k])
                                  for k in ("w_q", "b_int", "mult")}
         for qp in jnet.qlayers],
        num_steps=T, weight_bits=jnet.weight_bits,
        input_scale=jnet.input_scale, logit_scale=jnet.logit_scale)
    x = _images(23, hw)
    return jnet, tnet, hw, x, _jax_oracle(jnet, x)


@pytest.mark.parametrize("dataflow", ["fused", "bitserial"])
def test_lenet_plan_matches_reference(lenet_net, dataflow):
    jnet, tnet, hw, x, want = lenet_net
    exe = api.Accelerator(dataflow=dataflow, device="cpu").compile(
        tnet, hw, buckets=BUCKETS)
    got = _check_rounds(exe, x, want)
    np.testing.assert_array_equal(
        api.oracle(tnet, torch.from_numpy(x), mode="snn").numpy(), want)
    np.testing.assert_array_equal(
        api.oracle(tnet, torch.from_numpy(x), mode="packed").numpy(), want)
    # the reference's kernels Executable: 6 images through bucket 4 (one
    # full chunk, one padded tail)
    jexe = japi.Accelerator(dataflow=dataflow).compile(jnet, hw, buckets=(4,))
    np.testing.assert_array_equal(got[:6], np.asarray(jexe(jnp.asarray(x[:6]))))


@pytest.fixture(scope="module")
def vgg_net():
    static, params, hw = vgg.make(np.random.default_rng(3), pool_mode="avg",
                                  **vgg.SMOKE_KWARGS)
    calib = torch.from_numpy(_images(4, hw, 8))
    tnet = tconv.convert(static, params, calib, num_steps=T)
    x = _images(29, hw)
    return tnet, hw, x, _jax_oracle(_to_jax(tnet), x)


@pytest.mark.parametrize("dataflow", ["fused", "bitserial"])
def test_vgg_smoke_plan_matches_oracle(vgg_net, dataflow):
    tnet, hw, x, want = vgg_net
    assert {qp["w_q"].shape[-1] % 8 for qp in tnet.qlayers
            if qp is not None} - {0}, "want channels off multiples of 8"
    exe = api.Accelerator(dataflow=dataflow, device="cpu").compile(
        tnet, hw, buckets=BUCKETS)
    _check_rounds(exe, x, want)


def test_stats_traffic_and_plane_counters(vgg_net):
    tnet, hw, x, _ = vgg_net
    exe = api.Accelerator(dataflow="bitserial", device="cpu").compile(
        tnet, hw, buckets=BUCKETS).warmup()
    stats = exe.stats()
    assert stats["compiles"] == 2 and stats["executions"] == 0
    assert stats["plane_passes_total"] == 0          # warmup is not counted
    exe(torch.from_numpy(x[:11]))                    # 8 + 3 padded to 8
    stats = exe.stats()
    assert stats["executions"] == 2 and stats["padded_rows"] == 5
    assert stats["hits"] == 2
    # avg-pool carry: the layers after a pool extract 6 planes, not 4
    per_call = exe.plan_for(8).plane_passes_per_call
    assert per_call == 11 * T + 5 * 2
    assert stats["plane_passes_total"] == 2 * per_call
    assert 0 <= stats["plane_passes_skipped"] <= stats["plane_passes_total"]
    assert len(stats["autotune"]["layers"]) == 2 * 11
    traffic = exe.traffic()
    dtypes = [l["out_dtype"] for l in traffic["layers"]]
    assert dtypes[-1] == "int32" and set(dtypes[:-1]) == {"uint8"}
    assert traffic["traffic_ratio"] >= 3.0


def test_compile_rejects_what_is_not_ported(vgg_net):
    tnet, hw, x, _ = vgg_net
    acc = api.Accelerator(device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        acc.compile(tnet, hw, parallel=2)
    # autotune is ported (kernels/autotune.py); the planner is not, and
    # autotune off the kernels backend is refused as the reference does
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        acc.compile(tnet, hw, auto={"objective": "latency"})
    with pytest.raises(ValueError, match="backend='kernels'"):
        api.Accelerator(backend="jnp", device="cpu").compile(
            tnet, hw, autotune=True)
    # the jnp backend is ported (the eager path); an unknown backend, or
    # a dataflow off the kernels backend, is refused
    assert api.Accelerator(backend="jnp").backend == "jnp"
    with pytest.raises(ValueError):
        api.Accelerator(backend="xla")
    with pytest.raises(ValueError):
        api.Accelerator(backend="jnp", dataflow="fused")
    with pytest.raises(ValueError):
        api.Accelerator(dataflow="rowwise", device="cpu").compile(tnet, hw)
    with pytest.raises(ValueError):
        acc.compile(tnet, hw, encoding=api.RadixEncoding(3))
    exe = acc.compile(tnet, hw, buckets=(2,))
    with pytest.raises(ValueError, match="item shape"):
        exe(torch.zeros((1, 16, 16, 3)))


def test_plans_die_with_their_net():
    static, params, hw = vgg.make(np.random.default_rng(0), pool_mode="or",
                                  **vgg.SMOKE_KWARGS)
    net = tconv.convert(static, params, torch.from_numpy(_images(1, hw, 2)),
                        num_steps=T)
    cache = api.engine.PlanCache((2,), device="cpu")
    cache.plan_for(net, 2, hw)
    assert len(cache) == 1
    del net
    gc.collect()
    assert cache.prune() == 1 and len(cache) == 0
