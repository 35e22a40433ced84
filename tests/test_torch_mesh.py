"""The port's mesh paths over 4 gloo ranks against the reference.

One world of 4 spawned ranks serves the whole module (``_torch_dist``;
its ranks import torch and ``repro_torch`` only).  The reference runs in
this process, on one device: the bars are its own
(``tests/test_moe.py``, ``tests/test_sharding.py``):

* the MoE mesh dispatches ``ep_psum`` / ``ep_a2a`` on (2, 2) and ``tp``
  (6 experts) on (1, 4) against the reference's dense ``_moe_ref`` at
  1e-5 under generous capacity; drops bounded at capacity factor 1.0;
  ``ep_a2a``'s gradients finite and nonzero;
* 3 sharded adafactor steps of GLM4-9B and Grok-1 (SMOKE, ``seq_shard``,
  MoE capacity 8.0) within 5e-4 (dense) / 5e-2 (MoE) of the reference's
  single-device loss and of the port's, every leaf's local piece the
  slice its spec gives;
* GLM4-9B prefill and decode over (2, 2) against the reference's at
  2e-4;
* ``launch.train.main(["--data", "2", "--model", "2", ...])``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist
from repro.configs import get_config as jget
from repro.lm import model as jmodel
from repro.lm import moe as jmoe
from repro.lm.config import MoEConfig as JMoEConfig
from repro.train import optim as joptim
from repro_torch.configs import get_config as tget
from repro_torch.launch import train as tlaunch
from repro_torch.lm import model as tmodel
from repro_torch.train import optim as toptim


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    w = _torch_dist.World(4, str(tmp_path_factory.mktemp("world")))
    yield w
    w.close()


# ---------------------------------------------------------------------------
# MoE dispatches.
# ---------------------------------------------------------------------------


def _moe_setup(num_experts=8, top_k=2, d=64, f=96, b=4, s=16, cf=8.0,
               impl="auto"):
    rng = np.random.default_rng(0)
    p = {"router": rng.standard_normal((d, num_experts)) * 0.1,
         "w_gate": rng.standard_normal((num_experts, d, f)) * 0.05,
         "w_up": rng.standard_normal((num_experts, d, f)) * 0.05,
         "w_down": rng.standard_normal((num_experts, f, d)) * 0.05}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    x = rng.standard_normal((b, s, d)).astype(np.float32)
    kw = dict(num_experts=num_experts, top_k=top_k, d=d, f=f, cf=cf,
              impl=impl)
    jcfg = dataclasses.replace(
        jget("kimi_k2_1t_a32b", smoke=True), d_model=d,
        moe=JMoEConfig(num_experts=num_experts, top_k=top_k, d_ff_expert=f,
                       capacity_factor=cf, impl=impl))
    y_ref, _ = jmoe._moe_ref(jnp.asarray(x), {k: jnp.asarray(v)
                                             for k, v in p.items()}, jcfg)
    return kw, p, x, np.asarray(y_ref)


def _assemble(results, data: int):
    """The global y from (data rank, local y, ...) per rank; the model
    ranks of one data group agree bit for bit."""
    by = {}
    for d, y, *_ in results:
        if d in by:
            np.testing.assert_array_equal(by[d], y)
        by[d] = y
    return np.concatenate([by[i] for i in range(data)])


@pytest.mark.parametrize("impl,shape,experts", [
    ("ep_psum", (2, 2), 8), ("ep_a2a", (2, 2), 8), ("tp", (1, 4), 6)])
def test_mesh_dispatch_matches_ref_generous_capacity(world, impl, shape,
                                                     experts):
    kw, p, x, y_ref = _moe_setup(num_experts=experts, impl=impl)
    res = world.run("moe_case", shape, kw, p, x)
    np.testing.assert_allclose(_assemble(res, shape[0]), y_ref, rtol=1e-5,
                               atol=1e-5)
    assert all(np.isfinite(aux) for _, _, aux, _ in res)
    assert len({aux for _, _, aux, _ in res}) == 1       # one value


def test_capacity_drops_bounded(world):
    kw, p, x, y_ref = _moe_setup(cf=1.0, impl="ep_psum")
    y = _assemble(world.run("moe_case", (2, 2), kw, p, x), 2)
    rel = np.linalg.norm(y - y_ref) / np.linalg.norm(y_ref)
    assert 0.0 < rel < 0.6, rel
    assert np.isfinite(y).all()


def test_grads_flow_through_a2a_dispatch(world):
    kw, p, x, _ = _moe_setup(impl="ep_a2a")
    for _, _, _, g in world.run("moe_case", (2, 2), kw, p, x, "both"):
        for k, v in g.items():
            assert np.isfinite(v).all(), k
            assert np.abs(v).max() > 0.0, k


def _jcfg(kw):
    return dataclasses.replace(
        jget("kimi_k2_1t_a32b", smoke=True), d_model=kw["d"],
        moe=JMoEConfig(num_experts=kw["num_experts"], top_k=kw["top_k"],
                       d_ff_expert=kw["f"], capacity_factor=kw["cf"],
                       impl="ref"))


def _group_grads(res, data: int):
    """Each data group's gradients (its model ranks agree to float
    rounding of their all-reduces), summed over the groups."""
    by = {}
    for d, _, _, g in res:
        if d in by:
            for k in g:
                np.testing.assert_allclose(g[k], by[d][k], rtol=1e-6,
                                           atol=1e-7)
        by[d] = g
    return {k: sum(by[i][k] for i in range(data)) for k in by[0]}


@pytest.mark.parametrize("impl,shape,experts", [
    ("ep_psum", (2, 2), 8), ("ep_a2a", (2, 2), 8), ("tp", (1, 4), 6)])
def test_mesh_dispatch_grads_match_ref(world, impl, shape, experts):
    """The collectives' gradients count the loss once per data group:
    summed over the groups, the gradients of sum(y^2) equal the dense
    ``_moe_ref``'s under generous capacity; averaged over them, those of
    the router loss equal the gradient of the mean over the shards'
    router losses (the reference's ``pmean``), the shards being the data
    rows, and under ``ep_a2a`` also the sequence slices over 'model'."""
    kw, p, x, _ = _moe_setup(num_experts=experts, impl=impl)
    jcfg, jp = _jcfg(kw), {k: jnp.asarray(v) for k, v in p.items()}
    data, model = shape

    def y2(q):
        return jnp.sum(jmoe._moe_ref(jnp.asarray(x), q, jcfg)[0] ** 2)

    def aux(q):
        rows = x.shape[0] // data
        cols = x.shape[1] // (model if impl == "ep_a2a" else 1)
        shards = [x[i * rows:(i + 1) * rows, j * cols:(j + 1) * cols]
                  for i in range(data) for j in range(x.shape[1] // cols)]
        losses = []
        for xs in shards:
            _, idx, probs = jmoe._router(
                jnp.asarray(xs).reshape(-1, x.shape[2]), q["router"],
                jcfg.moe)
            losses.append(jmoe.router_aux_loss(probs, idx, experts))
        return jnp.mean(jnp.stack(losses))

    for loss, fn, scale in (("y2", y2, 1.0), ("aux", aux, 1.0 / data)):
        got = _group_grads(world.run("moe_case", shape, kw, p, x, loss),
                           data)
        want = jax.grad(fn)(jp)
        for k in p:
            if loss == "aux" and k != "router":
                assert not got[k].any(), k           # experts: no aux path
                continue
            np.testing.assert_allclose(got[k] * scale, np.asarray(want[k]),
                                       rtol=1e-4, atol=1e-6, err_msg=k)


# ---------------------------------------------------------------------------
# Sharded train steps and decode.
# ---------------------------------------------------------------------------

LR = 1e-3


def _cfgs(arch):
    jcfg = dataclasses.replace(jget(arch, smoke=True), seq_shard=True)
    tcfg = dataclasses.replace(tget(arch, smoke=True), seq_shard=True)
    if jcfg.moe is not None:
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
            jcfg.moe, capacity_factor=8.0))
        tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(
            tcfg.moe, capacity_factor=8.0))
    return jcfg, tcfg


def _single_device_losses(arch, tokens, steps):
    """(reference's, port's) losses of ``steps`` adafactor steps."""
    jcfg, tcfg = _cfgs(arch)
    params = tmodel.init_params(torch.Generator().manual_seed(0), tcfg)
    weights = tmodel.tree_map(lambda t: t.numpy(), params)
    jopt, topt = joptim.adafactor(LR), toptim.adafactor(LR)
    jp = jax.tree.map(jnp.asarray, weights)
    st = {"params": jp, "opt": jopt.init(jp), "step": jnp.zeros((), jnp.int32)}
    jstep = jax.jit(jmodel.make_train_step(jcfg, None, jopt))
    ts = {"params": params, "opt": topt.init(params),
          "step": torch.zeros((), dtype=torch.int32)}
    tstep = tmodel.make_train_step(tcfg, topt)
    jl, tl = [], []
    for _ in range(steps):
        st, m = jstep(st, {"tokens": jnp.asarray(tokens)})
        jl.append(float(m["loss"]))
        ts, m = tstep(ts, {"tokens": torch.from_numpy(tokens)})
        tl.append(float(m["loss"]))
    return jl, tl


@pytest.mark.parametrize("arch,shape,axes", [
    ("glm4_9b", (2, 2), ("data", "model")),
    ("grok_1_314b", (2, 2), ("data", "model")),
    ("glm4_9b", (1, 2, 2), ("pod", "data", "model"))],
    ids=["glm4_9b", "grok_1_314b", "glm4_9b-pod"])
def test_sharded_train_matches_single_device(world, arch, shape, axes):
    """3 sharded adafactor steps against 3 single-device steps, the
    reference's and the port's, at the reference's bars."""
    tokens = np.random.default_rng(1).integers(
        0, tget(arch, smoke=True).vocab, (8, 17)).astype(np.int64)
    jl, tl = _single_device_losses(arch, tokens, 3)
    res = world.run("train_case", arch, shape, axes, tokens, 3, LR)
    tol = 5e-2 if tget(arch, smoke=True).moe is not None else 5e-4
    for losses, bad in res:
        assert not bad, bad
        assert losses == res[0][0]                   # every rank the same
        for want in (jl[-1], tl[-1]):
            assert abs(losses[-1] - want) <= tol * max(1.0, abs(want)), \
                (losses, jl, tl)


def test_sharded_decode_matches_single_device(world):
    cfg = jget("glm4_9b", smoke=True)
    params = tmodel.init_params(torch.Generator().manual_seed(0),
                                tget("glm4_9b", smoke=True))
    jp = jax.tree.map(jnp.asarray, tmodel.tree_map(lambda t: t.numpy(),
                                                   params))
    tok = np.random.default_rng(1).integers(0, cfg.vocab, (8, 9))
    last, caches = jmodel.prefill(jp, {"tokens": jnp.asarray(tok)}, cfg,
                                  None, max_len=16)
    lg, _ = jmodel.decode_step(jp, caches, jnp.asarray(tok[:, -1:]),
                               jnp.int32(8), cfg, None)
    for t_last, t_lg, bad in world.run("decode_case", "glm4_9b", (2, 2),
                                       tok, 8, 16):
        assert not bad, bad
        np.testing.assert_allclose(t_last, np.asarray(last), rtol=2e-4,
                                   atol=2e-4)
        np.testing.assert_allclose(t_lg, np.asarray(lg), rtol=2e-4,
                                   atol=2e-4)


def test_train_main_over_a_mesh(world, tmp_path):
    """``--data 2 --model 2`` on the 4-rank world: the losses of the
    single-device ``train_loop`` (5e-4), a checkpoint at the last step."""
    argv = ["--arch", "glm4_9b", "--smoke", "--data", "2", "--model", "2",
            "--steps", "3", "--seq", "16", "--batch", "8"]
    _, want = tlaunch.train_loop(tget("glm4_9b", smoke=True), steps=3,
                                 batch_size=8, seq_len=16, log=lambda s: None,
                                 device="cpu")
    for losses, step, newest in world.run("train_main_case",
                                          str(tmp_path), argv):
        assert (step, newest) == (3, 3)
        np.testing.assert_allclose(losses, want, rtol=5e-4, atol=5e-4)
