"""ZeRO-3 over the data axes in the port's sharded train step, and the
vocab-parallel loss, over 4 gloo ranks against the reference.

One world of 4 spawned ranks serves the module (``_torch_dist``).  The
reference runs in this process, on one device, at the bars of
``tests/test_torch_mesh.py``'s ``test_sharded_train_matches_single_device``
(5e-4 relative dense, 5e-2 MoE):

* Gemma-2B SMOKE (a tied head whose vocab splits over 'model'), adafactor
  and adam, 2 steps on (4, 1), (2, 2) and (1, 2, 2) ('pod', 'data',
  'model'), and with ``grad_accum`` 2, against the reference's
  single-device ``make_train_step`` and the port's; Grok-1 SMOKE through
  the ``ep_a2a`` and ``ref`` dispatches;
* the step's structure: each data-axis gather is one layer's piece (or a
  top-level leaf), never a stack; no parameter leaf is gathered at the
  step's start; the optimizer gets each gradient and Adam slot at its
  piece's shape; the new state keeps every leaf's placement; the loss
  never holds whole-vocab logits;
* the vocab-parallel cross-entropy against the whole-logit one: ties of
  the maximum across ranks, and ``loss_fn`` on the same pieces with and
  without softcap (ce, acc and the head's gradient).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist
from repro.configs import get_config as jget
from repro.lm import model as jmodel
from repro.train import optim as joptim
from repro_torch.configs import get_config as tget
from repro_torch.lm import model as tmodel
from repro_torch.train import optim as toptim

LR = 1e-3
STEPS = 2


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    w = _torch_dist.World(4, str(tmp_path_factory.mktemp("world")))
    yield w
    w.close()


def _tokens(arch):
    return np.random.default_rng(1).integers(
        0, tget(arch, smoke=True).vocab, (8, 17)).astype(np.int64)


def _cfgs(arch, cfg_kw):
    """The reference's single-device config and the port's
    (``_torch_dist.fsdp_cfg``; no MoE dispatch is named: one device runs
    ``ref``)."""
    tcfg = _torch_dist.fsdp_cfg(arch, cfg_kw)
    jcfg = dataclasses.replace(jget(arch, smoke=True), seq_shard=True,
                               **cfg_kw)
    if jcfg.moe is not None:
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
            jcfg.moe, capacity_factor=8.0))
    return jcfg, tcfg


@functools.lru_cache(maxsize=None)
def _single_device_losses(arch, opt_name, cfg_items):
    """(reference's, port's) (loss, grad_norm) of ``STEPS`` single-device
    steps (the optimizers are blind to a gradient's scale: the norm is
    not)."""
    jcfg, tcfg = _cfgs(arch, dict(cfg_items))
    tokens = _tokens(arch)
    params = tmodel.init_params(torch.Generator().manual_seed(0), tcfg)
    jp = jax.tree.map(jnp.asarray, tmodel.tree_map(lambda t: t.numpy(),
                                                   params))
    jopt = joptim.adam(LR) if opt_name == "adam" else joptim.adafactor(LR)
    topt = _torch_dist.fsdp_opt(opt_name, LR)
    st = {"params": jp, "opt": jopt.init(jp), "step": jnp.zeros((), jnp.int32)}
    jstep = jax.jit(jmodel.make_train_step(jcfg, None, jopt))
    ts = {"params": params, "opt": topt.init(params),
          "step": torch.zeros((), dtype=torch.int32)}
    tstep = tmodel.make_train_step(tcfg, topt)
    jl, tl = [], []
    for _ in range(STEPS):
        st, m = jstep(st, {"tokens": jnp.asarray(tokens)})
        jl.append((float(m["loss"]), float(m["grad_norm"])))
        ts, m = tstep(ts, {"tokens": torch.from_numpy(tokens)})
        tl.append((float(m["loss"]), float(m["grad_norm"])))
    return tuple(jl), tuple(tl)


def _check_losses(res, arch, opt_name, cfg_kw, tol):
    one = {k: v for k, v in cfg_kw.items() if k != "moe_impl"}
    jl, tl = _single_device_losses(arch, opt_name, tuple(sorted(one.items())))
    for losses, bad in res:
        assert not bad, bad
        assert losses == res[0][0]                   # every rank the same
        for want in (jl, tl):
            for got, w in zip(np.ravel(losses), np.ravel(want)):
                assert abs(got - w) <= tol * max(1.0, abs(w)), \
                    (losses, jl, tl)


MESHES = {"4x1": ((4, 1), ("data", "model")),
          "2x2": ((2, 2), ("data", "model")),
          "1x2x2": ((1, 2, 2), ("pod", "data", "model"))}


@pytest.mark.parametrize("opt_name", ["adafactor", "adam"])
@pytest.mark.parametrize("mesh", list(MESHES))
def test_zero3_train_matches_single_device(world, mesh, opt_name):
    shape, axes = MESHES[mesh]
    res = world.run("fsdp_case", "gemma_2b", shape, axes, _tokens("gemma_2b"),
                    STEPS, LR, opt_name, {})
    _check_losses(res, "gemma_2b", opt_name, {}, 5e-4)


def test_zero3_grad_accum(world):
    """``grad_accum`` 2: the pieces' gradients summed in float32 over the
    microbatches."""
    kw = {"grad_accum": 2}
    res = world.run("fsdp_case", "gemma_2b", (2, 2), ("data", "model"),
                    _tokens("gemma_2b"), STEPS, LR, "adafactor", kw)
    _check_losses(res, "gemma_2b", "adafactor", kw, 5e-4)


@pytest.mark.parametrize("impl", ["ep_a2a", "ref"])
def test_zero3_moe(world, impl):
    """Grok-1 through ``ep_a2a`` (each rank's experts gathered over the
    data axes per layer, their gradients reduce-scattered back) and
    through ``ref`` (every expert on every token: the rank's experts
    joined over 'model' first)."""
    kw = {"moe_impl": impl}
    res = world.run("fsdp_case", "grok_1_314b", (2, 2), ("data", "model"),
                    _tokens("grok_1_314b"), STEPS, LR, "adafactor", kw)
    _check_losses(res, "grok_1_314b", "adafactor", kw, 5e-2)


@pytest.mark.parametrize("arch,opt_name", [("gemma_2b", "adam"),
                                           ("grok_1_314b", "adafactor")])
def test_zero3_step_structure(world, arch, opt_name):
    for seen in world.run("fsdp_structure_case", arch, (2, 2),
                          _tokens(arch), opt_name):
        allowed = {tuple(s) for s in seen["allowed"]}
        assert seen["gathers"], "no gather over the data axes"
        assert set(seen["gathers"]) <= allowed, (seen["gathers"], allowed)
        assert not set(seen["gathers"]) & set(seen["stack"])
        # each layer's pieces gathered in the forward and again in the
        # backward's recompute (remat)
        layer_shapes = [s for s in seen["gathers"] if s in allowed]
        assert len(layer_shapes) >= 2 * seen["layers"]
        assert seen["start"] == 0
        assert not seen["grads"], seen["grads"]
        assert not seen["slots"], seen["slots"]
        assert not seen["held"], seen["held"]
        assert seen["logits"] and all(
            s[-1] == seen["vocab"] // 2 for s in seen["logits"]), \
            seen["logits"]


def test_vocab_parallel_ce_ties_across_ranks(world):
    """Each row's maximum stands twice, in two ranks' columns (and once
    within a rank): the argmax takes the lowest index, as ``argmax``; the
    labels name the lower copy in half the rows, so acc is 0.5."""
    rng = np.random.default_rng(3)
    b, s, v = 4, 6, 64                       # 16 columns a rank on (1, 4)
    lg = rng.standard_normal((b, s, v)).astype(np.float32)
    lab = np.zeros((b, s), np.int64)
    for i in range(b):
        for j in range(s):
            lo, hi = sorted(rng.choice(v, 2, replace=False))
            lg[i, j, lo] = lg[i, j, hi] = 9.0
            lab[i, j] = lo if (i + j) % 2 == 0 else hi
    for shape in ((1, 4), (2, 2)):
        for ce, acc, g, w_ce, w_acc, w_g in world.run("vocab_ce_case",
                                                      shape, lg, lab):
            assert acc == w_acc == 0.5
            np.testing.assert_allclose(ce, w_ce, rtol=1e-6)
            np.testing.assert_allclose(g, w_g, rtol=1e-5, atol=1e-8)


@pytest.mark.parametrize("softcap", [None, 30.0], ids=["plain", "softcap"])
def test_vocab_parallel_loss_matches_whole_logits(world, softcap):
    kw = {} if softcap is None else {"logit_softcap": softcap}
    for split, ((ce, acc, g), (w_ce, w_acc, w_g)) in world.run(
            "vocab_loss_case", (2, 2), _tokens("gemma_2b"), kw):
        assert split
        assert acc == w_acc
        np.testing.assert_allclose(ce, w_ce, rtol=1e-6)
        np.testing.assert_allclose(g, w_g, rtol=1e-4, atol=1e-7)
