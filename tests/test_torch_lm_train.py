"""The port's LM training path against the JAX package, over every arch of
``LM_ARCHS`` at its SMOKE config (float32), on one set of numpy weights
(the port's ``init_params(Generator(0))``, with the reference's tree,
shapes and scales; ``carry.lm_params_from_numpy`` brings them to the
port, ``jnp.asarray`` to the reference) and one seeded numpy batch
(B = 2, S = 16: two attention chunks, past RecurrentGemma's window of 8).

* ``forward_train``: logits at the reference's bar (rtol = atol = 2e-4,
  ``tests/test_lm_archs.py``), labels equal, the MoE router loss to 1e-5;
  ``loss_fn`` and its metrics (ce, aux to 1e-5, acc equal);
* every gradient leaf against ``jax.value_and_grad`` of the reference's
  ``loss_fn``: relative L2 at most ``_grad_bar(arch)``: 1e-5 for the
  attention and MoE archs, 1e-4 for RecurrentGemma and RWKV-6, whose
  scans sum in another order (``tests/test_torch_lm_archs.py``);
* one ``make_train_step`` step with adam, and one with ``grad_accum=2``,
  against the reference's: loss and grad norm to 1e-4, every parameter
  leaf to 3e-4 relative L2 (an Adam step moves each element by about lr
  whatever its gradient's size, so elements whose gradients are near
  zero carry the gradients' float noise into the step);
* ``remat`` (and RWKV's ``rwkv_remat_chunk``) on and off give equal
  gradients (``torch.equal``);
* the mirror of ``test_train_step_reduces_loss``: the loss falls over 8
  adam steps on one repeated batch;
* ``launch.train.train_loop`` on Gemma-2B's SMOKE config: a run cut at
  step 6 and resumed from its checkpoint ends equal to an uninterrupted
  run; ``main`` refuses a device mesh.

The reference's side of each arch (forward, gradients, the two steps) is
computed once per arch and shared by its cases.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.lm import model as jmodel
from repro.train import optim as joptim
from repro_torch import carry, configs
from repro_torch.configs import get_config as tget
from repro_torch.launch import train as tlaunch
from repro_torch.lm import model as tmodel
from repro_torch.train import optim, tree

ARCHS = configs.LM_ARCHS
B, S = 2, 16
LR = 3e-3
RECURRENT = ("recurrentgemma_2b", "rwkv6_3b")


def _grad_bar(arch):
    return 1e-4 if arch in RECURRENT else 1e-5


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    den = np.linalg.norm(want)
    if den == 0:
        return float(np.linalg.norm(got))
    return float(np.linalg.norm(got - want) / den)


def _np_batch(cfg, seed=1):
    rng = np.random.default_rng(seed)
    if cfg.embedding_inputs:
        batch = {"embeds": rng.normal(size=(B, S, cfg.d_model)).astype(
            np.float32), "labels": rng.integers(0, cfg.vocab, size=(B, S))}
    else:
        batch = {"tokens": rng.integers(0, cfg.vocab, size=(B, S + 1))}
    if cfg.encoder_layers:
        batch["enc_embeds"] = rng.normal(
            size=(B, cfg.encoder_ctx, cfg.d_model)).astype(np.float32)
    return batch


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _state(lib, params):
    opt = lib.adam(LR)
    zero = (torch.zeros((), dtype=torch.int32) if lib is optim
            else jnp.zeros((), jnp.int32))
    return {"params": params, "opt": opt.init(params), "step": zero}


_REF = {}


def _ref(arch):
    """The reference's side of ``arch``, computed once, in one compiled
    program: forward, loss, gradients, and the state after one adam step
    with ``grad_accum`` 1 and 2, from the numpy weights and batch."""
    if arch in _REF:
        return _REF[arch]
    cfg = jget(arch, smoke=True)
    weights = tmodel.tree_map(lambda t: t.numpy(), tmodel.init_params(
        torch.Generator().manual_seed(0), tget(arch, smoke=True)))
    nb = _np_batch(cfg)

    def run(p, b):
        fwd = jmodel.forward_train(p, b, cfg, None)
        vg = jax.value_and_grad(lambda q: jmodel.loss_fn(q, b, cfg, None),
                                has_aux=True)(p)
        steps = [jmodel.make_train_step(
            dataclasses.replace(cfg, grad_accum=a), None, joptim.adam(LR))(
                _state(joptim, p), b) for a in (1, 2)]
        return fwd, vg, steps

    (logits, labels, aux), ((loss, metrics), grads), steps = jax.jit(run)(
        jax.tree.map(jnp.asarray, weights),
        {k: jnp.asarray(v) for k, v in nb.items()})

    def host(m):
        return {k: float(v) for k, v in m.items()}

    _REF[arch] = dict(
        params=weights, batch=nb, logits=np.asarray(logits),
        labels=np.asarray(labels), aux=float(aux), loss=float(loss),
        metrics=host(metrics), grads=jax.tree.map(np.asarray, grads),
        steps={a: (jax.tree.map(np.asarray, st["params"]), host(m))
               for a, (st, m) in zip((1, 2), steps)})
    return _REF[arch]


def _port(arch, **kw):
    ref = _ref(arch)
    cfg = dataclasses.replace(tget(arch, smoke=True), **kw)
    return cfg, carry.lm_params_from_numpy(ref["params"], cfg), \
        _t(ref["batch"])


def _grads(cfg, params, batch):
    ps = tree.tree_map(lambda t: t.detach().requires_grad_(True), params)
    loss, metrics = tmodel.loss_fn(ps, batch, cfg)
    grads = torch.autograd.grad(loss, tree.leaves(ps), allow_unused=True,
                                materialize_grads=True)
    return loss, metrics, grads


def _paths(t):
    return [p for p, _ in tree.leaves_with_paths(t)]


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_train_and_loss_match_reference(arch):
    ref = _ref(arch)
    cfg, params, batch = _port(arch)
    with torch.no_grad():
        logits, labels, aux = tmodel.forward_train(params, batch, cfg)
        loss, metrics = tmodel.loss_fn(params, batch, cfg)
    assert tuple(logits.shape) == (B, S, cfg.vocab)
    np.testing.assert_allclose(logits.numpy(), ref["logits"], rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_array_equal(labels.numpy(), ref["labels"])
    assert float(aux) == pytest.approx(ref["aux"], rel=1e-5, abs=1e-7)
    assert float(loss) == pytest.approx(ref["loss"], rel=1e-5)
    assert float(metrics["ce"]) == pytest.approx(ref["metrics"]["ce"],
                                                 rel=1e-5)
    assert float(metrics["aux"]) == pytest.approx(ref["metrics"]["aux"],
                                                  rel=1e-5, abs=1e-7)
    assert float(metrics["acc"]) == ref["metrics"]["acc"]
    if cfg.moe is not None:
        assert float(aux) > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_gradients_match_reference(arch):
    ref = _ref(arch)
    cfg, params, batch = _port(arch)
    _, _, grads = _grads(cfg, params, batch)
    want = jax.tree_util.tree_flatten_with_path(ref["grads"])[0]
    assert len(grads) == len(want)
    for path, g, (_, w) in zip(_paths(params), grads, want):
        assert tuple(g.shape) == w.shape, path
        err = _rel_l2(g.numpy(), w)
        assert err <= _grad_bar(arch), (path, err)


@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference(arch, accum):
    ref = _ref(arch)
    cfg, params, batch = _port(arch, grad_accum=accum)
    step = tmodel.make_train_step(cfg, optim.adam(LR))
    state, metrics = step(_state(optim, params), batch)
    want_params, want_m = ref["steps"][accum]
    assert int(state["step"]) == 1
    assert float(metrics["loss"]) == pytest.approx(want_m["loss"], rel=1e-4)
    assert float(metrics["grad_norm"]) == pytest.approx(
        want_m["grad_norm"], rel=1e-4)
    assert set(metrics) == set(want_m)
    for path, p, w in zip(_paths(state["params"]),
                          tree.leaves(state["params"]),
                          jax.tree.leaves(want_params)):
        assert _rel_l2(p.numpy(), w) <= 3e-4, path


@pytest.mark.parametrize("arch", ["gemma_2b", "rwkv6_3b",
                                  "recurrentgemma_2b", "whisper_medium",
                                  "kimi_k2_1t_a32b"])
def test_remat_changes_no_gradient(arch):
    on, params, batch = _port(arch)
    assert on.remat
    off = dataclasses.replace(on, remat=False, rwkv_remat_chunk=False)
    _, _, g_on = _grads(on, params, batch)
    _, _, g_off = _grads(off, params, batch)
    for a, b in zip(g_on, g_off):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_reduces_loss(arch):
    cfg, params, batch = _port(arch)
    step = tmodel.make_train_step(cfg, optim.adam(LR))
    state = _state(optim, params)
    losses = []
    for _ in range(8):
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0], losses  # memorizes the repeated batch


def test_serving_builds_no_router_loss(monkeypatch):
    """Prefill and decode run the backbone without a loss: no ``aux``
    accumulator (a zeros tensor and one add a layer in train mode) is
    built, and the backbone hands back ``None`` for it."""
    cfg = tget("kimi_k2_1t_a32b", smoke=True)
    params = tmodel.init_params(torch.Generator().manual_seed(0), cfg)
    batch = {"tokens": torch.randint(0, cfg.vocab, (2, 9),
                                     generator=torch.Generator())}
    seen = []
    backbone = tmodel._backbone

    def spy(*args, **kw):
        out = backbone(*args, **kw)
        seen.append((args[4], out[1]))
        return out

    monkeypatch.setattr(tmodel, "_backbone", spy)
    _, caches = tmodel.prefill(params, batch, cfg, max_len=batch[
        "tokens"].shape[1] + 1)
    tmodel.decode_step(params, caches, batch["tokens"][:, -1:],
                       batch["tokens"].shape[1] - 1, cfg)
    tmodel.forward_train(params, batch, cfg)
    assert [m for m, _ in seen] == ["prefill", "decode", "train"]
    assert seen[0][1] is None and seen[1][1] is None
    assert torch.is_tensor(seen[2][1])


def test_train_loop_scopes_deterministic_kernels():
    """``train_loop`` runs with deterministic kernels and restores the
    process's settings."""
    before = torch.are_deterministic_algorithms_enabled()
    seen = []
    tlaunch.train_loop(tget("gemma_2b", smoke=True), steps=1, batch_size=2,
                       seq_len=8, device="cpu", log=lambda s: seen.append(
                           torch.are_deterministic_algorithms_enabled()))
    assert seen == [True]
    assert torch.are_deterministic_algorithms_enabled() == before


def test_train_loop_resumes_from_checkpoint(tmp_path):
    cfg = tget("gemma_2b", smoke=True)
    kw = dict(batch_size=2, seq_len=16, log=lambda s: None, device="cpu")
    full, hist = tlaunch.train_loop(cfg, steps=8, **kw)
    assert len(hist) == 8 and all(np.isfinite(hist))
    ck = str(tmp_path / "ck")
    _, first = tlaunch.train_loop(cfg, steps=6, ckpt_dir=ck, ckpt_every=3,
                                  **kw)
    logged = []
    resumed, second = tlaunch.train_loop(cfg, steps=8, ckpt_dir=ck,
                                         ckpt_every=3, log=logged.append,
                                         **{k: v for k, v in kw.items()
                                            if k != "log"})
    assert logged[0] == "[train] resumed from step 6"
    assert first + second == hist
    assert int(resumed["step"]) == 8
    for a, b in zip(tree.leaves(full), tree.leaves(resumed)):
        assert torch.equal(a, b)


def test_train_main_refuses_a_mesh():
    """A mesh needs a process group of its size: ``--data 2`` with none
    raises the port's mesh-size error, as the reference's mesh
    construction does without the devices (training over a world:
    ``tests/test_torch_mesh.py``)."""
    with pytest.raises(ValueError, match="needs a process group of 2"):
        tlaunch.main(["--arch", "gemma_2b", "--smoke", "--data", "2",
                      "--device", "cpu"])
