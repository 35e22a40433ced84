"""The port's data pipeline, optimizers and ANN trainer against the JAX
package (mirrors ``tests/test_data_train.py``, all but its
``ShardedLoader`` case, which waits for multi-GPU).

* ``SyntheticVision`` batches and calibration batches ``array_equal`` to
  the reference's, a 224 x 224 x 3, 100-class batch included;
  ``Prefetcher`` order and error surfacing;
* every optimizer (sgd plain, with momentum and Nesterov; adam with
  weight decay; adafactor with and without bf16 momentum) over float32
  and bfloat16 leaves: 5 updates from the same params and gradients
  match the reference's params and state at rtol 1e-6 (with a floor of
  1e-6 of each leaf's largest magnitude for elements near zero);
* ``train/tree.py`` visits leaves in ``jax.tree.leaves`` order and names
  their paths as ``tree_flatten_with_path`` does; ``clip_by_global_norm``
  matches, dtypes included (a bf16 gradient clips to float32, as JAX
  promotes it);
* the reference's quadratic-convergence, factored-state and clip cases;
* ``train_ann`` on half-width LeNet-5 from carried weights matches the
  reference's after 5 steps (relative L2 per leaf at most 1e-5; the two
  packages' float convolutions round differently), and learns the task
  (accuracy > 0.8 after 150 steps, the reference's bar).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.synthetic import SyntheticVision as JVision
from repro.models import lenet as jlenet
from repro.train import optim as joptim
from repro.train import trainer as jtrainer
from repro_torch import carry
from repro_torch.data import Prefetcher, SyntheticVision, synthetic_tokens
from repro_torch.train import optim, tree
from repro_torch.train.trainer import TrainConfig, evaluate_ann, train_ann

BF16 = {"float32": (np.float32, jnp.float32, torch.float32),
        "bfloat16": (np.float32, jnp.bfloat16, torch.bfloat16)}


def _np(x):
    if torch.is_tensor(x):
        return x.detach().to(torch.float64 if x.is_floating_point()
                             else x.dtype).numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float64)
                      if jnp.issubdtype(x.dtype, jnp.floating) else x)


# ---------------------------------------------------------------------------
# Data.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw,step,n", [
    ({}, 17, 8),
    ({"noise": 0.3, "seed": 5}, 0, 4),
    ({"input_hw": (224, 224, 3), "num_classes": 100}, 3, 2),
])
def test_synthetic_vision_matches_reference(kw, step, n):
    got, want = SyntheticVision(**kw), JVision(**kw)
    for a, b in zip(got.batch(step, n), want.batch(step, n)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got.calibration_batch(3),
                                  want.calibration_batch(3))


def test_synthetic_vision_deterministic_and_restartable():
    data = SyntheticVision()
    x1, y1 = data.batch(17, 8)
    x2, y2 = data.batch(17, 8)
    np.testing.assert_array_equal(x1, x2)
    np.testing.assert_array_equal(y1, y2)
    assert not np.array_equal(x1, data.batch(18, 8)[0])
    assert x1.min() >= 0.0 and x1.max() <= 1.0


def test_prefetcher_yields_steps_in_order():
    seen = []
    for s, tok in Prefetcher(lambda s: synthetic_tokens(s, 8, 16, 128),
                             start_step=3, num_steps=4, depth=2):
        np.testing.assert_array_equal(tok, synthetic_tokens(s, 8, 16, 128))
        seen.append(s)
    assert seen == [3, 4, 5, 6]


def test_prefetcher_surfaces_worker_errors():
    def bad(step):
        if step == 2:
            raise ValueError("boom")
        return step

    it = Prefetcher(bad, 0, 4, depth=1)
    with pytest.raises(ValueError, match="boom"):
        list(it)


# ---------------------------------------------------------------------------
# Optimizers.
# ---------------------------------------------------------------------------

OPTS = {
    "sgd": lambda m: m.sgd(0.1),
    "sgd_momentum": lambda m: m.sgd(0.1, momentum=0.9),
    "sgd_nesterov": lambda m: m.sgd(0.05, momentum=0.9, nesterov=True),
    "adam_wd": lambda m: m.adam(1e-2, weight_decay=1e-2),
    "adafactor": lambda m: m.adafactor(1e-2),
    "adafactor_bf16_momentum": lambda m: m.adafactor(1e-2, momentum=0.9),
}
SHAPES = {"w": (16, 24), "b": (24,), "layers": {"stack": (3, 8, 5),
                                                "row": (1, 7)}}


def _draw(rng, shapes):
    if isinstance(shapes, dict):
        return {k: _draw(rng, v) for k, v in shapes.items()}
    return rng.standard_normal(shapes).astype(np.float32)


def _both(tree_np, dtype):
    _, jdt, tdt = BF16[dtype]
    j = jax.tree.map(lambda a: jnp.asarray(a, jdt), tree_np)
    t = jax.tree.map(lambda a: torch.from_numpy(a).to(tdt), tree_np)
    return j, t


def _assert_trees_close(got, want, rtol):
    """Leaf for leaf, dtypes equal, values to ``rtol`` with an absolute
    floor of ``rtol`` times the leaf's largest magnitude (an element near
    zero takes one-ulp differences of its update, whose reductions sum in
    another order in the two packages)."""
    gl, wl = tree.leaves(got), jax.tree.leaves(want)
    assert len(gl) == len(wl)
    for g, w in zip(gl, wl):
        assert tuple(g.shape) == tuple(w.shape)
        assert str(g.dtype).removeprefix("torch.") == str(w.dtype)
        w = _np(w)
        np.testing.assert_allclose(_np(g), w, rtol=rtol,
                                   atol=rtol * np.abs(w).max(initial=0))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(OPTS))
def test_optimizer_matches_reference(name, dtype):
    rng = np.random.default_rng(0)
    jp, tp = _both(_draw(rng, SHAPES), dtype)
    jopt, topt = OPTS[name](joptim), OPTS[name](optim)
    js, ts = jopt.init(jp), topt.init(tp)
    _assert_trees_close(ts, js, 0)
    for _ in range(5):
        jg, tg = _both(_draw(rng, SHAPES), dtype)
        ju, js = jopt.update(jg, js, jp)
        tu, ts = topt.update(tg, ts, tp)
        jp, tp = joptim.apply_updates(jp, ju), optim.apply_updates(tp, tu)
        _assert_trees_close(tp, jp, 1e-6)
    _assert_trees_close(ts, js, 1e-6)


def test_tree_order_and_paths_match_jax():
    state = {"z": np.zeros(1), "a": joptim.AdamState(np.int32(0), {
        "k": np.ones(2), "b": (np.ones(3), None, ())}, ()), "m": [None]}
    want = jax.tree_util.tree_flatten_with_path(state)[0]
    tstate = {"z": torch.zeros(1), "a": optim.AdamState(
        torch.tensor(0, dtype=torch.int32), {
            "k": torch.ones(2), "b": (torch.ones(3), None, ())}, ()),
        "m": [None]}
    got = list(tree.leaves_with_paths(tstate))
    assert [p for p, _ in got] == [
        tuple(getattr(k, "key", getattr(k, "idx", getattr(k, "name", None)))
              for k in path) for path, _ in want]
    assert [tuple(leaf.shape) for _, leaf in got] == [
        np.shape(leaf) for _, leaf in want]
    again = tree.unflatten(tstate, tree.leaves(tstate))
    assert type(again["a"]) is optim.AdamState and again["a"].mu["b"][1:] \
        == (None, ())


def test_clip_by_global_norm_matches_reference():
    rng = np.random.default_rng(3)
    g = _draw(rng, SHAPES)
    jg = jax.tree.map(jnp.asarray, g)
    jg["b"] = jg["b"].astype(jnp.bfloat16) * 40
    tg = jax.tree.map(torch.from_numpy, g)
    tg["b"] = tg["b"].to(torch.bfloat16) * 40
    (jc, jn), (tc, tn) = (joptim.clip_by_global_norm(jg, 1.0),
                          optim.clip_by_global_norm(tg, 1.0))
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    _assert_trees_close(tc, jc, 1e-6)
    assert tc["b"].dtype == torch.float32
    np.testing.assert_allclose(float(optim.global_norm(tg)),
                               float(joptim.global_norm(jg)), rtol=1e-6)


def _quad_losses(opt, steps=200):
    a = torch.diag(torch.tensor([2.0, 0.5, 1.0]))
    b = torch.tensor([1.0, -1.0, 2.0])
    x = {"x": torch.zeros(3)}
    state = opt.init(x)
    for _ in range(steps):
        g = {"x": a @ x["x"] - b}
        upd, state = opt.update(g, state, x)
        x = optim.apply_updates(x, upd)
    return float(torch.linalg.norm(a @ x["x"] - b))


@pytest.mark.parametrize("opt,thresh", [
    (optim.sgd(0.3, momentum=0.9), 1e-4),
    (optim.adam(0.1), 1e-3),
    (optim.adafactor(0.1), 2e-2),
])
def test_optimizers_converge_on_quadratic(opt, thresh):
    assert _quad_losses(opt) < thresh


def test_adafactor_factored_state_is_small():
    state = optim.adafactor(1e-3).init({"w": torch.zeros((256, 512))})
    slot = state.slots["w"]
    assert slot.vr.shape == (256,) and slot.vc.shape == (512,)


def test_clip_by_global_norm():
    g = {"a": torch.full((4,), 10.0)}
    clipped, norm = optim.clip_by_global_norm(g, 1.0)
    assert float(norm) == pytest.approx(20.0)
    assert float(optim.global_norm(clipped)) == pytest.approx(1.0, rel=1e-5)


# ---------------------------------------------------------------------------
# ANN trainer.
# ---------------------------------------------------------------------------


def _rel_l2(got, want):
    got, want = _np(got), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def test_train_ann_matches_reference():
    static, jparams, _ = jlenet.make(width_mult=0.5)
    cfg = TrainConfig(steps=5, batch_size=32, lr=1e-2, log_every=1000)
    want, wm = jtrainer.train_ann(static, jparams, JVision(), cfg, log=None)
    got, gm = train_ann(static, carry.float_params_from_numpy(
        jax.tree.map(np.asarray, jparams)), SyntheticVision(), cfg, log=None,
        device="cpu")
    assert [p is None for p in got] == [p is None for p in want]
    for g, w in zip(got, want):
        if w is not None:
            for k in ("w", "b"):
                assert _rel_l2(g[k], w[k]) <= 1e-5, k
    assert gm["loss"] == pytest.approx(wm["loss"], rel=1e-5)
    assert gm["acc"] == wm["acc"]


def test_train_ann_learns_synthetic_task():
    from repro_torch.models import lenet
    static, params, _ = lenet.make(width_mult=0.5)
    data = SyntheticVision()
    params, metrics = train_ann(static, params, data,
                                TrainConfig(steps=150, batch_size=64,
                                            lr=1e-2, log_every=1000),
                                log=None, device="cpu")
    acc = evaluate_ann(static, params, data, batches=2, device="cpu")
    assert acc > 0.8, acc           # well above 10% chance after 150 steps


def test_trainer_entry_points_need_cuda(monkeypatch):
    from repro_torch.models import lenet
    static, params, _ = lenet.make(width_mult=0.25)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_ann(static, params, SyntheticVision(), TrainConfig(steps=1))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        evaluate_ann(static, params, SyntheticVision())


@pytest.mark.parametrize("before", [
    (False, True, False, False, None), (True, False, True, True, ":16:8")],
    ids=["off", "on-warn"])
def test_train_ann_scopes_deterministic_kernels(before, monkeypatch):
    """``train_ann`` trains with cuDNN's deterministic algorithms,
    benchmarking off, ``torch.use_deterministic_algorithms`` and
    ``CUBLAS_WORKSPACE_CONFIG`` set, and leaves all of them as it found
    them."""
    import os

    from repro_torch.models import lenet

    cudnn = torch.backends.cudnn
    det, bench, algos, warn, env = before
    monkeypatch.setattr(cudnn, "deterministic", det)
    monkeypatch.setattr(cudnn, "benchmark", bench)
    if env is None:
        monkeypatch.delenv("CUBLAS_WORKSPACE_CONFIG", raising=False)
    else:
        monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", env)
    saved = (torch.are_deterministic_algorithms_enabled(),
             torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(algos, warn_only=warn)
    seen = []

    def log(_):
        seen.append((cudnn.deterministic, cudnn.benchmark,
                     torch.are_deterministic_algorithms_enabled(),
                     torch.is_deterministic_algorithms_warn_only_enabled(),
                     os.environ.get("CUBLAS_WORKSPACE_CONFIG")))

    try:
        static, params, _ = lenet.make(width_mult=0.25)
        train_ann(static, params, SyntheticVision(),
                  TrainConfig(steps=2, batch_size=8, log_every=1), log=log,
                  device="cpu")
        assert seen == [(True, False, True, False, env or ":4096:8")] * 2
        assert (cudnn.deterministic, cudnn.benchmark,
                torch.are_deterministic_algorithms_enabled(),
                torch.is_deterministic_algorithms_warn_only_enabled(),
                os.environ.get("CUBLAS_WORKSPACE_CONFIG")) == before
    finally:
        torch.use_deterministic_algorithms(*saved[:1], warn_only=saved[1])
