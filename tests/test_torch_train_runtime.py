"""The port's checkpoints, restart runner and gradient compression against
the JAX package (mirrors ``tests/test_runtime.py:31-59,163-200``).

* checkpoint round trip, atomicity (a ``.tmp`` directory is never the
  latest) and ``CheckpointManager``'s keep-last-k;
* the two packages' checkpoints are one format: for a tree of float32
  and int32 leaves with Adam and Adafactor states, each package restores
  what the other wrote (``array_equal``, the same keys), and both write
  the same manifest and byte-identical ``.npy`` files;
* bfloat16: the port writes the reference's bytes (descr ``'<V2'``) and
  restores the reference's file bit for bit; the reference's own
  ``restore`` of that file raises (numpy has no cast from ``'|V2'``);
* ``RestartableRun``: a fault at step 9 of 17, resumed from the step-8
  checkpoint, ends ``torch.equal`` to an uninterrupted run;
* compression: the roundtrip bound and compressed SGD against exact SGD
  (the reference's bars); ``quantize`` fed the reference's uniform draws
  equals the reference's ``compress`` and ``decompress`` (``array_equal``);
  ``wire_bytes`` and ``compression_ratio`` equal.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train import checkpoint as jckpt
from repro.train import compression as jcomp
from repro.train import optim as joptim
from repro_torch.runtime import FaultInjected, RestartableRun
from repro_torch.train import checkpoint as ckpt_lib
from repro_torch.train import compression, optim, tree


def _tiny_state(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"params": {"w": torch.randn((8, 4), generator=g),
                       "b": torch.zeros((4,))},
            "step": torch.tensor(7, dtype=torch.int32)}


def _bits(x) -> np.ndarray:
    """A leaf of either package as numpy; bfloat16 as its int16 bits."""
    if torch.is_tensor(x):
        return (x.view(torch.int16) if x.dtype == torch.bfloat16
                else x).numpy()
    x = np.asarray(x)
    return x.view(np.int16) if x.dtype.name == "bfloat16" else x


def _assert_trees_equal(got, want):
    gl, wl = tree.leaves(got), jax.tree.leaves(want)
    assert len(gl) == len(wl)
    for g, w in zip(gl, wl):
        g, w = _bits(g), _bits(w)
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


# ---------------------------------------------------------------------------
# Checkpointing.
# ---------------------------------------------------------------------------


def test_checkpoint_roundtrip(tmp_path):
    state = _tiny_state()
    ckpt_lib.save(str(tmp_path), 7, state, extra={"note": "x"})
    assert ckpt_lib.latest_step(str(tmp_path)) == 7
    restored, extra = ckpt_lib.restore(str(tmp_path), 7, _tiny_state(1))
    assert extra == {"note": "x"}
    _assert_trees_equal(restored, state)


def test_checkpoint_atomicity_tmp_never_latest(tmp_path):
    ckpt_lib.save(str(tmp_path), 3, _tiny_state())
    os.makedirs(tmp_path / "step_0000000009.tmp")      # simulated crash
    assert ckpt_lib.latest_step(str(tmp_path)) == 3


def test_manager_keeps_last_k(tmp_path):
    m = ckpt_lib.CheckpointManager(str(tmp_path), keep=2)
    state = _tiny_state()
    for s in (1, 2, 3, 4):
        m.save(s, state)
    m.wait()
    steps = sorted(int(d.split("_")[1]) for d in os.listdir(tmp_path)
                   if d.startswith("step_") and not d.endswith(".tmp"))
    assert steps == [3, 4]


def test_async_save_snapshots_at_call(tmp_path):
    state = _tiny_state()
    t = ckpt_lib.save_async(str(tmp_path), 1, state)
    state["params"]["b"].add_(5.0)                   # after the snapshot
    t.join(timeout=60)
    assert not t.is_alive()
    restored, _ = ckpt_lib.restore(str(tmp_path), 1, _tiny_state())
    assert torch.equal(restored["params"]["b"], torch.zeros(4))


_JTYPES = {optim.AdamState: joptim.AdamState,
           optim.AdafactorState: joptim.AdafactorState,
           optim._FactoredSlot: joptim._FactoredSlot}


def _to_jax(t):
    """A port state tree as the reference's: its NamedTuple types, the
    same leaf values."""
    if isinstance(t, dict):
        return {k: _to_jax(v) for k, v in t.items()}
    if type(t) in _JTYPES:
        return _JTYPES[type(t)](*(_to_jax(v) for v in t))
    if isinstance(t, tuple):
        return tuple(_to_jax(v) for v in t)
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
    return jnp.asarray(t.numpy())


def _cross_trees(momentum=0.9):
    """One state in both packages' types, leaf values equal: float32 and
    int32 leaves, an Adam state after one update and an Adafactor state
    (factored and unfactored slots, and with ``momentum`` a bf16 momentum)
    after one update."""
    rng = np.random.default_rng(0)
    p = {"w": torch.from_numpy(rng.standard_normal((6, 5)).astype(np.float32)),
         "b": torch.from_numpy(rng.standard_normal((5,)).astype(np.float32))}
    g = {k: torch.randn(v.shape, generator=torch.Generator().manual_seed(1))
         for k, v in p.items()}
    adam, fac = optim.adam(1e-2), optim.adafactor(1e-2, momentum=momentum)
    tstate = {"params": p,
              "adam": adam.update(g, adam.init(p), p)[1],
              "fac": fac.update(g, fac.init(p), p)[1],
              "tokens": torch.arange(12, dtype=torch.int32).reshape(3, 4),
              "step": torch.tensor(3, dtype=torch.int32)}
    return _to_jax(tstate), tstate


def test_port_restores_reference_checkpoint(tmp_path):
    jstate, tstate = _cross_trees()
    jckpt.save(str(tmp_path), 5, jstate, extra={"from": "jax"})
    like = tree.tree_map(torch.zeros_like, tstate)
    restored, extra = ckpt_lib.restore(str(tmp_path), 5, like)
    assert extra == {"from": "jax"}
    _assert_trees_equal(restored, jstate)
    assert isinstance(restored["fac"], optim.AdafactorState)


def test_reference_restores_port_checkpoint(tmp_path):
    # no bf16 momentum: the reference cannot restore a bf16 leaf
    # (test_bf16_checkpoint_across_packages)
    jstate, tstate = _cross_trees(momentum=None)
    ckpt_lib.save(str(tmp_path), 5, tstate)
    like = jax.tree.map(jnp.zeros_like, jstate)
    restored, _ = jckpt.restore(str(tmp_path), 5, like)
    _assert_trees_equal(tstate, restored)


def test_checkpoints_are_byte_identical(tmp_path):
    jstate, tstate = _cross_trees()
    jdir = jckpt.save(str(tmp_path / "j"), 2, jstate, extra={"a": 1})
    tdir = ckpt_lib.save(str(tmp_path / "t"), 2, tstate, extra={"a": 1})
    assert sorted(os.listdir(jdir)) == sorted(os.listdir(tdir))
    for name in os.listdir(jdir):
        with open(os.path.join(jdir, name), "rb") as a, \
                open(os.path.join(tdir, name), "rb") as b:
            assert a.read() == b.read(), name
    keys = [leaf["key"] for leaf in
            json.load(open(os.path.join(tdir, "manifest.json")))["leaves"]]
    assert "fac__slots__w__vr" in keys and "adam__nu__b" in keys


def test_bf16_checkpoint_across_packages(tmp_path):
    rng = np.random.default_rng(1)
    w = rng.standard_normal((4, 6)).astype(np.float32)
    jstate = {"w": jnp.asarray(w, jnp.bfloat16), "s": jnp.ones((2,))}
    tstate = {"w": torch.from_numpy(w).to(torch.bfloat16),
              "s": torch.ones((2,))}
    jdir = jckpt.save(str(tmp_path / "j"), 1, jstate)
    tdir = ckpt_lib.save(str(tmp_path / "t"), 1, tstate)
    for name in ("w.npy", "manifest.json"):
        with open(os.path.join(jdir, name), "rb") as a, \
                open(os.path.join(tdir, name), "rb") as b:
            assert a.read() == b.read(), name
    like = {"w": torch.zeros((4, 6), dtype=torch.bfloat16),
            "s": torch.zeros(2)}
    got, _ = ckpt_lib.restore(str(tmp_path / "j"), 1, like)
    assert got["w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        got["w"].view(torch.int16).numpy(),
        np.asarray(jstate["w"]).view(np.int16))
    # the reference cannot read its own bf16 leaf back
    with pytest.raises(ValueError, match="No cast function"):
        jckpt.restore(str(tmp_path / "j"), 1, jstate)


# ---------------------------------------------------------------------------
# Restart.
# ---------------------------------------------------------------------------


def test_restart_bit_identical(tmp_path):
    """Fault at an arbitrary step, resume, final state == uninterrupted."""
    opt = optim.adam(1e-2)
    params0 = {"w": torch.ones((4, 4)), "b": torch.zeros((4,))}

    def batch_fn(step):
        return torch.randn((8, 4), generator=torch.Generator().manual_seed(
            step))

    def step_fn(state, x):
        p = tree.tree_map(lambda t: t.detach().requires_grad_(True),
                          state["params"])
        loss = torch.mean((x @ p["w"] + p["b"]) ** 2)
        g = tree.unflatten(p, torch.autograd.grad(loss, tree.leaves(p)))
        upd, opt_s = opt.update(g, state["opt"], state["params"])
        return {"params": optim.apply_updates(state["params"], upd),
                "opt": opt_s}, None

    def fresh():
        return {"params": params0, "opt": opt.init(params0)}

    run = RestartableRun(step_fn, batch_fn, str(tmp_path / "ref"),
                         ckpt_every=4)
    ref_state, _ = run.run(fresh(), steps=17)

    run2 = RestartableRun(step_fn, batch_fn, str(tmp_path / "crash"),
                          ckpt_every=4)
    with pytest.raises(FaultInjected):
        run2.run(fresh(), steps=17, fault_at=9)
    assert ckpt_lib.latest_step(str(tmp_path / "crash")) == 8
    resumed, _ = run2.run(fresh(), steps=17)           # restart from ckpt 8
    for a, b in zip(tree.leaves(ref_state), tree.leaves(resumed)):
        assert torch.equal(a, b)
    assert int(resumed["opt"].step) == 17


# ---------------------------------------------------------------------------
# Gradient compression.
# ---------------------------------------------------------------------------


def test_compression_roundtrip_shapes_and_bound():
    g = torch.randn((33, 7), generator=torch.Generator().manual_seed(0)) * 3.0
    payload, meta = compression.compress(
        g, 4, block=16, generator=torch.Generator().manual_seed(1))
    back = compression.decompress(payload, meta, 4)
    assert back.shape == g.shape
    # per-block max error <= scale/levels (stochastic rounding, 1 ulp)
    assert float((back - g).abs().max()) <= float(g.abs().max()) / 15 + 1e-5


@pytest.mark.parametrize("shape,block,steps", [((33, 7), 16, 4),
                                                ((5, 8, 3), 256, 3),
                                                ((64,), 8, 8)])
def test_quantize_matches_reference(shape, block, steps):
    g = jax.random.normal(jax.random.PRNGKey(0), shape) * 3.0
    key = jax.random.PRNGKey(1)
    (wsign, wq, wscale), wmeta = jcomp.compress(g, steps, block, key)
    n_blocks = -(-int(np.prod(shape)) // block)
    u = torch.from_numpy(np.array(jax.random.uniform(key, (n_blocks,
                                                            block))))
    tg = torch.from_numpy(np.array(g))
    (sign, q, scale), meta = compression.quantize(tg, steps, block, u)
    for a, b in ((sign, wsign), (q, wq), (scale, wscale)):
        assert a.numpy().dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert meta == (tuple(wmeta[0]), wmeta[1])
    np.testing.assert_array_equal(
        compression.decompress((sign, q, scale), meta, steps).numpy(),
        np.asarray(jcomp.decompress((wsign, wq, wscale), wmeta, steps)))


def test_compressed_sgd_matches_exact_on_quadratic():
    """Error feedback: compressed-gradient SGD converges to the same
    optimum as exact SGD on a strongly convex quadratic."""
    a = torch.diag(torch.tensor([1.0, 0.5, 2.0, 0.25]))
    b = torch.tensor([1.0, -2.0, 0.5, 3.0])
    x_star = torch.linalg.solve(a, b)
    comp = compression.RadixCompressor(num_steps=4, block=4)
    gen = torch.Generator().manual_seed(0)

    def grad(x):
        return a @ x - b

    x_exact = torch.zeros(4)
    x_comp = torch.zeros(4)
    ef = comp.init(x_comp)
    for _ in range(300):
        x_exact = x_exact - 0.3 * grad(x_exact)
        g_hat, ef = comp.roundtrip(grad(x_comp), ef, gen)
        x_comp = x_comp - 0.3 * g_hat
    assert float(torch.linalg.norm(x_exact - x_star)) < 1e-3
    assert float(torch.linalg.norm(x_comp - x_star)) < 1e-2
    assert compression.RadixCompressor(4, 256).compression_ratio() > 6.0


@pytest.mark.parametrize("numel,steps,block", [(231, 4, 16), (4096, 4, 256),
                                               (1000, 8, 64)])
def test_wire_bytes_and_ratio_match_reference(numel, steps, block):
    assert compression.wire_bytes(numel, steps, block) == \
        jcomp.wire_bytes(numel, steps, block)
    assert compression.RadixCompressor(steps, block).compression_ratio() == \
        jcomp.RadixCompressor(steps, block).compression_ratio()
