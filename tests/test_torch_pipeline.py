"""The port's ``parallel/pipeline.gpipe`` over 4 gloo ranks against the
reference's ``gpipe`` (``tests/test_pipeline.py``'s cases).

One world of 4 spawned ranks serves the module (``_torch_dist``).  The
reference runs in this process on ``(stages, 8 // stages)`` of the
session's 8 host devices; the port on ``(stages, 4 // stages)``
('pod', 'data') over the ranks.  Bars: the reference's own, 1e-6 for the
output and 1e-5 for the gradients of ``sum(out^2)``; the port's output
``torch.equal`` to its own sequential loop, on every rank.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import _torch_dist
from repro import compat
from repro.parallel.pipeline import gpipe as jgpipe


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    w = _torch_dist.World(4, str(tmp_path_factory.mktemp("world")))
    yield w
    w.close()


def _jblock(lp, x):
    return jnp.tanh(x @ lp["w"] + lp["b"])


def _setup(stages, n_micro, d=16, mb=4, seed=0):
    rng = np.random.default_rng(seed)
    L = 2 * stages
    p = {"w": (rng.standard_normal((L, d, d)) * 0.3).astype(np.float32),
         "b": (rng.standard_normal((L, d)) * 0.1).astype(np.float32)}
    x = rng.standard_normal((n_micro, mb, d)).astype(np.float32)
    return p, x


def _reference(stages, p, x):
    mesh = compat.make_mesh((stages, 8 // stages), ("pod", "data"))
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    fn = jgpipe(_jblock, mesh, axis="pod")
    with compat.set_mesh(mesh):
        out = jax.jit(fn)(jp, jnp.asarray(x))
        g = jax.jit(jax.grad(lambda q: jnp.sum(fn(q, jnp.asarray(x)) ** 2)))(jp)
    return np.asarray(out), {k: np.asarray(v) for k, v in g.items()}


@pytest.mark.parametrize("stages,n_micro,placed", [
    (4, 6, False), (4, 4, True), (2, 3, False), (2, 3, True)])
def test_gpipe_matches_reference_and_sequential(world, stages, n_micro,
                                                placed):
    p, x = _setup(stages, n_micro)
    want, want_g = _reference(stages, p, x)
    results = world.run("gpipe_case", (stages, 4 // stages), p, x, placed)
    for out, seq, equal, g, seq_g in results:
        assert equal                        # torch.equal to sequential
        np.testing.assert_allclose(out, want, rtol=1e-6, atol=1e-6)
        for k in p:
            np.testing.assert_allclose(g[k], want_g[k], rtol=1e-5, atol=1e-5)
            np.testing.assert_allclose(g[k], seq_g[k], rtol=1e-5, atol=1e-5)
    # every rank returns every finished microbatch
    for r in results[1:]:
        np.testing.assert_array_equal(r[0], results[0][0])


def test_gpipe_rejects_misplaced_leaves(world):
    p, x = _setup(2, 3)
    p["w"] = p["w"][:3]                       # 3 layers over 2 stages
    with pytest.raises(RuntimeError, match="does not split over 2 stages"):
        world.run("gpipe_case", (2, 2), p, x, False)
