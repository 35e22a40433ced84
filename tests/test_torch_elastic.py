"""Resharding in the port over 4 gloo ranks (one world for the module,
``_torch_dist``): ``ShardedLoader`` (``tests/test_data_train.py``),
checkpoints restored onto other meshes bit for bit
(``tests/test_runtime.py``), a checkpoint the reference wrote (a bf16
leaf among them) restored resharded, and training that continues
across topologies."""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest

import _torch_dist
from repro.train import checkpoint as jckpt
from repro_torch.configs import get_config as tget


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    w = _torch_dist.World(4, str(tmp_path_factory.mktemp("world")))
    yield w
    w.close()


def test_sharded_loader_and_prefetcher(world):
    for seen, local, glob, rows in world.run("loader_case", 4):
        assert seen == [3, 4, 5, 6]
        assert local == [(2, 17)] * 4 and glob == [(8, 17)] * 4
        assert all(rows)


def test_elastic_reshard_across_meshes(world, tmp_path):
    """Saved from (2, 2) as ('data', 'model'); restored onto (4, 1) as
    ('model', 'data') and onto (1, 4) as (('data', 'model'), None)."""
    w = np.random.default_rng(0).standard_normal((16, 8)).astype(np.float32)
    for ok in world.run("reshard_case", str(tmp_path), w):
        assert ok == [True] * 4


def test_reference_checkpoint_restores_resharded(world, tmp_path):
    """The reference's ``CheckpointManager`` writes float32, bf16 and
    int32 leaves; the port restores each rank's piece on (2, 2), equal to
    its slice (the bf16 leaf's bits too)."""
    rng = np.random.default_rng(0)
    w = rng.standard_normal((8, 4)).astype(np.float32)
    h = rng.standard_normal((4, 8)).astype(ml_dtypes.bfloat16)
    n = np.arange(8, dtype=np.int32)
    m = jckpt.CheckpointManager(str(tmp_path))
    m.save(3, {"w": jnp.asarray(w), "h": jnp.asarray(h), "n": jnp.asarray(n)},
           extra={"from": "reference"})
    m.wait()
    leaves = {"w": (w, "float32"), "h": (h.view(np.uint16), "bfloat16"),
              "n": (n, "int32")}
    specs = {"w": ("data", "model"), "h": (None, ("data", "model")),
             "n": ("model",)}
    for ok, extra in world.run("reference_ckpt_case", str(tmp_path), leaves,
                               specs):
        assert ok == {"w": True, "h": True, "n": True}
        assert extra == {"from": "reference"}


def test_elastic_training_continues_across_topologies(world, tmp_path):
    """2 steps on (2, 2), a checkpoint, ``reshard_checkpoint`` onto
    (4, 1), 2 more steps: the loss curve of 4 uninterrupted steps on
    (2, 2) within 5e-4, the restored state equal bit for bit."""
    tokens = np.random.default_rng(1).integers(
        0, tget("glm4_9b", smoke=True).vocab, (8, 17)).astype(np.int64)
    for ref, el, same in world.run("elastic_case", str(tmp_path), tokens,
                                   1e-2):
        assert same
        assert el[:2] == ref[:2]
        assert abs(el[-1] - ref[-1]) < 5e-4, (el, ref)
