"""The port's cells and dry run (``launch/cells.py``, ``launch/dryrun.py``)
against the reference's.

* ``defined_cells``, ``cell_matrix`` (as a set: each package lists its
  archs in its own order), ``model_flops`` and the batch inputs' shapes
  and dtypes equal the reference's for all ten archs;
* ``lm.model.abstract_params`` / ``abstract_cache`` give the reference's
  shapes and dtypes as fake tensors;
* one train, one prefill and one decode cell of Gemma-2B run on a
  placeholder world of 256 ranks (16 x 16) in a subprocess (the
  ``fake`` process group cannot share a process with other tests'
  groups): each record is ``status: "ok"`` with the reference's keys,
  and its ``argument_bytes`` equal the sum of the local shard bytes the
  reference's ``PartitionSpec``s give its inputs (the decode position
  is a Python int in the port, a 4-byte scalar in the reference, so it
  is left out);
* a cell that raises is a ``status: "fail"`` record and exit code 1,
  and the dry run refuses to run inside an existing process group.
"""

import json
import math
import os
import subprocess
import sys
import types
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.configs import LM_ARCHS, get_config as jget
from repro.launch import cells as jcells
from repro.lm import model as jmodel
from repro.lm.config import SHAPE_CELLS as JCELLS
from repro.parallel import sharding as JSH
from repro.train import optim as joptim
from repro_torch.configs import get_config as tget
from repro_torch.launch import cells as tcells
from repro_torch.lm import model as tmodel
from repro_torch.lm.config import SHAPE_CELLS as TCELLS
from repro_torch.train.tree import leaves

ROOT = Path(__file__).resolve().parents[1]
_REF_KEYS = {"arch", "cell", "mesh", "chips", "device_flops", "device_bytes",
             "device_link_bytes", "per_collective", "t_compute", "t_memory",
             "t_collective", "bottleneck", "model_flops", "useful_ratio",
             "raw_flops", "raw_bytes", "memory_per_device", "int8",
             "step_time_lb", "roofline_fraction", "quant", "moe_impl",
             "seq_shard", "remat", "lower_s", "compile_s", "status"}


def _jshapes(tree):
    return [(tuple(x.shape), str(x.dtype)) for x in jax.tree.leaves(tree)]


def _tshapes(tree):
    return [(tuple(t.shape), str(t.dtype).replace("torch.", ""))
            for t in leaves(tree)]


def test_cell_matrix_and_flops_match_reference():
    # the same cells, each package's in the order of its LM_ARCHS (the
    # port's order is pinned by test_torch_temporal.py)
    got, want = tcells.cell_matrix(), jcells.cell_matrix()
    assert sorted(got) == sorted(want) and len(got) == len(set(got))
    for arch in LM_ARCHS:
        jc, tc = jget(arch), tget(arch)
        assert tcells.defined_cells(tc) == jcells.defined_cells(jc)
        for name in TCELLS:
            assert tcells.model_flops(tc, TCELLS[name]) == \
                jcells.model_flops(jc, JCELLS[name])
            got = tcells.make_batch_abstract(tc, TCELLS[name])
            want = jcells.make_batch_abstract(jc, JCELLS[name])
            assert sorted(got) == sorted(want)
            assert all(t.device.type == "meta" for t in got.values())
            assert _tshapes(got) == _jshapes(want), (arch, name)


@pytest.mark.parametrize("arch", ["whisper_medium", "recurrentgemma_2b",
                                  "kimi_k2_1t_a32b"])
def test_abstract_trees_match_reference(arch):
    mode = FakeTensorMode()
    params = tmodel.abstract_params(tget(arch), mode)
    assert _tshapes(params) == _jshapes(jmodel.abstract_params(jget(arch)))
    cache = tmodel.abstract_cache(tget(arch), 4, 64, mode)
    assert _tshapes(cache) == _jshapes(jmodel.abstract_cache(jget(arch), 4,
                                                             64))


def _local_bytes(tree, specs, sizes) -> int:
    """Bytes of each leaf's local shard under the reference's specs."""
    total = 0
    flat_s = jax.tree.leaves(specs, is_leaf=lambda x: isinstance(
        x, jax.sharding.PartitionSpec))
    for x, spec in zip(jax.tree.leaves(tree), flat_s):
        shape = list(x.shape)
        for d, entry in enumerate(tuple(spec)):
            for a in (entry if isinstance(entry, tuple) else
                      (() if entry is None else (entry,))):
                shape[d] //= sizes[a]
        total += math.prod(shape) * np.dtype(x.dtype).itemsize
    return total


def _ref_argument_bytes(arch, cell_name) -> int:
    sizes = {"data": 16, "model": 16}
    mesh = types.SimpleNamespace(shape=sizes, axis_names=tuple(sizes))
    cfg = jget(arch)
    cell = JCELLS[cell_name]
    params = jmodel.abstract_params(cfg)
    pspecs = JSH.param_specs(params, cfg, mesh)
    total = _local_bytes(params, pspecs, sizes)
    batch = jcells.make_batch_abstract(cfg, cell)
    if cell.kind == "train":
        opt = jax.eval_shape(joptim.adafactor(1e-3).init, params)
        total += _local_bytes(opt, JSH.opt_state_specs(pspecs, opt, mesh),
                              sizes) + 4
    if cell.kind == "decode":
        cache = jmodel.abstract_cache(cfg, cell.global_batch, cell.seq_len)
        total += _local_bytes(cache, JSH.cache_specs(cache, cfg, mesh), sizes)
        spec = JSH.sanitize(jax.sharding.PartitionSpec("data", None),
                            batch["tokens"].shape, mesh)
        return total + _local_bytes(batch, {"tokens": spec}, sizes)
    return total + _local_bytes(batch, JSH.batch_specs(batch, cfg, mesh),
                                sizes)


_DRIVER = """
import json, sys
import torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch.launch import dryrun
out = sys.argv[1]
for cell in ("train_4k", "prefill_32k", "decode_32k"):
    dryrun.main(["--arch", "gemma_2b", "--cell", cell,
                 "--out", f"{out}/{cell}.json"])
try:
    dryrun.main(["--arch", "gemma_2b", "--cell", "no_such_cell",
                 "--out", f"{out}/fail.json"])
except SystemExit as e:
    print("exit", e.code)
dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
try:
    dryrun.main(["--arch", "gemma_2b", "--cell", "decode_32k"])
except RuntimeError as e:
    print("refused:", e)
dist.destroy_process_group()
"""


@pytest.fixture(scope="module")
def dry_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", _DRIVER, str(out)],
                          capture_output=True, text=True, env=env,
                          timeout=600, cwd=str(ROOT))
    assert proc.returncode == 0, proc.stderr[-4000:]
    return out, proc.stdout


@pytest.mark.parametrize("cell", ["train_4k", "prefill_32k", "decode_32k"])
def test_cell_runs_on_placeholder_world(dry_run, cell):
    out, stdout = dry_run
    (rec,) = json.loads((out / f"{cell}.json").read_text())
    assert rec["status"] == "ok" and set(rec) == _REF_KEYS
    assert (rec["mesh"], rec["chips"]) == ("16x16", 256)
    assert rec["device_flops"] > 0 and rec["t_compute"] > 0
    mem = rec["memory_per_device"]
    assert mem["argument_bytes"] == _ref_argument_bytes("gemma_2b", cell)
    assert mem["output_bytes"] > 0 and mem["temp_bytes"] > 0
    assert stdout.count("[dryrun] 1/1 cells OK") == 3
    assert f"gemma_2b               {cell}" in stdout


def test_failures_are_records_and_exit_1(dry_run):
    out, stdout = dry_run
    (rec,) = json.loads((out / "fail.json").read_text())
    assert rec["status"] == "fail" and "no_such_cell" in rec["error"]
    assert "[dryrun] 0/1 cells OK" in stdout and "exit 1" in stdout
    assert "refused: the dry run needs its own placeholder world" in stdout
