"""The port stands alone: no JAX, no ``repro``, and no silent CPU fallback.

* An AST scan: no module under ``src/repro_torch/``, not
  ``chip_smoke.py`` and not the multi-rank tests' rank side
  ``tests/_torch_dist.py``, imports ``jax`` or ``repro``.
* ``import repro_torch`` (every module) in a fresh interpreter leaves
  ``jax`` out of ``sys.modules``.
* ``Accelerator().compile(...)`` raises when CUDA is absent instead of
  running on the CPU, for a converted CNN and for an LM.
* The kernel modules import, and their CPU path runs (all four kernels'
  wrappers and the LM serving path), with no ``nvcc`` on the PATH.
"""

import ast
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch import api
from repro_torch.configs import get_config
from repro_torch.core import conversion
from repro_torch.lm import model as lm_model
from repro_torch.models import lenet

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = REPO / "src" / "repro_torch"
# the port, the card's smoke script, and the rank side of the multi-rank
# tests (its spawned ranks import torch and the port only)
SOURCES = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py",
                                        REPO / "tests" / "_torch_dist.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_roots(path: pathlib.Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_or_reference_imports(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def _modules():
    return sorted(
        ".".join(p.relative_to(REPO / "src").with_suffix("").parts)
        .removesuffix(".__init__") for p in PORT.rglob("*.py"))


def _run(code: str, env=None) -> str:
    env = dict(os.environ if env is None else env)
    env["PYTHONPATH"] = str(REPO / "src")
    out = subprocess.run([sys.executable, "-c", code], env=env, check=True,
                         capture_output=True, text=True, timeout=120)
    return out.stdout


def test_import_leaves_jax_unloaded():
    mods = _modules()
    assert "repro_torch.kernels.radix_conv" in mods
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r}))\n")
    assert _run(code).strip() == "[]"


def test_compile_raises_without_cuda(monkeypatch):
    static, params, hw = lenet.make(np.random.default_rng(0),
                                    width_mult=0.25)
    net = conversion.convert(static, params, torch.rand((2,) + hw),
                             num_steps=4)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.Accelerator().compile(net, hw)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.Accelerator(device="cuda").compile(net, hw)


def test_lm_compile_raises_without_cuda(monkeypatch):
    cfg = get_config("gemma_2b", smoke=True)
    params = lm_model.init_params(torch.Generator().manual_seed(0), cfg)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.Accelerator().compile((params, cfg), (2, 24), buckets=(8, 16))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.Accelerator(dataflow="fused", device="cuda").compile(
            (params, cfg), (2, 24))


def test_cpu_path_runs_without_nvcc(tmp_path):
    env = {"PATH": str(tmp_path), "HOME": str(tmp_path),
           "CUDA_HOME": str(tmp_path / "no-cuda")}
    code = (
        "import shutil, torch\n"
        "assert shutil.which('nvcc') is None\n"
        "from repro_torch.kernels import ops\n"
        "x = torch.randint(0, 16, (5, 9, 9, 3), dtype=torch.uint8)\n"
        "w = torch.randint(-3, 4, (3, 3, 3, 4), dtype=torch.int8)\n"
        "y = ops.radix_conv2d(x, w, None, 4, padding='SAME', sparsity=True)\n"
        "z = ops.radix_matmul(y.reshape(5, -1).clamp(0, 15).to(torch.uint8),\n"
        "                     torch.ones((324, 2), dtype=torch.int8), None, 4)\n"
        "e = ops.radix_encode(torch.rand(2, 3, 5), 4, 0.5)\n"
        "kv = torch.randint(0, 256, (2, 7, 1, 4), dtype=torch.uint8)\n"
        "sc = torch.ones((2, 7, 1))\n"
        "a = ops.radix_decode_attention(torch.randn(2, 2, 8), kv, sc, kv, sc,\n"
        "                               torch.ones((2, 7), dtype=torch.bool),\n"
        "                               4, packed=True)\n"
        "from repro_torch import api\n"
        "from repro_torch.configs import get_config\n"
        "from repro_torch.lm import model\n"
        "import dataclasses\n"
        "cfg = dataclasses.replace(get_config('gemma_2b', smoke=True),\n"
        "                          radix_kv_pack=True, packed_attn=True)\n"
        "p = model.init_params(torch.Generator().manual_seed(0), cfg)\n"
        "exe = api.Accelerator(device='cpu').compile((p, cfg), (2, 24),\n"
        "                                            buckets=(8, 16))\n"
        "g = exe.generate(torch.zeros((2, 5), dtype=torch.long), 2)\n"
        "print(tuple(y.shape), tuple(z.shape), tuple(e.shape), e.dtype,\n"
        "      tuple(a.shape), tuple(g.shape))\n")
    assert _run(code, env).strip() == (
        "(5, 9, 9, 4) (5, 2) (2, 3, 5) torch.uint8 (2, 2, 8) (2, 2)")


def test_cuda_build_reports_missing_nvcc(monkeypatch, tmp_path):
    from repro_torch.kernels import _build

    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build(["radix_matmul"])
