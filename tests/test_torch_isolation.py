"""The port stands alone: no JAX, no ``repro``, and no silent CPU fallback.

* An AST scan: no module under ``src/repro_torch/``, and not
  ``chip_smoke.py``, imports ``jax`` or ``repro``.
* ``import repro_torch`` (every module) in a fresh interpreter leaves
  ``jax`` out of ``sys.modules``.
* ``Accelerator().compile(...)`` raises when CUDA is absent instead of
  running on the CPU.
* The kernel modules import, and their CPU path runs, with no ``nvcc``
  on the PATH.
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
from repro_torch.core import conversion
from repro_torch.models import lenet

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = REPO / "src" / "repro_torch"
SOURCES = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
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
        "print(tuple(y.shape), tuple(z.shape))\n")
    assert _run(code, env).strip() == "(5, 9, 9, 4) (5, 2)"


def test_cuda_build_reports_missing_nvcc(monkeypatch, tmp_path):
    from repro_torch.kernels import _build

    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build(["radix_matmul"])
