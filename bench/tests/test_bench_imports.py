"""Nothing of the benchmark imports JAX or the JAX package, and the plain
references import nothing of the program."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def imported(path: Path):
    """Top-level names of every module ``path`` imports, statically, plus
    string arguments of ``import_module``."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) ==
                "import_module" and node.args
                and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


SOURCES = sorted(BENCH.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(BENCH)) for p in SOURCES])
def test_no_jax_or_jax_package(path):
    bad = sorted(set(imported(path)) & FORBIDDEN)
    assert not bad, f"{path} imports {bad}"


REFERENCES = sorted((BENCH / "reference").rglob("*.py"))


@pytest.mark.parametrize("path", REFERENCES,
                         ids=[p.name for p in REFERENCES])
def test_reference_imports_nothing_of_the_program(path):
    bad = sorted(set(imported(path)) & (FORBIDDEN | {"repro_torch"}))
    assert not bad, f"{path} imports {bad}"


@pytest.mark.parametrize("src,flagged", [
    ("import repro_torch.api\nfrom repro_torch import api\n", set()),
    ("import repro.core\n", {"repro"}),
    ("from jax import numpy\n", {"jax"}),
    ("import importlib\nimportlib.import_module('flax.linen')\n", {"flax"}),
])
def test_whole_names_compared(tmp_path, src, flagged):
    """Names are compared whole: ``repro_torch`` starts with ``repro`` and
    passes; ``repro``, ``jax`` and ``flax`` are caught however imported."""
    path = tmp_path / "probe.py"
    path.write_text(src)
    assert set(imported(path)) & FORBIDDEN == flagged


def test_references_load_nothing_of_the_program():
    """Importing the references (in a fresh interpreter) loads neither
    package of the program nor JAX."""
    code = ("import sys; sys.path[:0] = [%r];"
            "import bench.reference.vgg_snn, bench.reference.glm_prefill;"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'repro', 'repro_torch'));"
            "print(bad); sys.exit(1 if bad else 0)") % str(BENCH.parent)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
