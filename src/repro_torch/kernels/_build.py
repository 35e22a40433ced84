"""Build ``csrc/*.cu`` with ``nvcc`` at first use and bind them with ``ctypes``.

Each source compiles on its own into a shared library with a plain C
interface (``nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
-shared -Xcompiler -fPIC``), under ``build/repro_torch/`` at the root of
the checkout.  A library's file name carries a hash of its sources and
flags, so an edited source never loads a stale build.  :func:`build`
starts one ``nvcc`` per missing library, all at once, and waits for all.

Nothing here runs at import: the CPU tests import every module on a
machine without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Optional, Sequence

import torch

__all__ = ["SOURCES", "BUILD_DIR", "build", "function", "check_tensor",
           "device_index", "launch_error"]

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES: Dict[str, str] = {"radix_matmul": "radix_matmul.cu",
                           "radix_conv": "radix_conv.cu",
                           "radix_attn": "radix_attn.cu",
                           "spike_encode": "spike_encode.cu"}
HEADERS = ("radix_common.cuh",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_funcs: Dict[str, ctypes._CFuncPtr] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found is None:
        home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        cand = Path(home) / "bin" / "nvcc"
        if cand.exists():
            found = str(cand)
    if found is None:
        raise RuntimeError(
            "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): "
            "the CUDA kernels are built from csrc/ at first use")
    return found


def _library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in (SOURCES[name],) + HEADERS:
        h.update((CSRC / src).read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Compile the named libraries (default: all) that are not built yet,
    one ``nvcc`` each, in parallel.  Returns the wall seconds each build
    took (0.0 for one already on disk); raises ``RuntimeError`` with the
    compiler's output when one fails.  ``-Xptxas -v``'s report (registers,
    shared memory, spills) is kept in ``<name>.log`` beside the library."""
    names = list(SOURCES) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    took = {}
    for name in names:
        out = _library_path(name)
        if out.exists():
            took[name] = 0.0
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC / SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out, time.perf_counter())
    failed = []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        took[name] = time.perf_counter() - t0
        (BUILD_DIR / f"{name}.log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{name} (nvcc exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA kernel build failed: " + "\n".join(failed))
    return took


def function(name: str, symbol: str, argtypes: Sequence) -> ctypes._CFuncPtr:
    """The C entry point ``symbol`` of library ``name`` (built on first
    use), with ``argtypes`` set and an ``int`` return (a CUDA error code)."""
    key = f"{name}:{symbol}"
    with _lock:
        fn = _funcs.get(key)
        if fn is None:
            build([name])
            fn = getattr(ctypes.CDLL(str(_library_path(name))), symbol)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
            _funcs[key] = fn
    return fn


def check_tensor(t: torch.Tensor, name: str, dtypes, device: torch.device,
                 ndim: Optional[int] = None) -> None:
    """Raise ``ValueError`` unless ``t`` is a contiguous tensor of one of
    ``dtypes`` on ``device`` (with ``ndim`` dimensions when given)."""
    if not torch.is_tensor(t):
        raise ValueError(f"{name} must be a tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise ValueError(f"{name} has dtype {t.dtype}, expected one of "
                         f"{tuple(dtypes)}")
    if ndim is not None and t.ndim != ndim:
        raise ValueError(f"{name} must be {ndim}-D, got shape "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def device_index(device: torch.device) -> int:
    """The CUDA ordinal of ``device`` (the current device when unset)."""
    return torch.cuda.current_device() if device.index is None \
        else device.index


def launch_error(kernel: str, code: int) -> RuntimeError:
    return RuntimeError(f"{kernel} kernel launch failed: CUDA error {code}")
