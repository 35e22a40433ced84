"""Deterministic kernels for the span of a training call.

The reference's training step is one compiled XLA program of (params,
batch), and gives the same weights from one seed on every run.  On the
card three things break that unless turned off: cuDNN's autotuned and
non-deterministic convolution algorithms, atomic-add kernels in the
embedding and gather backwards (``index_put_`` with accumulation and
``scatter_add_``), and cuBLAS's split workspaces.  :func:`deterministic`
selects cuDNN's deterministic algorithms with benchmarking off, turns on
``torch.use_deterministic_algorithms`` (raising on an op that has no
deterministic kernel) and sets ``CUBLAS_WORKSPACE_CONFIG`` (which torch
requires with it), and restores every one of them afterwards.
"""

from __future__ import annotations

import contextlib
import os

import torch

__all__ = ["deterministic", "CUBLAS_WORKSPACE"]

CUBLAS_WORKSPACE = ":4096:8"


@contextlib.contextmanager
def deterministic():
    """Deterministic kernels inside the ``with`` block; the process's
    settings (and the environment variable) as they were after it."""
    cudnn = torch.backends.cudnn
    saved = (cudnn.deterministic, cudnn.benchmark,
             torch.are_deterministic_algorithms_enabled(),
             torch.is_deterministic_algorithms_warn_only_enabled(),
             os.environ.get("CUBLAS_WORKSPACE_CONFIG"))
    if saved[4] is None:
        os.environ["CUBLAS_WORKSPACE_CONFIG"] = CUBLAS_WORKSPACE
    cudnn.deterministic, cudnn.benchmark = True, False
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        cudnn.deterministic, cudnn.benchmark = saved[0], saved[1]
        torch.use_deterministic_algorithms(saved[2], warn_only=saved[3])
        if saved[4] is None:
            os.environ.pop("CUBLAS_WORKSPACE_CONFIG", None)
