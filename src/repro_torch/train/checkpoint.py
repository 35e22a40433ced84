"""Checkpoints of trees of tensors (port of ``repro/train/checkpoint.py``),
in the reference's layout on disk, so that either package restores what
the other wrote:

* ``<ckpt_dir>/step_%010d/``, written as ``step_%010d.tmp`` and renamed
  into place, so a crash mid-write never corrupts the newest complete
  checkpoint (``latest_step`` scans completed directories only);
* ``manifest.json``: ``{"step", "leaves": [{"key", "file", "shape",
  "dtype"}], "extra"}``, the leaves in ``jax.tree.leaves`` order;
* one ``.npy`` per leaf, named by its key: the leaf's path
  (``train/tree.py``: dict key, sequence index, NamedTuple field) joined
  by ``__`` (``"leaf"`` for a bare leaf).  ``None`` and ``()`` hold no
  leaf.

A bfloat16 leaf is stored as the reference stores it: its raw 2-byte
values under the ``.npy`` descr ``'<V2'`` (what ``np.save`` writes for an
``ml_dtypes.bfloat16`` array) and the manifest dtype ``"bfloat16"``; it
is read back through an int16 view, so neither side needs ``ml_dtypes``.
(The reference's ``restore`` cannot read such a leaf back: numpy has no
cast from ``'|V2'`` to bfloat16.)

``save_async`` copies the tree to host memory on the caller's thread,
the only part that must be consistent with the training step, then
writes the files on a background thread; ``CheckpointManager`` keeps one
write in flight and the last ``keep`` checkpoints.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import threading
from typing import Any, Optional, Tuple

import numpy as np
import torch

from repro_torch.train.tree import leaves_with_paths, unflatten

__all__ = ["save", "save_async", "restore", "latest_step",
           "CheckpointManager"]

_SEP = "__"
_BF16_DESCR = "<V2"


def _key(path) -> str:
    return _SEP.join(str(p) for p in path) or "leaf"


def _flatten_with_keys(tree):
    return [(_key(path), leaf) for path, leaf in leaves_with_paths(tree)]


def _snapshot(tree):
    """(key, host copy) per tensor leaf: copied to the CPU, so later
    in-place writes of the caller's do not reach the checkpoint."""
    return [(key, leaf.detach().to("cpu", copy=True))
            for key, leaf in _flatten_with_keys(tree)]


def _write_leaf(path: str, leaf: torch.Tensor) -> Tuple[list, str]:
    """Write one leaf's ``.npy``; returns (shape, manifest dtype)."""
    if leaf.dtype == torch.bfloat16:
        raw = leaf.contiguous().view(torch.int16).numpy()
        with open(path, "wb") as f:
            np.lib.format.write_array_header_1_0(
                f, {"descr": _BF16_DESCR, "fortran_order": False,
                    "shape": tuple(raw.shape)})
            f.write(raw.tobytes())
        return list(raw.shape), "bfloat16"
    arr = leaf.numpy()
    np.save(path, arr)
    return list(arr.shape), str(arr.dtype)


def _write(ckpt_dir: str, step: int, host_leaves, extra) -> str:
    final = os.path.join(ckpt_dir, f"step_{step:010d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    manifest = {"step": step, "leaves": [], "extra": extra or {}}
    for key, leaf in host_leaves:
        fname = f"{key}.npy"
        shape, dtype = _write_leaf(os.path.join(tmp, fname), leaf)
        manifest["leaves"].append(
            {"key": key, "file": fname, "shape": shape, "dtype": dtype})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def save(ckpt_dir: str, step: int, tree: Any,
         extra: Optional[dict] = None) -> str:
    """Synchronous checkpoint write.  Returns the final directory."""
    return _write(ckpt_dir, step, _snapshot(tree), extra)


def save_async(ckpt_dir: str, step: int, tree: Any,
               extra: Optional[dict] = None) -> threading.Thread:
    """Snapshot now, write in the background.  Join the returned thread
    (or use ``CheckpointManager``) before the process exits."""
    t = threading.Thread(target=_write,
                         args=(ckpt_dir, step, _snapshot(tree), extra),
                         daemon=False)
    t.start()
    return t


def _steps(ckpt_dir: str):
    return [int(m.group(1)) for d in os.listdir(ckpt_dir)
            if (m := re.fullmatch(r"step_(\d+)", d))]


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = _steps(ckpt_dir)
    return max(steps) if steps else None


def _load(path: str, dtype: str) -> torch.Tensor:
    arr = np.load(path)
    if dtype == "bfloat16":
        if arr.dtype.itemsize != 2:
            raise ValueError(f"{path}: a bfloat16 leaf of {arr.dtype}")
        return torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(arr)


def restore(ckpt_dir: str, step: int, like: Any) -> Tuple[Any, dict]:
    """Restore into the structure of ``like``: each leaf takes the dtype
    and device of ``like``'s leaf there.  Returns (tree, extra)."""
    final = os.path.join(ckpt_dir, f"step_{step:010d}")
    with open(os.path.join(final, "manifest.json")) as f:
        manifest = json.load(f)
    by_key = {leaf["key"]: leaf for leaf in manifest["leaves"]}
    out = []
    for key, ref in _flatten_with_keys(like):
        entry = by_key.get(key)
        if entry is None:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        t = _load(os.path.join(final, entry["file"]), entry["dtype"])
        if tuple(t.shape) != tuple(ref.shape):
            raise ValueError(f"leaf {key!r}: shape {tuple(t.shape)} vs "
                             f"{tuple(ref.shape)}")
        out.append(t.to(device=ref.device, dtype=ref.dtype))
    return unflatten(like, out), manifest["extra"]


class CheckpointManager:
    """Keeps the last ``keep`` checkpoints, one async write in flight."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.dir = ckpt_dir
        self.keep = keep
        self._inflight: Optional[threading.Thread] = None
        os.makedirs(ckpt_dir, exist_ok=True)

    def save(self, step: int, tree: Any, extra: Optional[dict] = None):
        self.wait()
        self._inflight = save_async(self.dir, step, tree, extra)
        self._gc(inflight=step)

    def wait(self):
        if self._inflight is not None:
            self._inflight.join()
            self._inflight = None

    def _gc(self, inflight: Optional[int] = None):
        steps = sorted(set(_steps(self.dir)
                           + ([inflight] if inflight is not None else [])))
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:010d}"),
                          ignore_errors=True)
