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

Checkpoints hold global arrays, never per-rank pieces, so a run moves
between meshes by resharding (``runtime/elastic.py``).  A tree of
DTensors (``parallel.sharding.place``) is gathered whole by every rank
of its mesh (a collective: every rank saves) and written by global rank
0 alone.  :func:`restore` puts each leaf where ``like``'s is (a DTensor
leaf: this rank's piece in its placements); :func:`restore_resharded`
places each leaf by a new placement on a new mesh.
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

__all__ = ["save", "save_async", "restore", "restore_resharded",
           "latest_step", "CheckpointManager"]

_SEP = "__"
_BF16_DESCR = "<V2"


def _key(path) -> str:
    return _SEP.join(str(p) for p in path) or "leaf"


def _flatten_with_keys(tree):
    return [(_key(path), leaf) for path, leaf in leaves_with_paths(tree)]


def _snapshot(tree):
    """(key, host copy) per tensor leaf, DTensors gathered whole: copied
    to the CPU, so later in-place writes of the caller's do not reach the
    checkpoint.  ``None`` on a rank that does not write (not rank 0 of a
    DTensor tree's world)."""
    from torch.distributed.tensor import DTensor

    out, sharded = [], False
    for key, leaf in _flatten_with_keys(tree):
        if isinstance(leaf, DTensor):
            leaf, sharded = leaf.full_tensor(), True
        out.append((key, leaf.detach().to("cpu", copy=True)))
    if sharded and torch.distributed.get_rank() != 0:
        return None
    return out


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
         extra: Optional[dict] = None) -> Optional[str]:
    """Synchronous checkpoint write.  Returns the final directory (None
    on a rank that does not write)."""
    host = _snapshot(tree)
    return None if host is None else _write(ckpt_dir, step, host, extra)


def save_async(ckpt_dir: str, step: int, tree: Any,
               extra: Optional[dict] = None) -> threading.Thread:
    """Snapshot now, write in the background.  Join the returned thread
    (or use ``CheckpointManager``) before the process exits."""
    host = _snapshot(tree)
    t = threading.Thread(target=_write if host is not None else
                         (lambda *a: None),
                         args=(ckpt_dir, step, host, extra), daemon=False)
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


def _read(ckpt_dir: str, step: int, like: Any, place) -> Tuple[Any, dict]:
    """Each leaf of ``like``'s structure read from step ``step``, checked
    against the global shape of ``like``'s leaf, and passed to
    ``place(tensor, like_leaf, index)``.  Returns (tree, extra)."""
    final = os.path.join(ckpt_dir, f"step_{step:010d}")
    with open(os.path.join(final, "manifest.json")) as f:
        manifest = json.load(f)
    by_key = {leaf["key"]: leaf for leaf in manifest["leaves"]}
    out = []
    for i, (key, ref) in enumerate(_flatten_with_keys(like)):
        entry = by_key.get(key)
        if entry is None:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        t = _load(os.path.join(final, entry["file"]), entry["dtype"])
        if tuple(t.shape) != tuple(ref.shape):
            raise ValueError(f"leaf {key!r}: shape {tuple(t.shape)} vs "
                             f"{tuple(ref.shape)}")
        out.append(place(t, ref, i))
    return unflatten(like, out), manifest["extra"]


def restore(ckpt_dir: str, step: int, like: Any) -> Tuple[Any, dict]:
    """Restore into the structure of ``like``: each leaf takes the dtype
    and device of ``like``'s leaf there (a DTensor leaf: this rank's piece
    of the global array, in its placements).  Returns (tree, extra)."""
    from repro_torch.parallel.sharding import shard_like

    def place(t, ref, _):
        device = getattr(ref, "to_local", lambda: ref)().device
        return shard_like(t.to(device=device, dtype=ref.dtype), ref)

    return _read(ckpt_dir, step, like, place)


def restore_resharded(ckpt_dir: str, step: int, shapes_tree: Any,
                      shardings_tree: Any, mesh) -> Tuple[Any, dict]:
    """Restore onto any topology: ``shapes_tree`` gives each leaf's
    global shape and dtype (meta tensors will do), ``shardings_tree``
    (laid out as it) its DTensor placements on ``mesh``.  Each rank
    keeps only its piece of every leaf.  Returns (tree of DTensors,
    extra).  Used by elastic re-scaling (``runtime/elastic.py``)."""
    from torch.distributed.tensor import DTensor

    from repro_torch.parallel.sharding import (local_slice, mesh_device,
                                               spec_from)

    device = mesh_device(mesh)
    placed = [_at(shardings_tree, path)
              for path, _ in leaves_with_paths(shapes_tree)]

    def place(t, ref, i):
        pls = placed[i]
        piece = local_slice(t, spec_from(pls, mesh), mesh)
        return DTensor.from_local(
            piece.to(device=device, dtype=ref.dtype).contiguous(), mesh, pls,
            run_check=False)

    return _read(ckpt_dir, step, shapes_tree, place)


def _at(tree, path):
    """The subtree of ``tree`` at a ``leaves_with_paths`` path."""
    for p in path:
        tree = tree[p] if isinstance(tree, dict) or isinstance(p, int) \
            else getattr(tree, p)
    return tree


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
