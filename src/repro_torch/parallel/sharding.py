"""Logical-axis sharding rules -> specs -> DTensor placements (port of
``repro/parallel/sharding.py``).

The rules encode the reference's layout (its DESIGN.md §6):

* **TP** over 'model': attention heads (fallback: head_dim, then
  replicate when neither divides), FFN hidden f, expert dim E (EP),
  vocab.
* **FSDP/ZeRO-3** over the data axes ('pod', 'data'): the d_model dim of
  every large matrix.
* Norm vectors and other O(d) leaves are replicated.

A **spec** is a tuple with one entry per tensor dim: ``None``, a mesh
axis name, or a tuple of axis names; it is the reference's
``PartitionSpec`` with the same entries in the same order.  Every rule is
validated against the leaf's shape: a mesh axis that does not divide its
dim falls back along the rule's candidate list, so one table covers all
ten archs.  The rule functions read only leaf paths, shapes, the config
and the mesh's axis sizes (a ``DeviceMesh`` or an ordered ``{axis:
size}`` mapping), so they run without ranks.

:func:`shardings` maps specs onto DTensor placements of a
``torch.distributed.device_mesh.DeviceMesh``; :func:`local_slice` cuts a
global tensor to one rank's piece of a spec, and :func:`place` builds
DTensors from those pieces with no communication.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, Sequence, Tuple

import torch

from repro_torch.lm.config import ArchConfig
from repro_torch.train.optim import AdafactorState, AdamState, _FactoredSlot
from repro_torch.train.tree import leaves_with_paths, tree_map, unflatten

__all__ = ["axis_sizes", "dp_axes", "sanitize", "param_specs", "batch_specs",
           "cache_specs", "opt_state_specs", "shardings", "placements",
           "local_slice", "place", "gather", "spec_of", "spec_from", "shard_like", "mesh_device",
           "entry_axes", "spec_tree_map", "model_split", "RADIX_KEYS"]

Spec = Tuple


def axis_sizes(mesh) -> Dict[str, int]:
    """``{axis name: size}`` in mesh order, of a ``DeviceMesh`` (its
    ``mesh_dim_names``) or of a mapping."""
    if isinstance(mesh, Mapping):
        return {str(k): int(v) for k, v in mesh.items()}
    return dict(zip(mesh.mesh_dim_names, (int(s) for s in mesh.shape)))


def dp_axes(mesh) -> Tuple[str, ...]:
    """The data axes ('pod', 'data') present in ``mesh``, in mesh order
    (``()`` for no mesh)."""
    if mesh is None:
        return ()
    return tuple(n for n in axis_sizes(mesh) if n in ("pod", "data"))


def _dp(mesh):
    axes = dp_axes(mesh)
    return axes if len(axes) > 1 else (axes[0] if axes else None)


def entry_axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def _axis_size(sizes: Dict[str, int], entry) -> int:
    return math.prod(sizes[a] for a in entry_axes(entry))


def sanitize(spec: Spec, shape: Sequence[int], mesh) -> Spec:
    """Drop mesh axes that do not divide their dim (per-dim fallback)."""
    sizes = axis_sizes(mesh)
    entries = list(spec) + [None] * (len(shape) - len(spec))
    return tuple(e if e is not None and d % _axis_size(sizes, e) == 0
                 else None for d, e in zip(shape, entries))


def _first_valid(options: Sequence[Spec], shape, mesh) -> Spec:
    """First candidate whose every placed axis divides; else
    ``sanitize(first)``."""
    sizes = axis_sizes(mesh)
    for opt in options:
        entries = list(opt) + [None] * (len(shape) - len(opt))
        if all(d % _axis_size(sizes, e) == 0 for d, e in zip(shape, entries)):
            return tuple(entries)
    return sanitize(options[0], shape, mesh)


def _none(n: int) -> Spec:
    return (None,) * n


# ---------------------------------------------------------------------------
# Parameter rules.
# ---------------------------------------------------------------------------


def _leaf_rule(names: Tuple[str, ...], shape, cfg: ArchConfig, mesh) -> Spec:
    """Spec for one leaf given its path names and UNSTACKED shape."""
    sizes = axis_sizes(mesh)
    dp = _dp(mesh)
    last = names[-1]
    has_model = "model" in sizes
    M = "model" if has_model else None
    in_moe = cfg.moe is not None and "ffn" in names and "shared" not in names

    def fv(*options):
        return _first_valid(options, shape, mesh)

    # --- embeddings / head ---
    if last == "embed":
        return fv((M, dp), (None, M))
    if last == "unembed" or names[-2:] == ("unembed", "q"):
        return fv((dp, M), (M, None))
    if names[-2:] == ("unembed", "scale"):
        return fv((M,))
    if last in ("pos_embed", "enc_pos_embed"):
        return fv((None, M))

    # --- norms & other vectors ---
    if any(n in ("ln1", "ln2", "lnx", "final_norm", "enc_final_norm")
           for n in names):
        return _none(len(shape))

    # --- attention ---
    if last in ("wq", "wk", "wv"):
        return fv((None, dp, M, None), (None, dp, None, M),
                  (None, dp, None, None))
    if last == "wo":
        return fv((None, M, None, dp), (None, None, M, dp),
                  (None, None, None, dp))

    # --- MoE expert weights (L, E, d, f) / (L, E, f, d); router (L, d, E) ---
    if in_moe and last == "router":
        return _none(3)
    if in_moe and last in ("w_gate", "w_up", "w_down"):
        if has_model and cfg.moe.num_experts % sizes["model"] == 0:
            # EP: experts over model, dim 2 (d for gate/up, f for down)
            # FSDP over the data axes, as moe.py's dispatches read them
            return fv((None, M, dp, None))
        if last == "w_down":   # TP: f over model, d FSDP
            return fv((None, None, M, dp))
        return fv((None, None, dp, M))

    # --- dense FFN (incl. shared experts, radix-quantized dicts) ---
    if last in ("w_gate", "w_up", "w_ck", "w_cr", "w_gate_branch",
                "w_rec_in", "w_r", "w_k", "w_v", "w_g", "w_dec_a"):
        return fv((None, dp, M), (None, dp, None))
    if last in ("w_down", "w_cv", "w_out", "w_o"):
        return fv((None, M, dp), (None, None, dp))
    if last == "scale":          # radix weight scale: follows out-channel dim
        return fv((None, M), (None, None))
    if last == "w_dec_b":
        return fv((None, None, M))

    # --- RG-LRU per-channel leaves (W sharded over model) ---
    if last in ("w_a", "w_x"):
        return fv((None, dp, M))
    if last in ("b_a", "b_x", "lambda_p", "w_dec0"):
        return fv((None, M))
    if last == "conv_w":
        return fv((None, None, M))

    # --- RWKV heads ---
    if last in ("u_bonus", "gn_w", "gn_b"):
        return fv((None, M, None), (None, None, None))
    # mu_* and every other leaf: replicate
    return _none(len(shape))


RADIX_KEYS = ("q", "qt", "scale")
"""The leaves of a radix weight dict (``lm/radix.quantize_weight``,
``kmajor_weight``) below the weight's own key."""
_ATTN_IN = ("wq", "wk", "wv")
_MATRICES = ("w_gate", "w_up", "w_down", "w_ck", "w_cr", "w_cv",
             "w_gate_branch", "w_rec_in", "w_out", "w_r", "w_k", "w_v",
             "w_g", "w_o", "w_dec_a", "w_dec_b", "w_a", "w_x", "unembed")
_CHANNELS = ("b_a", "b_x", "lambda_p", "w_dec0", "conv_w")


def _float_shape(key: str, shape, hd: int) -> tuple:
    """The float weight's shape behind a radix dict's ``q`` levels of
    ``shape``: attention projections are stored over their flattened 2-D
    view (``lm/model.radixify_params``)."""
    shape = tuple(shape)
    if key in _ATTN_IN:
        return shape[:-1] + (shape[-1] // hd, hd)
    if key == "wo":
        return shape[:-2] + (shape[-2] // hd, hd, shape[-1])
    return shape


def model_split(names: Tuple[str, ...], shape, cfg: ArchConfig,
                mesh) -> Tuple[str, Spec]:
    """How the leaf at ``names`` (a weight's path; a radix dict's weight
    key, not its ``q``/``scale``) of float ``shape`` (stacked, as
    :func:`param_specs` sees it) is split over 'model' by the rule table:
    ``(kind, spec)`` with ``spec`` the rule's spec kept to 'model' (the
    data axes dropped) and ``kind`` one of

    * ``"column"``: output channels (a matrix's last dim, attention's
      heads, a per-channel vector's channels, RWKV's per-head leaves'
      heads);
    * ``"row"``: input channels (a matrix's second-to-last dim, ``wo``'s
      heads);
    * ``"head_dim"``: a QKV projection's head_dim, the fallback where the
      heads do not divide the axis; ``"row_hd"`` the same for ``wo``;
    * ``"vocab"``: the embedding table's rows;
    * ``"expert"``: the MoE experts, of which a mesh dispatch of
      ``lm/moe.py`` runs this rank's experts or d_ff slice (serving
      hands it them whole, ``parallel/tp.shard_params``);
    * ``"whole"``: leaves used whole although stored split (tables
      split over d_model);
    * ``"replicated"``: no 'model' entry.

    It reads the one rule table (:func:`_leaf_rule`), validated against
    the shape as :func:`param_specs` does."""
    shape = tuple(shape)
    spec = _first_valid([_leaf_rule(names, shape, cfg, mesh)], shape, mesh)
    spec = tuple(e if "model" in entry_axes(e) else None for e in spec)
    md = next((i for i, e in enumerate(spec) if e is not None), None)
    key, nd = names[-1], len(shape)
    in_moe = cfg.moe is not None and "ffn" in names and "shared" not in names
    if md is None:
        return "replicated", spec
    if in_moe and key in ("w_gate", "w_up", "w_down"):
        return "expert", spec
    if spec[md] != "model":
        raise ValueError(f"{names}: 'model' shares dim {md} with another "
                         f"axis ({spec[md]!r})")
    if key in _ATTN_IN:
        return ("column" if md == nd - 2 else "head_dim"), spec
    if key == "wo":
        return ("row" if md == nd - 3 else "row_hd"), spec
    if key == "embed":
        return ("vocab" if md == 0 else "whole"), spec
    if key in _MATRICES:
        return ("column" if md == nd - 1 else "row"), spec
    if key in _CHANNELS and md == nd - 1:
        return "column", spec
    if key in ("u_bonus", "gn_w", "gn_b") and md == nd - 2:
        return "column", spec
    return "whole", spec


def _names_of(path) -> Tuple[str, ...]:
    """A tree path's dict keys and NamedTuple fields (sequence indices
    dropped, as the reference drops its ``#i`` entries)."""
    return tuple(str(p) for p in path if not isinstance(p, int))


def spec_tree_map(fn, tree):
    """``fn(path, leaf)`` over ``tree``'s leaves, as a tree of its results
    (the specs: tuples, placed whole)."""
    return unflatten(tree, [fn(path, leaf)
                            for path, leaf in leaves_with_paths(tree)])


def param_specs(abstract_params, cfg: ArchConfig, mesh):
    """Spec tree matching a parameter tree (any tensors with ``.shape``,
    meta tensors included)."""

    def rule(path, leaf):
        shape = tuple(leaf.shape)
        spec = _leaf_rule(_names_of(path), shape, cfg, mesh)
        return _first_valid([spec], shape, mesh)

    return spec_tree_map(rule, abstract_params)


def batch_specs(batch_abstract, cfg: ArchConfig, mesh, seq_shard: bool = True):
    """Input batch specs: batch dim over the data axes; the sequence dim
    of embedding inputs over 'model' when divisible."""
    dp = _dp(mesh)

    def rule(path, leaf):
        shape = tuple(leaf.shape)
        if path and path[-1] in ("embeds", "enc_embeds") and len(shape) == 3:
            if seq_shard:
                return _first_valid([(dp, "model", None), (dp, None, None)],
                                    shape, mesh)
            return _first_valid([(dp, None, None)], shape, mesh)
        if len(shape) >= 1:
            return _first_valid([(dp,) + _none(len(shape) - 1)], shape, mesh)
        return ()

    return spec_tree_map(rule, batch_abstract)


def cache_specs(cache_abstract, cfg: ArchConfig, mesh):
    """KV-cache specs: batch over the data axes, the cache sequence dim
    over 'model'; recurrent states: width/heads over 'model'.

    Stacked layout: attention leaves are (L, B, S, H, hd) (scales
    (L, B, S, H)); rglru conv (L, B, K-1, W), h (L, B, W); rwkv S
    (L, B, H, hd, hd)."""
    dp = _dp(mesh)

    def rule(path, leaf):
        shape = tuple(leaf.shape)
        last = str(path[-1])
        nd = len(shape)
        if last in ("k", "v") and nd == 5:
            opts = [(None, dp, "model", None, None), (None, dp) + _none(3)]
        elif last in ("k_scale", "v_scale") and nd == 4:
            opts = [(None, dp, "model", None), (None, dp, None, None)]
        elif last == "h" and nd == 3:               # rglru hidden (L, B, W)
            opts = [(None, dp, "model")]
        elif last == "conv" and nd == 4:
            opts = [(None, dp, None, "model")]
        elif last == "S" and nd == 5:               # rwkv state
            opts = [(None, dp, "model", None, None)]
        elif last == "last_x" and nd == 3:
            opts = [(None, dp, None)]
        else:   # batch over dp on dim 1 (dim 0 is the layer stack)
            cand = [None] * nd
            if nd >= 2:
                cand[1] = dp
            opts = [tuple(cand)]
        return _first_valid(opts, shape, mesh)

    return spec_tree_map(rule, cache_abstract)


def opt_state_specs(pspecs, abstract_opt_state, mesh,
                    replace_dp: bool = True):
    """Optimizer-state specs derived from parameter specs.

    Adafactor's factored slots drop the last (vr) / second-to-last (vc)
    dim of the parameter spec; full-sized slots (momentum, adam mu/nu)
    reuse the parameter spec (ZeRO: optimizer state is sharded wherever
    the parameter is).  When the dropped dim carried the data axes, they
    are re-placed on the largest remaining unsharded dim, so no slot
    stays data-replicated (ZeRO-2 for the factored statistics);
    ``replace_dp=False`` leaves them off (each slot laid out as its
    parameter's piece computes it: the train step's layout)."""
    sizes = axis_sizes(mesh)
    dp = _dp(mesh)
    dp_size = _axis_size(sizes, dp)

    def _replace_dp(entries, shape):
        if not replace_dp or dp is None or any(
                set(entry_axes(e)) & {"data", "pod"} for e in entries):
            return tuple(entries)
        dims = sorted(((d, i) for i, d in enumerate(shape)
                       if entries[i] is None and d % dp_size == 0),
                      reverse=True)
        entries = list(entries)
        if dims:
            entries[dims[0][1]] = dp
        return tuple(entries)

    def slots_spec(slot, ps):
        """The slot tree drives: a ``_FactoredSlot`` or a tensor is a
        leaf, where ``ps`` is that parameter's spec."""
        if isinstance(slot, _FactoredSlot):
            pe = list(ps)
            return _FactoredSlot(vr=_replace_dp(pe[:-1], slot.vr.shape),
                                 vc=_replace_dp(pe[:-2] + pe[-1:],
                                                slot.vc.shape))
        if isinstance(slot, dict):
            return {k: slots_spec(v, ps[k]) for k, v in slot.items()}
        if isinstance(slot, (tuple, list)):
            return type(slot)(slots_spec(v, q) for v, q in zip(slot, ps))
        return ps

    state = abstract_opt_state
    if isinstance(state, AdafactorState):
        return AdafactorState(step=(), slots=slots_spec(state.slots, pspecs),
                              mu=pspecs if state.mu != () else ())
    if isinstance(state, AdamState):
        return AdamState(step=(), mu=pspecs, nu=pspecs)
    if state == ():
        return ()
    return spec_tree_map(lambda path, leaf: (), state)


# ---------------------------------------------------------------------------
# Specs on a DeviceMesh.
# ---------------------------------------------------------------------------


def placements(spec: Spec, mesh) -> tuple:
    """One DTensor placement per mesh dim: ``Shard(d)`` where the spec's
    dim ``d`` names that axis, else ``Replicate()``.  An entry naming
    several axes must name them in mesh order (major to minor, as a
    ``PartitionSpec`` tuple splits its dim), which nested ``Shard``s of
    the same dim reproduce."""
    from torch.distributed.tensor import Replicate, Shard

    order = list(axis_sizes(mesh))
    out = [Replicate()] * len(order)
    for d, entry in enumerate(spec):
        names = entry_axes(entry)
        idx = [order.index(a) for a in names]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry!r} names mesh axes out of "
                             f"mesh order {tuple(order)}")
        for i in idx:
            out[i] = Shard(d)
    return tuple(out)


def shardings(spec_tree, like, mesh):
    """Spec tree -> tree of placements, laid out as ``like`` (the tree the
    specs describe; a spec is a tuple, so the value tree drives)."""
    return tree_map(lambda _, s: placements(s, mesh), like, spec_tree)


def mesh_device(mesh) -> torch.device:
    """The device this rank's pieces live on: its current CUDA device for
    a CUDA mesh, else the CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _coords(mesh) -> Dict[str, int]:
    return {a: mesh.get_local_rank(a) for a in axis_sizes(mesh)}


def local_slice(t, spec: Spec, mesh, coords: Dict[str, int] = None):
    """The piece of the global ``t`` (a tensor or a numpy array) that the
    rank at ``coords`` (default: this rank) holds under ``spec``: each
    sharded dim split evenly, its axes major to minor."""
    sizes = axis_sizes(mesh)
    coords = _coords(mesh) if coords is None else coords
    index = []
    for d, entry in enumerate(tuple(spec) + _none(len(t.shape) - len(spec))):
        n, k = 1, 0
        for a in entry_axes(entry):
            n, k = n * sizes[a], k * sizes[a] + coords[a]
        step = t.shape[d] // n
        index.append(slice(k * step, (k + 1) * step))
    return t[tuple(index)]


def place(tree, spec_tree, mesh):
    """DTensors of ``tree``'s global leaves placed by ``spec_tree``, each
    rank keeping only its own piece (cut locally, no communication)."""
    from torch.distributed.tensor import DTensor

    def one(t, spec):
        return DTensor.from_local(local_slice(t, spec, mesh).contiguous(),
                                  mesh, placements(spec, mesh),
                                  run_check=False)

    return tree_map(one, tree, spec_tree)


def gather(tree):
    """Every DTensor leaf of ``tree`` gathered whole onto every rank;
    other leaves as they are."""
    from torch.distributed.tensor import DTensor

    return tree_map(lambda t: t.full_tensor() if isinstance(t, DTensor)
                    else t, tree)


def spec_from(pls, mesh) -> Spec:
    """The spec of DTensor placements ``pls`` on ``mesh`` (the inverse of
    :func:`placements`)."""
    by_dim: Dict[int, list] = {}
    for name, pl in zip(axis_sizes(mesh), pls):
        if pl.is_shard():
            by_dim.setdefault(pl.dim, []).append(name)
    ndim = max(by_dim, default=-1) + 1
    return tuple(None if d not in by_dim else by_dim[d][0]
                 if len(by_dim[d]) == 1 else tuple(by_dim[d])
                 for d in range(ndim))


def spec_of(dt) -> Spec:
    """The spec of a DTensor's placements, one entry per dim."""
    spec = spec_from(dt.placements, dt.device_mesh)
    return spec + _none(dt.ndim - len(spec))


def shard_like(t, ref):
    """``t``, a whole tensor, as ``ref`` holds it: this rank's piece in
    ``ref``'s placements when ``ref`` is a DTensor, else ``t`` itself."""
    from torch.distributed.tensor import DTensor

    if not isinstance(ref, DTensor):
        return t
    mesh = ref.device_mesh
    return DTensor.from_local(local_slice(t, spec_of(ref), mesh).contiguous(),
                              mesh, ref.placements, run_check=False)
