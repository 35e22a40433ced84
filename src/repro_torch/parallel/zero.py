"""ZeRO utilities: push replicated state onto the data axes (port of
``repro/parallel/zero.py``).

The parameter rules in ``sharding.py`` already shard every large matrix
over ('pod', 'data'), gathered on use and with gradients scattered back
(ZeRO-3 for parameters and gradients).  What remains replicated are
small leaves (norms, biases, routers) and any optimizer slots mirroring
them; :func:`zero_upgrade` shards those over the data axes on their
largest divisible dim.
"""

from __future__ import annotations

import math

from repro_torch.parallel.sharding import axis_sizes, dp_axes
from repro_torch.train.tree import tree_map

__all__ = ["zero_upgrade"]


def zero_upgrade(spec_tree, abstract_tree, mesh):
    """Shard fully replicated leaves over the data axes (largest
    divisible dim, the last of equals); leaves already touching a mesh
    axis are left alone."""
    axes = dp_axes(mesh)
    if not axes:
        return spec_tree
    dp = axes if len(axes) > 1 else axes[0]
    sizes = axis_sizes(mesh)
    dp_size = math.prod(sizes[a] for a in axes)

    def up(leaf, spec):
        entries = list(spec) + [None] * (len(leaf.shape) - len(spec))
        if any(e is not None for e in entries):
            return spec
        dims = [(d, i) for i, d in enumerate(leaf.shape) if d % dp_size == 0]
        if not dims:
            return spec
        entries[max(dims)[1]] = dp
        return tuple(entries)

    return tree_map(up, abstract_tree, spec_tree)
