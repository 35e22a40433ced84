"""Architecture config registry (port of ``repro/configs/__init__.py``).

Each ported architecture has a module exporting ``ARCH`` (the published
configuration) and ``SMOKE`` (a reduced same-family config for CPU
tests), equal field for field to the reference's.  Only ``gemma_2b`` is
ported; the other LM archs are listed in ROADMAP.md.
"""

from __future__ import annotations

import importlib
from typing import List

LM_ARCHS: List[str] = ["gemma_2b"]


def canon(name: str) -> str:
    return name.replace("-", "_")


def get_config(name: str, smoke: bool = False):
    """ArchConfig for an LM arch id (dashes or underscores both accepted)."""
    name = canon(name)
    if name not in LM_ARCHS:
        raise ValueError(f"arch {name!r} is not ported yet (ported: "
                         f"{LM_ARCHS})")
    mod = importlib.import_module(f"repro_torch.configs.{name}")
    return mod.SMOKE if smoke else mod.ARCH
