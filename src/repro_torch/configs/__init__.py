"""Architecture config registry (port of ``repro/configs/__init__.py``).

Each ported LM architecture has a module exporting ``ARCH`` (the
published configuration) and ``SMOKE`` (a reduced same-family config for
CPU tests), equal field for field to the reference's: all ten of its LM
archs (dense GQA, RecurrentGemma, RWKV-6, the MoE archs Grok-1 and
Kimi-K2, the encoder-decoder Whisper-medium and the embedding-input
Qwen2-VL).  The paper's own
CNNs (``lenet5``, ``vgg11``, ``fang_cnn``) register their ``make``
(``get_snn``).
"""

from __future__ import annotations

import importlib
from typing import List

LM_ARCHS: List[str] = [
    "gemma_2b",
    "glm4_9b",
    "gemma_7b",
    "deepseek_coder_33b",
    "recurrentgemma_2b",
    "rwkv6_3b",
    "grok_1_314b",
    "kimi_k2_1t_a32b",
    "whisper_medium",
    "qwen2_vl_72b",
]

SNN_ARCHS: List[str] = ["lenet5", "vgg11", "fang_cnn"]


def canon(name: str) -> str:
    return name.replace("-", "_")


def get_config(name: str, smoke: bool = False):
    """ArchConfig for an LM arch id (dashes or underscores both accepted)."""
    name = canon(name)
    if name not in LM_ARCHS:
        raise ValueError(f"unknown LM arch {name!r} (known: {LM_ARCHS})")
    mod = importlib.import_module(f"repro_torch.configs.{name}")
    return mod.SMOKE if smoke else mod.ARCH


def get_snn(name: str):
    """The ``make`` of a CNN arch id (dashes or underscores accepted)."""
    name = canon(name)
    if name not in SNN_ARCHS:
        raise ValueError(f"unknown CNN arch {name!r} (known: {SNN_ARCHS})")
    mod = importlib.import_module(f"repro_torch.configs.{name}")
    return mod.make
