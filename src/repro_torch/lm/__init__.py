"""LM serving path (port of ``repro/lm``, without MoE and the
encoder-decoder).

``config.ArchConfig`` describes an architecture; ``model.py`` builds
init / prefill / decode from it; ``blocks.py`` holds the blocks (full and
local attention, RG-LRU, RWKV-6, the dense FFNs); ``radix.py`` the
paper's radix encoding as a serving feature (int8 FFN weights on radix
activations, radix KV cache, packed decode attention).
"""

from repro_torch.lm.config import ArchConfig, MoEConfig, ShapeCell, SHAPE_CELLS

__all__ = ["ArchConfig", "MoEConfig", "ShapeCell", "SHAPE_CELLS"]
