"""LM path (port of ``repro/lm``).

``config.ArchConfig`` describes an architecture; ``model.py`` builds
init / train / prefill / decode from it; ``blocks.py`` holds the blocks (full,
local, non-causal and cross attention, RoPE and M-RoPE, RG-LRU, RWKV-6,
the dense FFNs); ``moe.py`` the MoE experts and their mesh dispatches; ``radix.py`` the
paper's radix encoding as a serving feature (int8 FFN weights on radix
activations, radix KV cache, packed decode attention).
"""

from repro_torch.lm.config import ArchConfig, MoEConfig, ShapeCell, SHAPE_CELLS

__all__ = ["ArchConfig", "MoEConfig", "ShapeCell", "SHAPE_CELLS"]
