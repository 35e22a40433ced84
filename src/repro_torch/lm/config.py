"""Architecture + shape-cell configuration (port of ``repro/lm/config.py``).

A field-for-field copy of the reference's pure dataclasses, kept here so
the port never imports ``repro``.  ``ArchConfig`` is the declarative
description ``lm/model.py`` builds networks from; ``configs/<id>.py``
instantiates one per ported architecture.  Fields the port does not run
yet (MoE, recurrent blocks, encoder-decoder, sharding knobs) are kept so
configs compare equal with the reference's.

Block pattern
-------------
``block_pattern`` lists temporal-mixing block types cycled over layers:
  "attn"       full causal self-attention (GQA)
  "local_attn" sliding-window attention (window)
  "rglru"      Griffin RG-LRU recurrent block (+ short conv)
  "rwkv6"      RWKV-6 'Finch' time-mix (data-dependent decay)
Every block is followed by its channel-mixing layer (FFN / MoE / RWKV
channel-mix) per ``ffn`` settings.  Layers are grouped into scan *segments*
of whole pattern periods (plus a remainder segment), so an 80-layer model
compiles one scan body, not 80 copies (DESIGN.md §6).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

__all__ = ["MoEConfig", "ArchConfig", "ShapeCell", "SHAPE_CELLS",
           "segments_for", "KVCacheKind"]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    num_shared: int = 0            # DeepSeek/Kimi-style always-on experts
    capacity_factor: float = 1.25
    router_dtype: str = "float32"
    # dispatch implementation: auto | ref | ep_psum | ep_a2a | tp
    #   ref      dense one-hot reference (tests / 1 device)
    #   ep_psum  experts sharded over 'model'; tokens replicated over 'model'
    #            inside the block; psum combine        (baseline)
    #   ep_a2a   tokens stay fully sharded; all_to_all dispatch (optimized)
    #   tp       d_ff sharded over 'model' (for num_experts < model axis)
    impl: str = "auto"


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0              # 0 -> d_model // n_heads
    act: str = "swiglu"            # swiglu | geglu | gelu_mlp | relu_sq
    norm: str = "rmsnorm"          # rmsnorm | gemma_rmsnorm | layernorm
    block_pattern: Tuple[str, ...] = ("attn",)
    window: int = 0                # local_attn window (tokens)
    moe: Optional[MoEConfig] = None
    rope_theta: float = 10_000.0
    pos_embed: str = "rope"        # rope | learned | none (rwkv)
    learned_pos_max: int = 8192    # learned-pos table size (whisper: 32k
                                   # extrapolated per DESIGN.md §5)
    mrope_sections: Optional[Tuple[int, int, int]] = None  # qwen2-vl M-RoPE
    tie_embeddings: bool = False
    embed_scale: bool = False      # gemma: scale embeddings by sqrt(d)
    logit_softcap: float = 0.0
    # recurrent blocks
    lru_width: int = 0             # rglru recurrence width (0 -> d_model)
    conv_width: int = 4            # rglru short conv
    rwkv_head_dim: int = 64
    rwkv_chunk: int = 64           # wkv chunk length (see §Perf cell A)
    rwkv_remat_chunk: bool = False  # recompute intra-chunk tensors in bwd
    # encoder-decoder (whisper): encoder layers + fixed encoder context
    encoder_layers: int = 0
    encoder_ctx: int = 0           # e.g. 1500 audio frames
    # modality frontend stub: inputs are precomputed embeddings, not tokens
    embedding_inputs: bool = False
    # numerics / execution
    dtype: str = "bfloat16"
    attn_chunk: int = 1024         # query-chunked attention block size
    remat: bool = True
    scan_layers: bool = True
    seq_shard: bool = True         # Megatron-SP style residual sharding
    grad_accum: int = 1
    # the paper's technique (radix serving): none | radix
    quant: str = "none"
    radix_steps: int = 4           # T (activation/KV bits); weights int8
    radix_kv: bool = True          # radix-quantized KV cache when quant=radix
    radix_kv_pack: bool = False    # pack two T<=4 levels per byte (§Perf C2)
    # kernel routing: run radix matmuls and packed decode attention through
    # the radix kernels (CUDA on the card) instead of their plain versions
    use_kernel: bool = False       # route maybe_radix_matmul via kernels.ops
    kernel_autotune: bool = False  # consult the autotune winner table
    kernel_dataflow: str = "bitserial"  # in-kernel plane schedule
    radix_attn: bool = False       # also radix-quantize QKV/out projections
    packed_attn: bool = False      # decode attention directly on packed KV

    # ---- derived ----------------------------------------------------------

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def layer_types(self) -> Tuple[str, ...]:
        p = self.block_pattern
        return tuple(p[i % len(p)] for i in range(self.n_layers))

    @property
    def is_subquadratic(self) -> bool:
        """True iff no block attends over the full sequence (long_500k OK)."""
        return "attn" not in self.layer_types

    def _ffn_params(self) -> int:
        d = self.d_model
        if self.moe:
            m = self.moe
            gates = 3 if self.act in ("swiglu", "geglu") else 2
            routed = m.num_experts * gates * d * m.d_ff_expert
            shared = m.num_shared * gates * d * m.d_ff_expert
            return routed + shared + d * m.num_experts
        gates = 3 if self.act in ("swiglu", "geglu") else 2
        return gates * d * self.d_ff

    def _pattern_params(self) -> int:
        d, hd = self.d_model, self.hd
        total = 0
        for t in self.layer_types:
            if t in ("attn", "local_attn"):
                total += d * (self.n_heads * hd) + 2 * d * (self.n_kv_heads * hd)
                total += self.n_heads * hd * d
            elif t == "rglru":
                w = self.lru_width or d
                total += 2 * d * w + w * d + self.conv_width * w + 3 * w
            elif t == "rwkv6":
                total += 6 * d * d + 2 * d
            total += self._ffn_params() + 2 * d
        return total

    def params_total(self) -> int:
        d, hd = self.d_model, self.hd
        attn_p = d * (self.n_heads * hd) + 2 * d * (self.n_kv_heads * hd) \
            + self.n_heads * hd * d
        extra = 0
        if self.encoder_layers:     # whisper: encoder stack + decoder cross-attn
            extra += self.encoder_layers * (attn_p + self._ffn_params() + 2 * d)
            extra += self.n_layers * (attn_p + d)
        return self._pattern_params() + extra + self.vocab * self.d_model * (
            1 if self.tie_embeddings else 2)

    def params_active(self) -> int:
        """Active parameters per token (MoE: top_k + shared experts only)."""
        if not self.moe:
            return self.params_total()
        m = self.moe
        gates = 3 if self.act in ("swiglu", "geglu") else 2
        inactive = (m.num_experts - m.top_k) * gates * self.d_model * m.d_ff_expert
        return self.params_total() - inactive * self.n_layers


class KVCacheKind:
    FULL = "full"          # full-sequence causal KV
    WINDOW = "window"      # sliding window (local_attn): cache capped
    RECURRENT = "recurrent"  # O(1) state (rglru / rwkv6)


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str              # train | prefill | decode

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


SHAPE_CELLS = {
    "train_4k": ShapeCell("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524_288, 1, "decode"),
}


def segments_for(cfg: ArchConfig) -> Tuple[Tuple[Tuple[str, ...], int], ...]:
    """Decompose layers into (pattern, repeat) scan segments.

    ("rglru","rglru","attn") x 26 layers -> ((r,r,a), 8), ((r,r), 1).
    Dense 80L -> ((attn,), 80).  Each segment compiles ONE scan body.
    """
    p = cfg.block_pattern
    full, rem = divmod(cfg.n_layers, len(p))
    segs = []
    if full:
        segs.append((tuple(p), full))
    if rem:
        segs.append((tuple(p[:rem]), 1))
    return tuple(segs)
