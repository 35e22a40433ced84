"""Model operations of each configuration, from its shapes alone.

``vgg_layers`` walks a VGG configuration file; ``vgg_macs`` and
``vgg_ops`` count its multiply-accumulates and int8 operations per
image; ``vgg_calls`` gives the work of each radix kernel call of one
batch as the compiled plan launches it.  ``lm_prefill_ops`` counts the
operations of one radix LM prefill over its true tokens, each precision
apart; ``lm_prefill_calls`` the radix products of one padded prefill."""

from __future__ import annotations

from typing import Dict, List, Tuple

from bench.work import gemm


def vgg_layers(cfg: dict) -> List[Tuple]:
    """("conv", h, w, cin, cout) at the conv's input size (3x3, stride 1,
    SAME), ("pool", h, w, c) at the pool's input size (2x2), and
    ("linear", fin, fout), in order."""
    h, w, c = cfg["input_hw"]
    out = []
    for i, cout in enumerate(cfg["conv_channels"]):
        out.append(("conv", h, w, c, cout))
        c = cout
        if i in cfg["pool_after"]:
            out.append(("pool", h, w, c))
            h, w = h // 2, w // 2
    fin = h * w * c
    for fout in list(cfg["fc_widths"]) + [cfg["num_classes"]]:
        out.append(("linear", fin, fout))
        fin = fout
    return out


def vgg_macs(cfg: dict) -> Dict[str, int]:
    """Multiply-accumulates per image of the convs and of the linears."""
    conv = lin = 0
    for layer in vgg_layers(cfg):
        if layer[0] == "conv":
            _, h, w, cin, cout = layer
            conv += h * w * 9 * cin * cout
        elif layer[0] == "linear":
            lin += layer[1] * layer[2]
    return {"conv": conv, "linear": lin}


def vgg_ops(cfg: dict) -> float:
    """Model int8 operations per image: 2 x every conv's and linear's MACs."""
    m = vgg_macs(cfg)
    return 2.0 * (m["conv"] + m["linear"])


def vgg_calls(cfg: dict, batch: int) -> List[gemm.Call]:
    """Each radix kernel call of one batch through the fused plan: a conv
    reads its input padded by one pixel a side and writes uint8 levels;
    every linear but the logits layer writes uint8 levels; each call reads
    the occupancy row."""
    calls = []
    layers = vgg_layers(cfg)
    last = max(i for i, l in enumerate(layers) if l[0] == "linear")
    for i, layer in enumerate(layers):
        if layer[0] == "conv":
            _, h, w, cin, cout = layer
            calls.append(gemm.gemm(
                "radix_conv2d", batch * h * w, 9 * cin, cout,
                x_bytes=batch * (h + 2) * (w + 2) * cin, epilogue=True,
                occupancy=True))
        elif layer[0] == "linear":
            _, fin, fout = layer
            calls.append(gemm.gemm(
                "radix_matmul", batch, fin, fout, x_bytes=batch * fin,
                epilogue=i != last, occupancy=True))
    return calls


def lm_prefill_ops(cfg: dict, length: int) -> Dict[str, float]:
    """Operations of one prompt's prefill over its ``length`` true tokens:
    ``int8`` the radix FFN products (gate, up, down a layer) and the
    untied unembed at the last position; ``bf16`` the QKV and output
    projections and causal attention (QK^T and PV over the keys at or
    before each query)."""
    d, f, v = cfg["d_model"], cfg["d_ff"], cfg["vocab"]
    h, hkv, hd, n = (cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"],
                     cfg["n_layers"])
    ffn = 2.0 * 3 * d * f * length * n
    unembed = 2.0 * d * v
    proj = 2.0 * (2 * d * h * hd + 2 * d * hkv * hd) * length * n
    attn = 2.0 * 2 * h * hd * (length * (length + 1) / 2) * n
    return {"int8": ffn + unembed, "bf16": proj + attn}


def lm_prefill_calls(cfg: dict, batch: int, bucket: int) -> List[gemm.Call]:
    """The radix products of one prefill at the padded ``batch x bucket``
    rows: gate, up and down a layer (int32 out, no occupancy row), and the
    unembed over one row a prompt."""
    d, f, v = cfg["d_model"], cfg["d_ff"], cfg["vocab"]
    m = batch * bucket
    per_layer = [gemm.gemm("radix_matmul", m, d, f, x_bytes=m * d,
                           epilogue=False, occupancy=False)] * 2 + [
        gemm.gemm("radix_matmul", m, f, d, x_bytes=m * f, epilogue=False,
                  occupancy=False)]
    return per_layer * cfg["n_layers"] + [gemm.gemm(
        "radix_matmul", batch, d, v, x_bytes=batch * d, epilogue=False,
        occupancy=False)]
