"""Dense radix LM configurations: the weight tree drawn on the device, and
the program's ``ArchConfig`` built from the configuration file."""

from __future__ import annotations

import torch

from bench.traffic import sub_seed

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}

# configuration-file keys that are fields of the program's ArchConfig
ARCH_KEYS = ("n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim",
             "d_ff", "vocab", "act", "norm", "rope_theta", "tie_embeddings",
             "family", "dtype", "attn_chunk", "quant", "radix_steps",
             "radix_kv_pack", "packed_attn")


def params(cfg: dict, seed: int, device) -> dict:
    """The float weight tree in the program's layout (one segment of
    stacked layers), each group of leaves one draw: matrices normal with
    the program's init scales in the configuration's dtype, norm weights
    ``1 + norm_jitter * normal`` in float32."""
    g = torch.Generator(device=device).manual_seed(sub_seed(seed, 0))
    dt = _DTYPES[cfg["dtype"]]
    n, d, h, hkv, hd, f, v = (cfg["n_layers"], cfg["d_model"],
                              cfg["n_heads"], cfg["n_kv_heads"],
                              cfg["head_dim"], cfg["d_ff"], cfg["vocab"])

    def nrm(shape, scale):
        return torch.randn(shape, generator=g, device=device,
                           dtype=dt).mul_(scale)

    def norm_w(shape):
        return torch.randn(shape, generator=g, device=device).mul_(
            cfg["norm_jitter"]).add_(1.0)

    layer = {
        "ln1": {"w": norm_w((n, d))},
        "ln2": {"w": norm_w((n, d))},
        "mix": {"wq": nrm((n, d, h, hd), d ** -0.5),
                "wk": nrm((n, d, hkv, hd), d ** -0.5),
                "wv": nrm((n, d, hkv, hd), d ** -0.5),
                "wo": nrm((n, h, hd, d), (h * hd * 2 * n) ** -0.5)},
        "ffn": {"w_up": nrm((n, d, f), d ** -0.5),
                "w_down": nrm((n, f, d), (f * 2 * n) ** -0.5),
                "w_gate": nrm((n, d, f), d ** -0.5)},
    }
    return {"embed": nrm((v, d), d ** -0.5),
            "segments": ((layer,),),
            "final_norm": {"w": norm_w((d,))},
            "unembed": nrm((d, v), d ** -0.5)}


def arch(cfg: dict):
    """The program's ``ArchConfig`` of the configuration."""
    from repro_torch.lm.config import ArchConfig

    return ArchConfig(name=cfg["name"],
                      **{k: cfg[k] for k in ARCH_KEYS})

