"""LM serving driver: an unbucketed prefill, then a decode loop over the
KV cache and recurrent state (port of ``repro/launch/serve.py``).

With ``--quant radix`` the FFN projections (and an untied unembed) run
as radix matmuls over K-major int8 levels and the KV cache stores T-bit
radix levels; on the card they run through the CUDA kernels
(``cfg.use_kernel``).  This driver serves every ported arch, and it is
the way to serve the recurrent and windowed stacks (RecurrentGemma,
RWKV-6): ``api.LMExecutable`` right-pads prompts to buckets, which their
state would absorb.  It feeds token prompts only: the encoder-decoder
(Whisper) and embedding-input (Qwen2-VL) archs take a batch dict of
embeddings through ``lm.model.prefill`` / ``decode_step``, and raise
``ValueError`` here (the reference fails there with a ``KeyError``).

Usage (on the card; add ``--device cpu`` to run the kernels' plain
versions on the CPU)::

  python -m repro_torch.launch.serve --arch recurrentgemma_2b --quant radix
  python -m repro_torch.launch.serve --arch rwkv6_3b --smoke --tokens 8
"""

from __future__ import annotations

import argparse
import dataclasses
import statistics
import time
from typing import Callable, Optional, Sequence

import torch
import torch.nn.functional as F

from repro_torch import api
from repro_torch.configs import get_config
from repro_torch.data.synthetic import synthetic_tokens
from repro_torch.lm import model

__all__ = ["check_token_arch", "generate", "main"]


def _pick(logits: torch.Tensor, greedy: bool,
          generator: Optional[torch.Generator]) -> torch.Tensor:
    """(B, V) logits -> (B, 1) next tokens."""
    logits = logits.to(torch.float32)
    if greedy:
        return logits.argmax(-1)[:, None]
    return torch.multinomial(torch.softmax(logits, dim=-1), 1,
                             generator=generator)


def check_token_arch(cfg) -> None:
    """``ValueError`` for an arch whose inputs are not token prompts."""
    if cfg.encoder_layers or cfg.embedding_inputs:
        raise ValueError(
            f"{cfg.name} takes frame or patch embeddings, not token "
            "prompts: serve encoder-decoder and embedding-input archs "
            "through repro_torch.lm.model.prefill / decode_step with a "
            "batch dict (enc_embeds / embeds)")


def generate(cfg, params, prompts, max_new: int, *, greedy: bool = True,
             generator: Optional[torch.Generator] = None,
             log: Optional[Callable[[str], None]] = None,
             return_logits: bool = False):
    """prompts (B, S0) -> (B, S0 + max_new): the prompts and their greedy
    (or sampled, from the explicit ``generator``) continuation, on the
    prompts' device.  Prefill runs once over the whole prompt and sizes
    the cache to S0 + max_new; each decode step writes the caches in
    place.  ``return_logits`` also returns every step's (B, V) logits.

    The reference's loop keeps only the first new token (its output list
    never takes the decode steps' tokens); this returns all of them, as
    its docstring says."""
    check_token_arch(cfg)
    prompts = torch.as_tensor(prompts, dtype=torch.long)
    if prompts.ndim != 2:
        raise ValueError(
            f"prompts must be (B, S0), got {tuple(prompts.shape)}")
    if max_new < 1:
        raise ValueError(f"max_new must be >= 1, got {max_new}")
    if not greedy and generator is None:
        raise ValueError("sampling (greedy=False) needs generator=")
    s0 = prompts.shape[1]
    cuda = prompts.device.type == "cuda"
    with torch.inference_mode():
        # +1 column: model._input_h consumes tokens[:, :-1]
        logits, caches = model.prefill(
            params, {"tokens": F.pad(prompts, (0, 1))}, cfg,
            max_len=s0 + max_new)
        steps = [logits]
        tok = _pick(logits, greedy, generator)
        out, times = [prompts, tok], []
        for t in range(s0, s0 + max_new - 1):
            t0 = time.perf_counter()
            logits, caches = model.decode_step(params, caches, tok, t, cfg)
            tok = _pick(logits, greedy, generator)
            if log is not None and cuda:
                torch.cuda.synchronize(prompts.device)
            times.append(time.perf_counter() - t0)
            out.append(tok)
            steps.append(logits)
    if log is not None and times:
        log(f"[serve] decode median {statistics.median(times) * 1e3:.1f} "
            f"ms/token (batch {prompts.shape[0]})")
    tokens = torch.cat(out, dim=1)
    return (tokens, steps) if return_logits else tokens


def main(argv: Optional[Sequence[str]] = None) -> torch.Tensor:
    ap = argparse.ArgumentParser(
        description="Serve an LM arch with seeded random weights: prefill "
        "synthetic prompts, then decode greedily.")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--quant", default="none", choices=["none", "radix"])
    ap.add_argument("--radix-steps", type=int, default=6)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--device", default=None,
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    device = api._resolve_device(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    check_token_arch(cfg)
    cfg = dataclasses.replace(cfg, quant=args.quant,
                              radix_steps=args.radix_steps,
                              use_kernel=device.type == "cuda")
    params = model.init_params(
        torch.Generator(device=device).manual_seed(0), cfg)
    params = model.kmajor_params(model.radixify_params(params, cfg))
    prompts = torch.as_tensor(synthetic_tokens(
        0, args.batch, args.prompt_len - 1, cfg.vocab), device=device)
    out = generate(cfg, params, prompts, args.tokens, log=print)
    print(f"[serve] generated {tuple(out.shape)} tokens; sample row:",
          out[0, -16:].tolist())
    return out


if __name__ == "__main__":
    main()
