#!/usr/bin/env python3
"""Two host-time repairs of ``chip_smoke.py`` held on the card.

    python3 tools/draw_trace_check.py

1. ``lm.model.init_params`` draws Gemma-2B's seeded tree with one
   ``normal_`` a trailing matrix into a float32 buffer, scaled and cast a
   group at a time: every leaf ``torch.equal`` to a draw of one ``randn``,
   ``mul_`` and ``copy_`` a matrix, and both draws timed.
2. ``chip_smoke.trace_kernels`` (the raw kineto events) against
   ``key_averages`` on a trace of three Gemma-2B fused decode steps: the
   same device kernels by name, their device us and counts, and the time
   each takes to read the trace.
"""

import dataclasses
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from repro_torch.configs import gemma_2b  # noqa: E402
from repro_torch.lm import model  # noqa: E402


def matrix_draw(gen, shape, scale, dtype, device):
    """The per-matrix draw: ``randn``, ``mul_``, ``copy_`` each one."""
    out = torch.empty(shape, dtype=dtype, device=device)
    mats = out.view((-1,) + tuple(shape[-2:])) if len(shape) > 2 else [out]
    for m in mats:
        m.copy_(torch.randn(m.shape, generator=gen, dtype=torch.float32,
                            device=device).mul_(scale))
    return out


def draw(cfg, nrm):
    batched, model._nrm = model._nrm, nrm
    try:
        t0 = time.perf_counter()
        tree = model.init_params(torch.Generator(device="cuda")
                                 .manual_seed(0), cfg, device="cuda")
        torch.cuda.synchronize()
        return tree, time.perf_counter() - t0
    finally:
        model._nrm = batched


def main() -> None:
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import api

    cfg = gemma_2b.ARCH
    new, t_new = draw(cfg, model._nrm)
    old, t_old = draw(cfg, matrix_draw)
    same = []
    model.tree_map(lambda a, b: same.append(torch.equal(a, b)), new, old)
    del old
    print(f"[draw] gemma-2b: {len(same)} leaves, all torch.equal "
          f"{all(same)}; {t_new:.2f} s batched, {t_old:.2f} s a matrix at "
          "a time", flush=True)

    pcfg = dataclasses.replace(cfg, radix_steps=4, radix_kv_pack=True,
                               packed_attn=True)
    exe = api.Accelerator(dataflow="fused", device="cuda").compile(
        (new, pcfg), (8, 512), buckets=(64, 256))
    prompts = torch.randint(0, cfg.vocab, (8, 256), device="cuda")
    state = exe.prefill(prompts)
    tok = state["logits"].argmax(-1)[:, None]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            exe.decode(state, tok)
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    raw = {e.key: (e.us, e.count) for e in chip_smoke.trace_kernels(prof)}
    t_raw = time.perf_counter() - t0
    t0 = time.perf_counter()
    avg = {e.key: (e.self_device_time_total, e.count)
           for e in prof.key_averages()
           if str(e.device_type).endswith("CUDA")
           and e.self_device_time_total > 0}
    t_avg = time.perf_counter() - t0
    names = set(raw) == set(avg)
    diff = max(abs(raw[k][0] - avg[k][0]) for k in raw if k in avg)
    counts = all(raw[k][1] == avg[k][1] for k in raw if k in avg)
    print(f"[trace] 3 decode steps: raw events "
          f"{sum(v[0] for v in raw.values()):.1f} device us in "
          f"{t_raw:.2f} s, key_averages "
          f"{sum(v[0] for v in avg.values()):.1f} us in {t_avg:.2f} s; the "
          f"same names {names}, max per-name difference {diff:.4f} us, the "
          f"same counts {counts}")


if __name__ == "__main__":
    main()
