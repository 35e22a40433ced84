#!/usr/bin/env python3
"""LM decode step time of several checkouts of this repository, one
process each, on one card.

    python3 tools/decode_ab.py ROOT [ROOT ...]

Each ``ROOT`` is a checkout's root (``git archive`` of a commit unpacked
under ``build/``, or ``.`` for this one); they run in the order given, so
give them in turns (say old, new, new, old).  Each process imports that
checkout's ``repro_torch`` and serves GLM4-9B at full width and depth
(40 layers) in bf16 at T = 4 with packed KV and packed decode attention,
as ``chip_smoke.py``'s phase 12 does, through ``Accelerator(dataflow=
"fused").compile((params, cfg), (8, 512), buckets=(64, 256))``; after a
prefill of 8 x 256 tokens it times ``LMExecutable.decode`` steps: the
median host ms of 10 steps (each ended by a synchronize, after 2 warm-up
steps, as phase 12's ``lm_timings``) and the device ms per step over 10
more steps by ``torch.profiler``.  The kernels are built once, in this
checkout, and their libraries copied into each other checkout whose
sources hash the same.  Prints one JSON line per run and writes them all
to ``build/decode_ab.json``.
"""

from __future__ import annotations

import json
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
STEPS, WARMUP, BATCH, MAX_LEN, PROMPT = 10, 2, 8, 512, 256


def child(root: Path) -> dict:
    """One checkout's decode timing (runs in its own process)."""
    import dataclasses

    import torch
    sys.path.insert(0, str(root / "src"))
    from repro_torch import api
    from repro_torch.configs import glm4_9b
    from repro_torch.lm import model
    from torch.profiler import ProfilerActivity, profile

    cfg = dataclasses.replace(glm4_9b.ARCH, radix_steps=4,
                              radix_kv_pack=True, packed_attn=True)
    params = model.init_params(torch.Generator(device="cuda").manual_seed(0),
                               cfg)
    exe = api.Accelerator(dataflow="fused", device="cuda").compile(
        (params, cfg), (BATCH, MAX_LEN), buckets=(64, 256))
    exe.warmup()
    gen = torch.Generator(device="cuda").manual_seed(41)
    prompts = torch.randint(0, cfg.vocab, (BATCH, PROMPT), generator=gen,
                            device="cuda")
    state = exe.prefill(prompts)
    tok = state["logits"].argmax(-1)[:, None]
    for _ in range(WARMUP):
        exe.decode(state, tok)
    torch.cuda.synchronize()
    host = []
    for _ in range(STEPS):
        t0 = time.perf_counter()
        exe.decode(state, tok)
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t0) * 1e3)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(STEPS):
            exe.decode(state, tok)
        torch.cuda.synchronize()
    us = sum(getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0))
             for e in prof.key_averages())
    return dict(root=str(root), host_ms=statistics.median(host),
                host_ms_all=host, device_ms=us / STEPS / 1e3 if us else None,
                layers=cfg.n_layers)


def main(argv) -> int:
    if len(argv) == 2 and argv[0] == "--child":
        print(json.dumps(child(Path(argv[1]).resolve())))
        return 0
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("decode_ab: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build

    _build.build()
    libs = sorted(_build.BUILD_DIR.glob("lib*.so"))
    rows = []
    for root in (Path(a).resolve() for a in argv):
        dst = root / "build" / "repro_torch"
        if dst != _build.BUILD_DIR:
            dst.mkdir(parents=True, exist_ok=True)
            for lib in libs:
                shutil.copy2(lib, dst / lib.name)
        out = subprocess.run([sys.executable, __file__, "--child", str(root)],
                             check=True, capture_output=True, text=True,
                             timeout=900)
        row = json.loads(out.stdout.strip().splitlines()[-1])
        print(json.dumps(row), flush=True)
        rows.append(row)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    out_dir = ROOT / "build"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "decode_ab.json").write_text(json.dumps(
        {"nvidia_smi": smi, "runs": rows}, indent=1))
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
