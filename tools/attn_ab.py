#!/usr/bin/env python3
"""Decode attention of this checkout against another build of its kernel,
in one process on one card.

    python3 tools/attn_ab.py OTHER_radix_attn.cu

``OTHER_radix_attn.cu`` is another version of
``src/repro_torch/csrc/radix_attn.cu`` with the same C interface (for
example an earlier commit's, from ``git show``).  Both are built with
``nvcc``; at the LM decode shapes of ``chip_smoke.py`` (Gemma-2B at S =
512 packed and unpacked, and at S = 8192) each launch is held
``torch.equal`` to this checkout's kernel, then timed by profiler device
time in turns other, this, this, other.  Prints one JSON line per shape
and dataflow: device ms of each version (medians of its two turns) and
the byte bound.
"""

from __future__ import annotations

import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv) -> int:
    if len(argv) != 1:
        print(__doc__, file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("attn_ab: no CUDA device", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke as cs
    from repro_torch.kernels import _build, radix_attn as ra

    _build.build(["radix_attn"])
    lib = _build.BUILD_DIR / "libattn_other.so"
    subprocess.run([_build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                    "-o", str(lib), argv[0]], check=True)
    other = ctypes.CDLL(str(lib)).radix_decode_attn_launch
    other.argtypes, other.restype = ra._ARGTYPES, ctypes.c_int
    print(cs.nvidia_smi(), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 70)
    for name, case in (("decode", cs.ATTN_DECODE),
                       ("decode unpacked", dict(cs.ATTN_DECODE, packed=False)),
                       ("S=8192", cs.ATTN_LONG)):
        q, kq, ks, vq, vs, mask, _ = cs.attn_problem(torch, case, gen)
        args = (q, kq, ks, vq, vs, mask)
        for method in ("fused", "bitserial"):
            kw = dict(num_steps=case["t"], method=method,
                      packed=case["packed"])
            want = ra.radix_decode_attn_cuda(*args, **kw)
            plan = next(p for k, p in ra._plans.items()
                        if k[:4] == (case["t"], ra.Q_BITS, method,
                                     case["packed"])
                        and k[6][2] == q.shape and k[7][2] == kq.shape)
            out = torch.empty_like(want)

            def run_other():
                code = other(*(t.data_ptr() for t in args), out.data_ptr(),
                             plan.work, plan.count, plan.dims, plan.consts,
                             torch.cuda.current_stream().cuda_stream)
                if code:
                    raise RuntimeError(f"other kernel: CUDA error {code}")

            run_other()
            torch.cuda.synchronize()
            if not torch.equal(out, want):
                print(f"attn_ab: {name} {method}: the versions differ",
                      file=sys.stderr)
                return 1
            fns = {"other": run_other,
                   "this": lambda: ra.radix_decode_attn_cuda(*args, **kw)}
            times = {k: [] for k in fns}
            for who in ("other", "this", "this", "other"):
                times[who].append(cs.device_ms(torch, fns[who],
                                               "radix_decode_attn_kernel"))
            print(json.dumps(dict(
                shape=name, method=method,
                **{f"{k}_ms": statistics.median(t for t in v if t)
                   for k, v in times.items()},
                bound_ms=cs.attn_bound(case, mask)[0])), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
