#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

It builds the CUDA kernels from ``src/repro_torch/csrc`` and runs:

1. the build of all four kernels (one ``nvcc`` each, in parallel);
2. each kernel against its plain PyTorch version on the card:
   - ``radix_conv2d`` / ``radix_matmul`` at every distinct conv/linear
     shape of VGG-11 (224 x 224, batch 8) and LeNet-5 (full width), both
     dataflows, epilogue on and off, with an empty plane in the occupancy
     row, plus ``periods=2`` and ``out_grid="pow2"`` at one shape each;
   - ``radix_matmul`` at Gemma-2B's four FFN shapes (decode M = 8 and
     prefill M = 2048, K and N up to 16384, int8 weights up to +-127);
   - the edge cases of ``EDGES``: T = 8 levels reaching 255, int32
     (10-bit) carry levels, M = 1, ragged M, K and N, Cin = 3 and 1,
     stride 2, the small tile's split-K at decode shapes; each with both
     dataflows, epilogue on and off, with and without an occupancy row
     with an empty plane, ``periods=2`` and ``out_grid="pow2"``;
   all ``torch.equal``, the weights in the K-major layout the kernels
   read (``kernels.gemm``);
   - ``radix_decode_attn`` at B = 8, H = 8, Hkv = 1, hd = 256, S = 512,
     T = 4, packed and unpacked, both dataflows, an occupancy row with an
     empty plane and a mask set with causal prefixes, ring windows and an
     all-masked row: max |kernel - plain| <= 3e-5 * (1 + |plain|) (the
     two follow one float order, so they are expected to agree bit for
     bit; the JSON records whether they did);
   - ``spike_encode`` on a seeded 8 x 224 x 224 x 3 batch at T in
     {1, 4, 8} and three scales: ``torch.equal``;
   each row timed by CUDA events beside its bound, its plain version and a
   library yardstick, checked equal where it computes the same integers
   (fp32 cuBLAS mm, and fp32 ``F.conv2d`` with cuDNN off, TF32 off, exact
   at VGG-11's shapes; cuDNN's own fp32 conv is timed beside it with the
   count of values it gets wrong; ``torch._int_mm`` on M padded to 32 at
   Gemma's shapes; ``F.scaled_dot_product_attention`` over the
   dequantized bf16 cache, which is not the same function; none for the
   encoder);
3. LeNet-5 (full width, T=4, "or" pool) and 4. VGG-11 (full width, 224 x
   224 x 3, 100 classes, T=4, avg pool), each converted from seeded
   weights and calibration data, compiled for both dataflows with buckets
   (1, 8) and served requests of 1, 3, 8 and 11 images; logits must equal
   the port's spike-plane and packed oracles on the card, a second round
   must build no plan, and the kernels' launch counters must rise by
   (conv + linear layers) x plan executions;
5. ``quantize`` of a seeded 8 x 224 x 224 x 3 batch, on the card and on
   the CPU: equal;
6. a ``torch.profiler`` trace of three calls of every (net, dataflow,
   bucket) plan: device time by kernel name and the device's busy share;
7. the LM path: Gemma-2B at full width and depth in bf16 (seeded weights
   on the card), T = 4, ``radix_kv_pack`` and ``packed_attn`` on,
   compiled for both dataflows at (batch, max_len) = (8, 512) with
   sequence buckets (64, 256), serving 8 prompts of 200 tokens (32 new)
   and 3 prompts of 40 tokens (16 new), twice.  The second round (through
   ``generate``) must build no plan and repeat the tokens; each prefill
   must launch exactly 54 ``radix_matmul`` and each decode step 54
   ``radix_matmul`` + 18 ``radix_decode_attn``.  Logits are held against
   the port's plain path (``use_kernel=False``) on the same tokens:
   ``torch.equal`` with ``packed_attn=False``, median per-step relative L2
   <= 1e-2 and greedy agreement >= 0.9 with ``packed_attn=True``.  Prefill
   ms per bucket, decode ms per step and tokens/s by host clock, and a
   ``torch.profiler`` trace of one prefill and three decode steps;
8. the encoder path: ``ops.radix_encode`` of the phase-5 batch at T in
   {1, 4, 8} and three scales, on the card and on the CPU: equal.

Launch counters are set to 0 just before each path (phases 3-4, 7, 8)
and read just after; so are the GEMM wrappers' per-call weight-transpose
counters, which must stay 0 on the CNN and LM paths (their plans hold
K-major weights).  Every failure raises, so the script exits non-zero.
It prints the card's name and power limit (``nvidia-smi``), a
``{"kernels": [...]}`` JSON line, and last ``{"ok": true, "device":
{...}}``; the full results go to ``build/chip_smoke.json``.  It exits 1
without a CUDA device or without the repository's ``src/repro_torch``
beside it.
"""

from __future__ import annotations

import dataclasses
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 0
T = 4
BATCH = 8
BUCKETS = (1, 8)
REQUESTS = (1, 3, 8, 11)       # prefixes of one 11-image batch
HBM_BYTES_PER_S = 3.35e12      # H100 SXM, published
INT8_OPS_PER_S = 1.979e15      # H100 SXM dense int8 tensor-core peak
F32_OPS_PER_S = 6.7e13         # H100 SXM float32 outside the tensor cores
KERNEL_INFO = {
    "radix_conv2d": ("src/repro_torch/csrc/radix_conv.cu",
                     "src/repro/kernels/radix_conv.py:333"),
    "radix_matmul": ("src/repro_torch/csrc/radix_matmul.cu",
                     "src/repro/kernels/radix_matmul.py:382"),
    "radix_decode_attn": ("src/repro_torch/csrc/radix_attn.cu",
                          "src/repro/kernels/radix_attn.py:315"),
    "spike_encode": ("src/repro_torch/csrc/spike_encode.cu",
                     "src/repro/kernels/spike_encode.py:29"),
}
# Gemma-2B serving (phase 7)
LM_BATCH, LM_MAX_LEN, LM_BUCKETS = 8, 512, (64, 256)
LM_REQUESTS = ((8, 200, 32), (3, 40, 16))   # (prompts, tokens, new tokens)
ENC_STEPS, ENC_SCALES = (1, 4, 8), (1.0, 0.37, 0.813)
DEV = "cuda"                   # the device every phase runs on


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def log(*parts) -> None:
    print(*parts, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# Timing and bounds.
# ---------------------------------------------------------------------------


def sync(torch) -> None:
    if DEV == "cuda":
        torch.cuda.synchronize()


def cuda_ms(torch, fn, reps: int, warmup: int = 2) -> float:
    """Median of ``reps`` single calls, each timed by CUDA events."""
    for _ in range(warmup):
        fn()
    events = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def host_ms(torch, fn, reps: int, warmup: int = 2) -> float:
    """Median wall time of ``reps`` calls, each ended by a synchronize."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _dev_us(event) -> float:
    """A profiler event's own device time in us (0 for host events)."""
    return getattr(event, "self_device_time_total",
                   getattr(event, "self_cuda_time_total", 0))


def device_ms(torch, fn, kernel, reps: int = 20):
    """Device time per call of the kernels named ``kernel`` (every device
    kernel and fill of the call when None), from a ``torch.profiler``
    trace of ``reps`` calls: without the host's launch latency that CUDA
    events around one short call also catch.  None when the trace holds
    no device time for it."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(_dev_us(e) for e in prof.key_averages()
             if kernel is None or kernel in e.key)
    return us / reps / 1e3 if us else None


def bound(call: dict) -> tuple:
    """(ms, "bytes" | "operations"): the larger of every input read once
    plus the output written once over HBM bandwidth, and the products'
    operations over the int8 peak."""
    m, k, n = call["mkn"]
    nbytes = call["x_bytes"] + k * n + 512 + m * n * (1 if call["epi"] else 4)
    if call["epi"]:
        nbytes += 8 * n
    ops = 2.0 * m * k * n
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT8_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# The kernel calls one plan execution makes.
# ---------------------------------------------------------------------------


def kernel_calls(static, params, input_shape) -> list:
    """Every kernel launch of one plan execution, in order: kernel name,
    input shape (pre-padded), weight shape, stride, input bits (the
    avg-pool carry widens them), epilogue flag and GEMM (M, K, N)."""
    from repro_torch.core import layers

    batch, h, w, c = input_shape
    bits = T
    n_affine = sum(1 for k, _ in static if k in ("conv", "linear"))
    seen, calls = 0, []
    for (kind, cfg), p in zip(static, params):
        if kind == "conv":
            seen += 1
            kh, kw, cin, cout = p["w"].shape
            s = cfg.get("stride", 1)
            if cfg.get("padding", "VALID") == "SAME":
                h += sum(layers.same_pads(h, kh, s))
                w += sum(layers.same_pads(w, kw, s))
            ho, wo = (h - kh) // s + 1, (w - kw) // s + 1
            calls.append(dict(kernel="radix_conv2d", x=(batch, h, w, cin),
                              w=(kh, kw, cin, cout), stride=s, bits=bits,
                              epi=seen < n_affine,
                              mkn=(batch * ho * wo, kh * kw * cin, cout)))
            h, w, c, bits = ho, wo, cout, T
        elif kind == "linear":
            seen += 1
            fin, fout = p["w"].shape
            calls.append(dict(kernel="radix_matmul", x=(batch, fin),
                              w=(fin, fout), stride=1, bits=bits,
                              epi=seen < n_affine, mkn=(batch, fin, fout)))
            bits = T
        elif kind == "pool":
            h, w = h // cfg["window"], w // cfg["window"]
            if cfg.get("mode", "or") == "avg":
                bits = layers.sum_pool_bits(bits, cfg["window"])
    for call in calls:
        call["x_bytes"] = math.prod(call["x"]) * (1 if call["bits"] <= 8
                                                  else 4)
    return calls


def _shape_key(call) -> tuple:
    return (call["kernel"], call["x"], call["w"], call["stride"],
            call["bits"], call["epi"])


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions.
# ---------------------------------------------------------------------------


def _kernel_fns() -> dict:
    """kernel name -> (kernel wrapper, plain version, K-major weight
    preparation), both called with ``kmajor=True`` on prepared weights."""
    from repro_torch.kernels import gemm
    from repro_torch.kernels.radix_conv import (radix_conv2d_cuda,
                                                radix_conv2d_plain)
    from repro_torch.kernels.radix_matmul import (radix_matmul_cuda,
                                                  radix_matmul_plain)

    return {"radix_conv2d": (radix_conv2d_cuda, radix_conv2d_plain,
                             gemm.conv_kmajor),
            "radix_matmul": (radix_matmul_cuda, radix_matmul_plain,
                             gemm.matmul_kmajor)}


def phase_kernels(torch, nets: dict, results: dict) -> None:
    from repro_torch.kernels import ops

    fns = _kernel_fns()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    dev = torch.device("cuda")
    seen = {}
    rows = []
    err = {k: 0 for k in fns}
    extra_done = set()
    for net_name, calls in nets.items():
        for call in calls:
            key = _shape_key(call)
            if key in seen:
                continue
            kernel_fn, plain_fn, prep = fns[call["kernel"]]
            bits = call["bits"]
            # the top plane stays empty: the occupancy row gates a plane
            x = torch.randint(0, 1 << (bits - 1), call["x"], generator=gen,
                              device=dev).to(
                torch.uint8 if bits <= 8 else torch.int32)
            w_raw = torch.randint(-3, 4, call["w"], generator=gen,
                                  device=dev).to(torch.int8)
            wq = prep(w_raw)
            n = call["w"][-1]
            bias = torch.randint(-64, 64, (1, n), generator=gen, device=dev,
                                 dtype=torch.int32)
            mult = torch.rand((1, n), generator=gen, device=dev) * 0.02
            occ = ops.plane_occupancy(x, bits)[0]
            check(int(occ[0, bits - 1]) == 0 and int(occ[0, :bits].sum())
                  == bits - 1, f"{key}: occupancy row {occ[0, :bits]}")
            base = dict(num_steps=bits, occupancy=occ, out_steps=T,
                        kmajor=True)
            if call["kernel"] == "radix_conv2d":
                base["stride"] = call["stride"]
            variants = [dict(method=m, **e) for m in ("fused", "bitserial")
                        for e in ({}, dict(bias=bias, mult=mult))]
            if call["kernel"] not in extra_done and call["epi"]:
                extra_done.add(call["kernel"])
                variants += [
                    dict(method="bitserial", periods=2, bias=bias, mult=mult),
                    dict(method="fused", out_grid="pow2", bias=bias,
                         mult=mult),
                    dict(method="bitserial", out_grid="pow2", bias=bias,
                         mult=mult)]
            for v in variants:
                got = kernel_fn(x, wq, **base, **v)
                want = plain_fn(x, wq, **base, **v)
                torch.cuda.synchronize()
                diff = int((got.long() - want.long()).abs().max())
                err[call["kernel"]] = max(err[call["kernel"]], diff)
                check(torch.equal(got, want),
                      f"{call['kernel']} {key} {v.get('method')} "
                      f"epi={'mult' in v} periods={v.get('periods', 1)} "
                      f"grid={v.get('out_grid', 'dense')}: max |diff| {diff}")
            epi = dict(bias=bias, mult=mult) if call["epi"] else {}
            row = dict(net=net_name, kernel=call["kernel"], x=call["x"],
                       w=call["w"], stride=call["stride"], bits=bits,
                       epi=call["epi"], mkn=call["mkn"],
                       variants_checked=len(variants))
            row["bound_ms"], row["bound_by"] = bound(call)
            row["split"] = split_of(call)
            for m in ("fused", "bitserial"):
                row[f"{m}_ms"] = cuda_ms(
                    torch, lambda: kernel_fn(x, wq, **base, method=m, **epi),
                    reps=10)
                row[f"plain_{m}_ms"] = cuda_ms(
                    torch, lambda: plain_fn(x, wq, **base, method=m, **epi),
                    reps=3, warmup=1)
            row["fused_device_ms"] = device_ms(
                torch, lambda: kernel_fn(x, wq, **base, method="fused",
                                         **epi), None)
            row["ms"] = row["fused_device_ms"] or row["fused_ms"]
            row["bound_share"] = row["bound_ms"] / row["ms"]
            row["library_ms"] = float_library_ms(torch, call, x, w_raw,
                                                 kernel_fn(
                                                     x, wq, **dict(
                                                         base,
                                                         occupancy=None),
                                                     method="fused"), row)
            seen[key] = row
            rows.append(row)
            log(f"[kernel] {net_name:6s} {call['kernel']:12s} x={call['x']} "
                f"w={call['w']} s={call['stride']} bits={bits} "
                f"epi={call['epi']}: fused {row['fused_ms']:.4f} ms "
                f"({row['ms']:.4f} on the device), "
                f"bitserial {row['bitserial_ms']:.4f} ms, plain "
                f"{row['plain_fused_ms']:.4f}/{row['plain_bitserial_ms']:.4f}"
                f" ms, bound {row['bound_ms']:.4f} ms ({row['bound_by']}, "
                f"{100 * row['bound_share']:.1f}% of it), split "
                f"{row['split']}, library {row['library_ms']} ms "
                f"({row.get('library_device_ms')} on the device)"
                + (f" (cuDNN fp32 {row['cudnn_f32_ms']:.4f} ms, "
                   f"{row['cudnn_f32_mismatch']} values off by up to "
                   f"{row['cudnn_f32_max_diff']})"
                   if "cudnn_f32_ms" in row else ""))
    check({"radix_conv2d", "radix_matmul"} <= extra_done,
          "periods=2 / pow2 not covered for both kernels")
    results["edge_cases"] = phase_edges(torch, gen, err)
    results["kernel_rows"] = rows
    results["max_abs_err"] = err
    results["seen"] = seen


# Edge cases off (or at the rim of) the main path's shapes: (kernel, input
# shape, weight shape, stride, bits, level dtype, what it covers).  bits > 8
# are int32 levels (the avg-pool carry outgrows a byte at T >= 7: 10 bits
# at T = 8); levels are drawn over all 2^bits values, so T = 8 reaches 255.
EDGES = (
    ("radix_matmul", (1, 25088), (25088, 4096), 1, 8,
     "M = 1, VGG-11 fc1 at bucket 1: small tile, split-K, T = 8"),
    ("radix_matmul", (8, 16384), (16384, 2048), 1, 8,
     "Gemma-2B w_down at decode: split-K, T = 8 levels to 255"),
    ("radix_matmul", (13, 333), (333, 70), 1, 6,
     "ragged K and N, small tile, byte loader (K % 16 != 0)"),
    ("radix_matmul", (77, 1000), (1000, 300), 1, 8,
     "ragged M, K and N on the large tile"),
    ("radix_matmul", (8, 400), (400, 120), 1, 10,
     "int32 10-bit carry levels, byte groups"),
    ("radix_matmul", (40, 333), (333, 70), 1, 10,
     "int32 levels, ragged, large tile"),
    ("radix_matmul", (100, 500), (500, 40), 1, 8,
     "N <= 64: the 64-column tile, byte loader (K % 16 != 0)"),
    ("radix_conv2d", (8, 34, 34, 3), (3, 3, 3, 64), 1, 8,
     "Cin = 3 (byte gather), T = 8"),
    ("radix_conv2d", (8, 32, 32, 1), (5, 5, 1, 6), 1, 4,
     "Cin = 1, LeNet conv1"),
    ("radix_conv2d", (8, 14, 14, 6), (5, 5, 6, 16), 1, 10,
     "int32 10-bit carry levels"),
    ("radix_conv2d", (2, 17, 19, 32), (3, 3, 32, 48), 2, 8,
     "stride 2, ragged M and N, cp.async gather (Cin % 16 == 0), T = 8"),
    ("radix_conv2d", (1, 6, 6, 16), (3, 3, 16, 24), 1, 4,
     "M = 16 output pixels: small tile, split-K"),
)


def split_of(call) -> int:
    """K splits of the launch at this call's GEMM shape."""
    from repro_torch.kernels import gemm

    m, k, n = call["mkn"]
    return gemm.plan(m, n, k, gemm.sm_count(0)).split


def phase_edges(torch, gen, err: dict) -> list:
    """Each edge case against the plain version, ``torch.equal``: both
    dataflows, epilogue on and off, an occupancy row with an empty plane
    and none, ``periods=2`` and ``out_grid="pow2"``."""
    from repro_torch.kernels import ops

    fns = _kernel_fns()
    dev = torch.device("cuda")
    done = []
    for kname, xs, ws, stride, bits, what in EDGES:
        kernel_fn, plain_fn, prep = fns[kname]
        x = torch.randint(0, 1 << bits, xs, generator=gen, device=dev,
                          dtype=torch.int32)
        x &= ~(1 << (bits // 2))                   # plane bits // 2 empty
        x = x.to(torch.uint8 if bits <= 8 else torch.int32)
        wq = prep(torch.randint(-127, 128, ws, generator=gen, device=dev,
                                dtype=torch.int32).to(torch.int8))
        n = ws[-1]
        bias = torch.randint(-64, 64, (1, n), generator=gen, device=dev,
                             dtype=torch.int32)
        mult = torch.rand((1, n), generator=gen, device=dev) * 4e-5
        occ = ops.plane_occupancy(x, bits)[0]
        check(int(occ[0, bits // 2]) == 0, f"{kname} {what}: occupancy")
        base = dict(num_steps=bits, out_steps=min(bits, 8), kmajor=True)
        if kname == "radix_conv2d":
            base["stride"] = stride
        epi = dict(bias=bias, mult=mult)
        variants = [dict(method=m, occupancy=o, **e)
                    for m in ("fused", "bitserial") for o in (None, occ)
                    for e in ({}, epi)]
        variants += [dict(method="bitserial", periods=2, occupancy=occ),
                     dict(method="bitserial", periods=2, occupancy=occ, **epi),
                     dict(method="fused", out_grid="pow2", occupancy=occ,
                          **epi),
                     dict(method="bitserial", out_grid="pow2", occupancy=occ,
                          **epi)]
        levels = set()
        for v in variants:
            got = kernel_fn(x, wq, **base, **v)
            want = plain_fn(x, wq, **base, **v)
            torch.cuda.synchronize()
            diff = int((got.long() - want.long()).abs().max())
            err[kname] = max(err[kname], diff)
            check(torch.equal(got, want),
                  f"{kname} edge '{what}' {v.get('method')} "
                  f"epi={'mult' in v} periods={v.get('periods', 1)} "
                  f"grid={v.get('out_grid', 'dense')} occ="
                  f"{v['occupancy'] is not None}: max |diff| {diff}")
            if "mult" in v:
                levels |= set(torch.unique(got).tolist())
        done.append(dict(kernel=kname, x=xs, w=ws, stride=stride, bits=bits,
                         what=what, variants=len(variants),
                         epilogue_levels=len(levels),
                         max_level=int(x.max())))
        log(f"[edge] {kname} {xs} x {ws} s{stride} bits={bits} ({what}): "
            f"{len(variants)} variants equal; max level {int(x.max())}, "
            f"{len(levels)} distinct epilogue levels")
    return done


def float_library_ms(torch, call, x, wq, want, row) -> float:
    """The library yardstick: one fp32 PyTorch call (TF32 off) computing
    the same integer product, exact while every sum stays below 2^24
    (VGG-11: at most 3*3*512 taps x level 63 x |w| 3 = 870,912) and the
    call forms plain sums.  cuBLAS ``torch.mm`` for a linear layer;
    ``F.conv2d`` with cuDNN disabled (PyTorch's im2col + cuBLAS GEMM) for
    a conv, because cuDNN's own fp32 choice may be a Winograd/FFT
    transform, which is not exact: its time and mismatch count are kept
    beside (``cudnn_f32_*``).  ``wq`` is the reference-layout weight and
    ``want`` the kernel's raw int32 accumulator; timed without the
    epilogue; None where the library's result is not equal."""
    import torch.nn.functional as F

    check(not (torch.backends.cuda.matmul.allow_tf32
               or torch.backends.cudnn.allow_tf32), "TF32 is on")
    if call["kernel"] == "radix_matmul":
        a, b = x.float(), wq.float()

        def fn():
            return torch.mm(a, b)

        def as_int(y):
            return y.to(torch.int32)
    else:
        a = x.float().permute(0, 3, 1, 2)            # NHWC as channels_last
        wt = wq.float().permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)

        def cudnn():
            return F.conv2d(a, wt, stride=call["stride"])

        def fn():
            with torch.backends.cudnn.flags(enabled=False):
                return F.conv2d(a, wt, stride=call["stride"])

        def as_int(y):
            return y.permute(0, 2, 3, 1).to(torch.int32)
        diff = (as_int(cudnn()) - want).abs()
        row["cudnn_f32_mismatch"] = int((diff > 0).sum())
        row["cudnn_f32_max_diff"] = int(diff.max())
        row["cudnn_f32_ms"] = cuda_ms(torch, cudnn, reps=10)
    got = as_int(fn())
    if not torch.equal(got, want):
        log(f"[kernel] fp32 library {call['kernel']} {call['x']}: "
            f"{int((got != want).sum())} values differ from the kernel; "
            "no exact library yardstick at this shape")
        return None
    row["library_device_ms"] = device_ms(torch, fn, None)
    return cuda_ms(torch, fn, reps=10)


def int_mm_ms(torch, x, wq, want, row) -> float:
    """``torch._int_mm`` (int8 x int8 -> int32) on the same product, M
    padded to 32 rows (it refuses M <= 16), on the reference-layout
    weight ``wq``; checked equal to the kernel's accumulator ``want``.
    Its device time goes to ``row["library_device_ms"]``."""
    m, k = x.shape
    a = torch.zeros((max(m, 32), k), dtype=torch.int8, device=x.device)
    a[:m] = x.to(torch.int8)
    check(torch.equal(torch._int_mm(a, wq)[:m], want),
          f"torch._int_mm disagrees with the kernel at {tuple(x.shape)} x "
          f"{tuple(wq.shape)}")
    row["library_device_ms"] = device_ms(torch, lambda: torch._int_mm(a, wq),
                                         None)
    return cuda_ms(torch, lambda: torch._int_mm(a, wq), reps=10)


# ---------------------------------------------------------------------------
# Phase 2, LM half: Gemma-2B's matmul shapes, decode attention, encoder.
# ---------------------------------------------------------------------------


def lm_matmul_calls(cfg) -> list:
    """The FFN products of one prefill (M = batch * top bucket) and one
    decode step (M = batch): w_gate/w_up (d -> d_ff), w_down (d_ff -> d)."""
    d, f = cfg.d_model, cfg.d_ff
    calls = []
    for m in (LM_BATCH, LM_BATCH * LM_BUCKETS[-1]):
        for k, n in ((d, f), (f, d)):
            calls.append(dict(kernel="radix_matmul", x=(m, k), w=(k, n),
                              stride=1, bits=T, epi=False, mkn=(m, k, n),
                              x_bytes=m * k))
    return calls


def phase_lm_matmul(torch, cfg, results) -> None:
    from repro_torch.kernels import gemm
    from repro_torch.kernels.radix_matmul import (radix_matmul_cuda,
                                                  radix_matmul_plain)

    gen = torch.Generator(device=DEV).manual_seed(SEED + 10)
    dev = torch.device(DEV)
    rows = []
    for call in lm_matmul_calls(cfg):
        x = torch.randint(0, 1 << T, call["x"], generator=gen, device=dev,
                          dtype=torch.int32).to(torch.uint8)
        w_raw = torch.randint(-127, 128, call["w"], generator=gen,
                              device=dev, dtype=torch.int32).to(torch.int8)
        wq = gemm.matmul_kmajor(w_raw)
        kw = dict(num_steps=T, kmajor=True)
        row = dict(net="gemma-2b", kernel="radix_matmul", x=call["x"],
                   w=call["w"], bits=T, epi=False, mkn=call["mkn"],
                   split=split_of(call))
        for m in ("fused", "bitserial"):
            got = radix_matmul_cuda(x, wq, method=m, **kw)
            want = radix_matmul_plain(x, wq, method=m, **kw)
            sync(torch)
            check(torch.equal(got, want), f"radix_matmul {call['x']} x "
                  f"{call['w']} {m}: max |diff| "
                  f"{int((got.long() - want.long()).abs().max())}")
            row[f"{m}_ms"] = cuda_ms(
                torch, lambda: radix_matmul_cuda(x, wq, method=m, **kw),
                reps=10)
            row[f"plain_{m}_ms"] = cuda_ms(
                torch, lambda: radix_matmul_plain(x, wq, method=m, **kw),
                reps=3, warmup=1)
            if m == "fused":
                fused_out = got
        row["bound_ms"], row["bound_by"] = bound(call)
        row["fused_device_ms"] = device_ms(
            torch, lambda: radix_matmul_cuda(x, wq, method="fused", **kw),
            None)
        row["ms"] = row["fused_device_ms"] or row["fused_ms"]
        row["bound_share"] = row["bound_ms"] / row["ms"]
        row["library_ms"] = int_mm_ms(torch, x, w_raw, fused_out, row)
        rows.append(row)
        log(f"[kernel] gemma  radix_matmul x={call['x']} w={call['w']}: "
            f"fused {row['fused_ms']:.4f} ms ({row['ms']:.4f} on the "
            f"device), bitserial "
            f"{row['bitserial_ms']:.4f} ms, plain "
            f"{row['plain_fused_ms']:.4f}/{row['plain_bitserial_ms']:.4f} "
            f"ms, bound {row['bound_ms']:.4f} ms ({row['bound_by']}, "
            f"{100 * row['bound_share']:.1f}% of it), split {row['split']}, "
            f"torch._int_mm {row['library_ms']:.4f} ms "
            f"({row['library_device_ms']} on the device)")
    results["lm_matmul_rows"] = rows


def attn_problem(torch, cfg, s_len: int, gen):
    """A decode-attention problem at the LM's decode shape: queries, a
    T-bit cache with plane 2 empty in K and V, per-token scales, and a
    mask set (causal prefixes, ring windows, an all-masked row)."""
    from repro_torch.lm import blocks

    dev = torch.device(DEV)
    b, h, hkv, hd = LM_BATCH, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = torch.randn((b, h, hd), generator=gen, device=dev)
    lv = [torch.randint(0, 1 << T, (b, s_len, hkv, hd), generator=gen,
                        device=dev, dtype=torch.int32) & ~0b100
          for _ in range(2)]
    scales = [torch.rand((b, s_len, hkv), generator=gen, device=dev) + 0.25
              for _ in range(2)]
    rows = [blocks.decode_mask(p, s_len, 0, device=dev)[0]
            for p in (0, 199, 300, s_len - 1)]
    rows += [blocks.decode_mask(p, s_len, s_len, device=dev)[0]
             for p in (100, s_len + 37, 3 * s_len - 5)]
    rows.append(torch.zeros(s_len, dtype=torch.bool, device=dev))
    return q, lv, scales, torch.stack(rows[:b])


def _pack4(x):
    """(..., hd) levels < 16 -> (..., hd // 2), hi nibble = even dim."""
    return (x[..., 0::2] << 4) | x[..., 1::2]


def phase_attn(torch, cfg, results) -> None:
    """radix_decode_attn (through ``ops.radix_decode_attention``, as the
    LM calls it) against its plain version; times of the kernel alone."""
    import torch.nn.functional as F

    from repro_torch.kernels import ops
    from repro_torch.kernels import radix_attn as ra

    gen = torch.Generator(device=DEV).manual_seed(SEED + 11)
    s_len, hd = LM_MAX_LEN, cfg.hd
    q, (kl, vl), (ks, vs), mask = attn_problem(torch, cfg, s_len, gen)
    check(not mask[-1].any() and bool(mask[0, 0]), "mask set")
    occ = ops.plane_occupancy(kl, T)[1]
    check(int(occ[2]) == 0 and int(occ.sum()) == T - 1,
          f"occupancy row {occ.tolist()}: plane 2 should be empty")
    rows, err = [], 0.0
    for packed in (True, False):
        kq = (_pack4(kl) if packed else kl).to(torch.uint8)
        vq = (_pack4(vl) if packed else vl).to(torch.uint8)
        for method in ("fused", "bitserial"):
            kw = dict(packed=packed, method=method)
            got = ops.radix_decode_attention(q, kq, ks, vq, vs, mask, T, **kw)
            want = ops.radix_decode_attention(
                q, kq, ks, vq, vs, mask, T, **kw,
                config=ops.KernelConfig(impl="plain"))
            sync(torch)
            diff = (got - want).abs()
            err = max(err, float(diff.max()))
            check(bool(torch.isfinite(got).all()), "non-finite attention")
            check(bool((diff <= 3e-5 * (1 + want.abs())).all()),
                  f"radix_decode_attn packed={packed} {method}: max |diff| "
                  f"{float(diff.max())}")
            check(not got[-1].any(), "all-masked row is not 0")
            # the kernel alone, on the wrapper's prepared operands
            n, g = LM_BATCH * cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads
            qq, qs = ra.quantize_q(q)
            args = (qq.reshape(n, g, hd), qs.reshape(n, g),
                    kq.reshape(n, s_len, -1), ks.reshape(n, s_len),
                    vq.reshape(n, s_len, -1), vs.reshape(n, s_len),
                    mask.to(torch.int32),
                    ops.plane_occupancy(ops._nibble_union(kq) if packed
                                        else kq, T)[0],
                    ops.plane_occupancy(ops._nibble_union(vq) if packed
                                        else vq, T)[0])
            akw = dict(num_steps=T, hd=hd, method=method, packed=packed)
            check(torch.equal(ra.radix_decode_attn_cuda(*args, **akw), got),
                  "kernel call differs from the wrapper's")
            row = dict(kernel="radix_decode_attn", packed=packed,
                       method=method, shape=(LM_BATCH, cfg.n_heads,
                                             cfg.n_kv_heads, hd, s_len),
                       max_abs_err=float(diff.max()),
                       bitwise_equal=bool(torch.equal(got, want)))
            row["call_ms"] = cuda_ms(
                torch, lambda: ra.radix_decode_attn_cuda(*args, **akw),
                reps=20)
            row["device_ms"] = device_ms(
                torch, lambda: ra.radix_decode_attn_cuda(*args, **akw),
                "radix_decode_attn_kernel")
            row["ms"] = row["device_ms"] or row["call_ms"]
            row["plain_ms"] = cuda_ms(
                torch, lambda: ra.radix_decode_attn_plain(*args, **akw),
                reps=3, warmup=1)
            row["wrapper_ms"] = cuda_ms(
                torch, lambda: ops.radix_decode_attention(
                    q, kq, ks, vq, vs, mask, T, **kw), reps=10)
            nbytes = sum(a.numel() * a.element_size() for a in args)
            nbytes += n * g * hd * 4                      # the output
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            # QK^T at the int8 peak, PV at the float32 peak
            ops_qk = 2.0 * n * g * s_len * hd
            t_ops = (ops_qk / INT8_OPS_PER_S + ops_qk / F32_OPS_PER_S) * 1e3
            row["bound_ms"], row["bound_by"] = (
                (t_bytes, "bytes") if t_bytes >= t_ops
                else (t_ops, "operations"))
            row["bytes"] = nbytes
            rows.append(row)
    # yardstick: SDPA over the dequantized bf16 cache (not the same
    # function: the query is not quantized and the cache is float)
    b, h, hkv = LM_BATCH, cfg.n_heads, cfg.n_kv_heads
    lvl = (1 << T) - 1
    kd = ((kl.float() * (2.0 / lvl) - 1.0) * ks[..., None]).to(
        torch.bfloat16).transpose(1, 2).contiguous()      # (B, Hkv, S, hd)
    vd = ((vl.float() * (2.0 / lvl) - 1.0) * vs[..., None]).to(
        torch.bfloat16).transpose(1, 2).contiguous()
    qb = q.to(torch.bfloat16)[:, :, None, :]              # (B, H, 1, hd)
    mb = torch.stack([mask[1]] * b)[:, None, None, :]     # no empty row
    try:
        def sdpa():
            return F.scaled_dot_product_attention(qb, kd, vd, attn_mask=mb,
                                                  enable_gqa=True)
        sdpa()
    except TypeError:                  # a torch without enable_gqa
        kd, vd = (t.expand(b, h, s_len, hd) for t in (kd, vd))

        def sdpa():
            return F.scaled_dot_product_attention(qb, kd, vd, attn_mask=mb)
    sdpa_ms = cuda_ms(torch, sdpa, reps=20)
    for row in rows:
        row["library_ms"] = sdpa_ms
        log(f"[kernel] gemma  radix_decode_attn packed={row['packed']!s:5s}"
            f" {row['method']:9s} B=8 H=8 Hkv=1 hd=256 S={s_len}: kernel "
            f"{row['ms']:.4f} ms on the device ({row['call_ms']:.4f} ms a "
            f"call by CUDA events; wrapper with prepass "
            f"{row['wrapper_ms']:.4f} ms), plain {row['plain_ms']:.4f} ms, "
            "bound "
            f"{row['bound_ms']:.5f} ms ({row['bound_by']}), max |diff| "
            f"{row['max_abs_err']:.3g}, bit for bit equal "
            f"{row['bitwise_equal']}")
    log(f"[kernel] yardstick: SDPA over the dequantized bf16 cache "
        f"{sdpa_ms:.4f} ms (a float softmax, not the radix function)")
    results["attn_rows"] = rows
    results["max_abs_err"]["radix_decode_attn"] = err


def encode_batch(torch):
    """The seeded 8 x 224 x 224 x 3 batch of phases 2, 5 and 8 (CPU)."""
    x = torch.rand((BATCH, 224, 224, 3),
                   generator=torch.Generator().manual_seed(SEED + 3))
    return x * 1.4 - 0.2


def phase_encode_kernel(torch, results) -> None:
    from repro_torch.kernels.spike_encode import (spike_encode_cuda,
                                                  spike_encode_plain)

    x = encode_batch(torch).to(DEV).reshape(-1, 3)   # as ops.radix_encode
    rows = []
    for steps in ENC_STEPS:
        for scale in ENC_SCALES:
            kw = dict(num_steps=steps, scale=scale)
            got = spike_encode_cuda(x, **kw)
            want = spike_encode_plain(x, **kw)
            sync(torch)
            check(torch.equal(got, want), f"spike_encode T={steps} "
                  f"scale={scale}: {int((got != want).sum())} levels differ")
            if steps == T and scale == 1.0:
                row = dict(kernel="spike_encode", shape=tuple(x.shape),
                           num_steps=steps, scale=scale)
                row["call_ms"] = cuda_ms(
                    torch, lambda: spike_encode_cuda(x, **kw), reps=20)
                row["device_ms"] = device_ms(
                    torch, lambda: spike_encode_cuda(x, **kw),
                    "spike_encode_kernel")
                row["ms"] = row["device_ms"] or row["call_ms"]
                row["plain_ms"] = cuda_ms(
                    torch, lambda: spike_encode_plain(x, **kw), reps=10)
                nbytes = x.numel() * 5
                row["bound_ms"], row["bound_by"] = (
                    nbytes / HBM_BYTES_PER_S * 1e3, "bytes")
                row["library_ms"] = None   # no single PyTorch call
                rows.append(row)
                log(f"[kernel] spike_encode {tuple(x.shape)} T={steps}: "
                    f"{row['ms']:.4f} ms on the device ({row['call_ms']:.4f}"
                    f" ms a call by CUDA events), plain "
                    f"{row['plain_ms']:.4f} ms, "
                    f"bound {row['bound_ms']:.4f} ms (bytes); no library "
                    "call computes it")
    log(f"[kernel] spike_encode equals its plain version at T in "
        f"{ENC_STEPS} x scales {ENC_SCALES}")
    results["encode_rows"] = rows
    results["max_abs_err"]["spike_encode"] = 0


# ---------------------------------------------------------------------------
# Phases 3 and 4: the main path.
# ---------------------------------------------------------------------------


def _wrappers() -> dict:
    from repro_torch.kernels.radix_attn import radix_decode_attn_cuda
    from repro_torch.kernels.radix_conv import radix_conv2d_cuda
    from repro_torch.kernels.radix_matmul import radix_matmul_cuda
    from repro_torch.kernels.spike_encode import spike_encode_cuda

    return {"radix_conv2d": radix_conv2d_cuda,
            "radix_matmul": radix_matmul_cuda,
            "radix_decode_attn": radix_decode_attn_cuda,
            "spike_encode": spike_encode_cuda}


def counters() -> dict:
    return {k: fn.launches for k, fn in _wrappers().items()}


def transposes() -> dict:
    """Per-call K-major weight copies the GEMM wrappers made (given
    reference-layout weights on the card); the main paths make none."""
    w = _wrappers()
    return {k: w[k].transposes for k in ("radix_conv2d", "radix_matmul")}


def reset_counters() -> None:
    for name, fn in _wrappers().items():
        fn.launches = 0
        if name in ("radix_conv2d", "radix_matmul"):
            fn.transposes = 0


def phase_net(torch, name, static, params, hw, results) -> dict:
    """Convert, compile both dataflows, serve, check; returns the
    executables and the request batch for the profile phase."""
    from repro_torch import api

    dev = torch.device("cuda")
    rng_calib = torch.Generator().manual_seed(SEED + 1)
    rng_x = torch.Generator().manual_seed(SEED + 2)
    params = [None if p is None else {k: v.to(dev) for k, v in p.items()}
              for p in params]
    calib = torch.rand((BATCH,) + hw, generator=rng_calib).to(dev)
    t0 = time.perf_counter()
    qnet = api.convert(static, params, calib, num_steps=T)
    torch.cuda.synchronize()
    convert_s = time.perf_counter() - t0
    x = torch.rand((max(REQUESTS),) + hw, generator=rng_x).to(dev)
    t0 = time.perf_counter()
    want_snn = api.oracle(qnet, x, mode="snn")
    want_packed = api.oracle(qnet, x, mode="packed")
    torch.cuda.synchronize()
    oracle_s = time.perf_counter() - t0
    check(torch.equal(want_snn, want_packed), f"{name}: snn != packed oracle")
    check(bool(torch.isfinite(want_snn).all()), f"{name}: non-finite logits")
    # a net whose activations died would make every comparison trivial
    spread = want_snn.std(dim=0).mean()
    check(float(spread) > 0,
          f"{name}: logits do not vary across images (degenerate net)")
    n_conv = sum(1 for k, _ in static if k == "conv")
    n_lin = sum(1 for k, _ in static if k == "linear")
    out = dict(convert_s=convert_s, oracle_s=oracle_s,
               logits_shape=list(want_snn.shape),
               logits_class_std=float(spread),
               argmax_classes=int(torch.unique(want_snn.argmax(1)).numel()),
               input_scale=qnet.input_scale, dataflows={})
    exes = {}
    for dataflow in ("fused", "bitserial"):
        exe = exes[dataflow] = api.Accelerator(dataflow=dataflow).compile(
            qnet, hw, buckets=BUCKETS)
        before = counters()
        rounds = []
        for _ in range(2):
            for n in REQUESTS:
                got = exe(x[:n])
                check(tuple(got.shape) == (n, want_snn.shape[1]),
                      f"{name}/{dataflow}: logits shape {tuple(got.shape)}")
                check(torch.equal(got, want_snn[:n]),
                      f"{name}/{dataflow}: request of {n} != oracle "
                      f"(max |diff| {(got - want_snn[:n]).abs().max()})")
            rounds.append(exe.stats())
        torch.cuda.synchronize()
        after = counters()
        check(rounds[1]["compiles"] == rounds[0]["compiles"] == len(BUCKETS),
              f"{name}/{dataflow}: plans built in steady state: "
              f"{rounds[0]['compiles']} -> {rounds[1]['compiles']}")
        execs = rounds[1]["executions"]
        check(after["radix_conv2d"] - before["radix_conv2d"]
              == n_conv * execs,
              f"{name}/{dataflow}: conv launches "
              f"{after['radix_conv2d'] - before['radix_conv2d']} != "
              f"{n_conv} x {execs}")
        check(after["radix_matmul"] - before["radix_matmul"]
              == n_lin * execs,
              f"{name}/{dataflow}: matmul launches "
              f"{after['radix_matmul'] - before['radix_matmul']} != "
              f"{n_lin} x {execs}")
        buckets = {}
        for b in BUCKETS:
            plan = exe.plan_for(b)
            xb = x[:b].contiguous()
            ms = host_ms(torch, lambda: plan(xb), reps=10)
            buckets[b] = dict(ms=ms, images_per_s=b / ms * 1e3)
            log(f"[{name}] {dataflow:9s} bucket {b}: {ms:.3f} ms, "
                f"{b / ms * 1e3:.1f} images/s")
        stats = exe.stats()
        out["dataflows"][dataflow] = dict(
            executions=execs, compiles=rounds[1]["compiles"],
            launches={k: after[k] - before[k] for k in after},
            plane_passes_skipped=stats["plane_passes_skipped"],
            plane_passes_total=stats["plane_passes_total"],
            buckets=buckets)
        log(f"[{name}] {dataflow}: requests {REQUESTS} x 2 rounds equal the "
            f"oracles; {execs} executions, compiles {rounds[1]['compiles']},"
            f" launches {out['dataflows'][dataflow]['launches']}")
    log(f"[{name}] convert {convert_s:.2f} s, oracles {oracle_s:.2f} s, "
        f"logits {tuple(want_snn.shape)}, per-class std {float(spread):.4f}, "
        f"{out['argmax_classes']} distinct argmax classes")
    results[name] = out
    return dict(exes=exes, x=x)


# ---------------------------------------------------------------------------
# Phase 6: where a plan's time goes (torch.profiler).
# ---------------------------------------------------------------------------


def phase_profile(torch, runs: dict, results: dict) -> None:
    """Device time by kernel name over three calls of each (net, dataflow,
    bucket) plan, and the device's busy share: that device time over the
    unprofiled median wall time of phases 3 and 4 (the profiler slows the
    host).  Only device-side kernel events count (the CPU-side operator
    events carry their kernels' time too)."""
    from torch.profiler import ProfilerActivity, profile

    out = {}
    for name, run in runs.items():
        for dataflow, exe in run["exes"].items():
            for b in BUCKETS:
                plan, xb = exe.plan_for(b), run["x"][:b].contiguous()
                plan(xb)
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    t0 = time.perf_counter()
                    for _ in range(3):
                        plan(xb)
                    torch.cuda.synchronize()
                    wall_us = (time.perf_counter() - t0) * 1e6
                kernels = [e for e in prof.key_averages()
                           if str(e.device_type).endswith("CUDA")
                           and _dev_us(e) > 0]
                busy_us = sum(_dev_us(e) for e in kernels)
                radix_us = sum(_dev_us(e) for e in kernels
                               if "radix_" in e.key)
                key = f"{name}/{dataflow}/b{b}"
                if busy_us == 0:
                    log(f"[profile] {key}: no device time recorded "
                        "(not measured)")
                    out[key] = None
                    continue
                top = sorted(kernels, key=_dev_us, reverse=True)[:5]
                wall_ms = results[name]["dataflows"][dataflow]["buckets"][b][
                    "ms"]
                out[key] = dict(
                    profiled_wall_ms_per_call=wall_us / 3e3,
                    device_ms_per_call=busy_us / 3e3,
                    radix_kernels_ms_per_call=radix_us / 3e3,
                    other_kernels_ms_per_call=(busy_us - radix_us) / 3e3,
                    busy_share=busy_us / 3e3 / wall_ms,
                    top=[(e.key[:70], _dev_us(e) / 3e3, e.count // 3)
                         for e in top])
                log(f"[profile] {key}: device busy {busy_us / 3e3:.3f} ms/call"
                    f" = {100 * out[key]['busy_share']:.1f}% of the "
                    f"unprofiled {wall_ms:.3f} ms ({wall_us / 3e3:.3f} ms "
                    f"profiled): radix kernels "
                    f"{radix_us / 3e3:.3f} ms, other kernels "
                    f"{(busy_us - radix_us) / 3e3:.3f} ms; top: "
                    + "; ".join(f"{k} {v:.3f} ms x{c}" for k, v, c in
                                out[key]["top"]))
    results["profile"] = out


# ---------------------------------------------------------------------------
# Phase 5: quantize's float op order on the device.
# ---------------------------------------------------------------------------


def phase_quantize(torch, results) -> None:
    from repro_torch.core import encoding

    x = encode_batch(torch)
    out = {}
    for scale in (1.0, 0.37, 0.813):
        cpu = encoding.quantize(x, T, scale)
        gpu = encoding.quantize(x.cuda(), T, scale).cpu()
        check(torch.equal(cpu, gpu), f"quantize differs on the card at "
              f"scale {scale}: {(cpu != gpu).sum()} levels")
        # what dividing by a host scalar would have moved
        naive = torch.clamp(torch.floor(x.cuda() / scale * 16.0), 0, 15)
        out[scale] = int((naive.cpu().to(torch.uint8) != cpu).sum())
    log(f"[quantize] card == CPU for 8x224x224x3 at scales 1.0/0.37/0.813; "
        f"levels a host-scalar divide would move: {out}")
    results["quantize_host_scalar_mismatches"] = out


# ---------------------------------------------------------------------------
# Phase 7: the LM path (Gemma-2B serving).
# ---------------------------------------------------------------------------


def lm_prompts(torch, cfg, n: int, s0: int, seed: int):
    gen = torch.Generator(device=DEV).manual_seed(seed)
    return torch.randint(0, cfg.vocab, (n, s0), generator=gen, device=DEV)


def serve_greedy(exe, prompts, new: int) -> dict:
    """One request through ``exe.prefill`` / ``exe.decode``, greedy; keeps
    every step's logits and the launches it made."""
    import torch

    before = counters()
    state = exe.prefill(prompts)
    logits, toks = [], []
    for i in range(new):
        lg = state["logits"]
        nxt = lg.to(torch.float32).argmax(-1)
        logits.append(lg)
        toks.append(nxt)
        if i + 1 < new:
            state = exe.decode(state, nxt[:, None])
    sync(torch)
    after = counters()
    return dict(logits=logits, tokens=torch.stack(toks, 1),
                launches={k: after[k] - before[k] for k in after})


def plain_logits(model, params, cfg, prompts, tokens, bucket: int) -> list:
    """The same request through ``lm.model`` with ``cfg`` (``use_kernel``
    off: the kernels' plain versions), fed the served tokens."""
    import torch

    n, s0 = prompts.shape
    padded = torch.zeros((LM_BATCH, bucket + 1), dtype=torch.long,
                         device=prompts.device)
    padded[:n, :s0] = prompts
    with torch.inference_mode():
        lg, caches = model.prefill(params, {"tokens": padded}, cfg,
                                   max_len=LM_MAX_LEN, true_len=s0)
        out = [lg[:n]]
        tok = torch.zeros((LM_BATCH, 1), dtype=torch.long,
                          device=prompts.device)
        for i in range(tokens.shape[1] - 1):
            tok[:n, 0] = tokens[:, i]
            lg, caches = model.decode_step(params, caches, tok, s0 + i, cfg)
            out.append(lg[:n])
    return out


def compare_logits(torch, got: list, want: list) -> dict:
    errs, agree, total = [], 0, 0
    for a, b in zip(got, want):
        a64, b64 = a.to(torch.float64), b.to(torch.float64)
        errs.append(float((a64 - b64).norm() / b64.norm()))
        agree += int((a.float().argmax(-1) == b.float().argmax(-1)).sum())
        total += a.shape[0]
    return dict(median_rel_l2=statistics.median(errs), max_rel_l2=max(errs),
                greedy_agreement=agree / total,
                equal=all(torch.equal(a, b) for a, b in zip(got, want)))


def profile_lm(torch, exe, prompts) -> dict:
    """Device time by kernel name over one prefill and three decode steps
    (``torch.profiler``), and its share of the profiled wall time."""
    from torch.profiler import ProfilerActivity, profile

    out = {}
    state = exe.prefill(prompts)
    sync(torch)
    for name, fn in (("prefill", lambda: exe.prefill(prompts)),
                     ("decode", lambda: [exe.decode(state, state["logits"]
                                                    .argmax(-1)[:, None])
                                         for _ in range(3)])):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            sync(torch)
            wall_ms = (time.perf_counter() - t0) * 1e3
        kernels = [e for e in prof.key_averages()
                   if str(e.device_type).endswith("CUDA") and _dev_us(e) > 0]
        busy_ms = sum(_dev_us(e) for e in kernels) / 1e3
        if busy_ms == 0:
            out[name] = None
            continue
        calls = 1 if name == "prefill" else 3
        top = sorted(kernels, key=_dev_us, reverse=True)[:6]
        out[name] = dict(
            profiled_wall_ms=wall_ms / calls, device_ms=busy_ms / calls,
            busy_share=busy_ms / wall_ms,
            radix_ms=sum(_dev_us(e) for e in kernels if "radix_" in e.key)
            / 1e3 / calls,
            top=[(e.key[:60], _dev_us(e) / 1e3 / calls, e.count // calls)
                 for e in top])
    return out


def phase_lm(torch, arch, results) -> None:
    """``arch`` (Gemma-2B: full width and depth, bf16) served through
    ``Accelerator.compile`` for both dataflows."""
    from repro_torch import api
    from repro_torch.lm import model

    cfg = dataclasses.replace(arch, radix_steps=T, radix_kv_pack=True,
                              packed_attn=True)
    t0 = time.perf_counter()
    params = model.init_params(
        torch.Generator(device=DEV).manual_seed(SEED), cfg, device=DEV)
    sync(torch)
    init_s = time.perf_counter() - t0
    sizes = []
    model.tree_map(lambda t: sizes.append(t.numel()), params)
    n_params = sum(sizes)
    log(f"[lm] gemma-2b: {n_params / 1e9:.3f} B parameters in bf16, "
        f"initialised on the card in {init_s:.1f} s")
    per_prefill = 3 * cfg.n_layers          # w_gate, w_up, w_down
    out = dict(params=n_params, init_s=init_s, dataflows={})
    for dataflow in ("fused", "bitserial"):
        row = out["dataflows"][dataflow] = {}
        for packed_attn in (True, False):
            pcfg = dataclasses.replace(cfg, packed_attn=packed_attn)
            exe = api.Accelerator(dataflow=dataflow, device=DEV).compile(
                (params, pcfg), (LM_BATCH, LM_MAX_LEN), buckets=LM_BUCKETS)
            t0 = time.perf_counter()
            exe.warmup()
            warm_s = time.perf_counter() - t0
            built = exe.stats()["compiles"]
            check(built == len(LM_BUCKETS) + 1, f"warmup built {built} plans")
            plain_cfg = dataclasses.replace(exe.cfg, use_kernel=False)
            served, cmp = [], []
            for i, (n, s0, new) in enumerate(LM_REQUESTS):
                prompts = lm_prompts(torch, cfg, n, s0, SEED + 20 + i)
                r = serve_greedy(exe, prompts, new)
                per_step = 3 * cfg.n_layers
                want = {"radix_matmul": per_prefill + (new - 1) * per_step,
                        "radix_decode_attn": (new - 1) * cfg.n_layers
                        if packed_attn else 0,
                        "radix_conv2d": 0, "spike_encode": 0}
                check(r["launches"] == want,
                      f"{dataflow} packed_attn={packed_attn} request {i}: "
                      f"launches {r['launches']} != {want}")
                lg = r["logits"]
                check(all(tuple(x.shape) == (n, cfg.vocab) and
                          bool(torch.isfinite(x).all()) for x in lg),
                      "LM logits shape / finiteness")
                ref = plain_logits(model, exe.params, plain_cfg, prompts,
                                   r["tokens"], exe._cache.bucket_for(s0))
                c = compare_logits(torch, lg, ref)
                if packed_attn:
                    check(c["median_rel_l2"] <= 1e-2
                          and c["greedy_agreement"] >= 0.9,
                          f"{dataflow} request {i}: kernel vs plain {c}")
                else:
                    check(c["equal"], f"{dataflow} packed_attn=False request"
                          f" {i}: logits differ from the plain path {c}")
                cmp.append(c)
                served.append((prompts, r["tokens"]))
            # second round through generate: same tokens, no plan built
            for (prompts, toks), (_, _, new) in zip(served, LM_REQUESTS):
                check(torch.equal(exe.generate(prompts, new), toks),
                      f"{dataflow}: generate differs from round 1")
            check(exe.stats()["compiles"] == built,
                  f"{dataflow}: plans built in steady state")
            tag = "packed_attn" if packed_attn else "dequant_attn"
            row[tag] = dict(comparisons=cmp, stats=exe.stats(),
                            warmup_s=warm_s)
            log(f"[lm] {dataflow:9s} packed_attn={packed_attn!s:5s}: "
                f"warmup {warm_s:.1f} s; "
                + "; ".join(f"request {i} vs plain: median rel L2 "
                            f"{c['median_rel_l2']:.3g} (max "
                            f"{c['max_rel_l2']:.3g}), greedy agreement "
                            f"{c['greedy_agreement']:.3f}, equal "
                            f"{c['equal']}" for i, c in enumerate(cmp))
                + f"; stats {exe.stats()['compiles']} plans, "
                f"{exe.stats()['executions']} executions")
            if packed_attn:
                lm_timings(torch, cfg, exe, row)
                row["profile"] = profile_lm(
                    torch, exe, lm_prompts(torch, cfg, LM_BATCH,
                                           LM_BUCKETS[-1], SEED + 30))
                for name, pr in row["profile"].items():
                    if pr is None:
                        log(f"[lm] {dataflow} {name} profile: no device time"
                            " recorded (not measured)")
                        continue
                    log(f"[lm] {dataflow} {name} profile: device "
                        f"{pr['device_ms']:.3f} ms per call of "
                        f"{pr['profiled_wall_ms']:.3f} ms profiled wall "
                        f"({100 * pr['busy_share']:.1f}% busy), radix "
                        f"kernels {pr['radix_ms']:.3f} ms; top: "
                        + "; ".join(f"{k} {v:.3f} ms x{c}"
                                    for k, v, c in pr["top"]))
            del exe
    if DEV == "cuda":
        out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    results["lm"] = out


def lm_timings(torch, cfg, exe, row) -> None:
    """Prefill ms per bucket (full batch, prompts filling the bucket),
    decode ms per step and tokens/s; host clock ending in synchronize."""
    for bucket in LM_BUCKETS:
        prompts = lm_prompts(torch, cfg, LM_BATCH, bucket, SEED + 40)
        ms = host_ms(torch, lambda: exe.prefill(prompts), reps=3, warmup=1)
        row[f"prefill_{bucket}_ms"] = ms
        row[f"prefill_{bucket}_tokens_per_s"] = LM_BATCH * bucket / ms * 1e3
    state = exe.prefill(lm_prompts(torch, cfg, LM_BATCH, LM_BUCKETS[-1],
                                   SEED + 41))
    tok = state["logits"].argmax(-1)[:, None]
    ms = host_ms(torch, lambda: exe.decode(state, tok), reps=10)
    row["decode_ms"] = ms
    row["decode_tokens_per_s"] = LM_BATCH / ms * 1e3
    n, s0, new = LM_REQUESTS[0]
    prompts = lm_prompts(torch, cfg, n, s0, SEED + 20)
    t0 = time.perf_counter()
    exe.generate(prompts, new)
    sync(torch)
    req_s = time.perf_counter() - t0
    row["request_s"] = req_s
    row["request_tokens_per_s"] = n * new / req_s
    top = LM_BUCKETS[-1]
    log(f"[lm] {exe.dataflow:9s} prefill "
        + ", ".join(f"bucket {b}: {row[f'prefill_{b}_ms']:.2f} ms"
                    for b in LM_BUCKETS)
        + f" ({row[f'prefill_{top}_tokens_per_s']:.0f} prompt tokens/s at "
        f"bucket {top}); decode "
        f"{ms:.3f} ms per step ({row['decode_tokens_per_s']:.1f} tokens/s "
        f"at batch 8); request of {n} x {s0} tokens + {new} new: "
        f"{req_s:.3f} s ({row['request_tokens_per_s']:.1f} new tokens/s)")


# ---------------------------------------------------------------------------
# Phase 8: the encoder path.
# ---------------------------------------------------------------------------


def phase_encode(torch, results) -> None:
    from repro_torch.kernels import ops

    x = encode_batch(torch)
    xd = x.to(DEV)
    for steps in ENC_STEPS:
        for scale in ENC_SCALES:
            got = ops.radix_encode(xd, steps, scale)
            check(torch.equal(got.cpu(), ops.radix_encode(x, steps, scale)),
                  f"radix_encode T={steps} scale={scale}: card != CPU")
    sync(torch)
    log(f"[encode] ops.radix_encode of {tuple(x.shape)}: card == CPU at T "
        f"in {ENC_STEPS} x scales {ENC_SCALES}")


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {ROOT}",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np

    from repro_torch.configs import gemma_2b
    from repro_torch.kernels import _build
    from repro_torch.models import lenet, vgg

    t_start = time.perf_counter()
    smi = nvidia_smi()
    log(f"[device] {torch.cuda.get_device_name(0)}; torch {torch.__version__}"
        f" cuda {torch.version.cuda}; nvidia-smi: {smi}")
    results = {"nvidia_smi": smi, "torch": torch.__version__}

    t0 = time.perf_counter()
    took = _build.build()
    results["build_s"] = time.perf_counter() - t0
    log(f"[build] {results['build_s']:.2f} s wall; per library "
        + ", ".join(f"{k} {v:.2f} s" for k, v in took.items()))
    for name in _build.SOURCES:
        for line in (_build.BUILD_DIR / f"{name}.log").read_text().splitlines():
            if "registers" in line or "spill" in line.lower():
                log(f"[build] {name}: {line.strip()}")

    lenet_static, lenet_params, lenet_hw = lenet.make(
        np.random.default_rng(SEED), pool_mode="or")
    vgg_static, vgg_params, vgg_hw = vgg.make(
        np.random.default_rng(SEED), pool_mode="avg", input_hw=(224, 224, 3),
        width_mult=1.0, num_classes=100)
    nets = {
        "vgg11": kernel_calls(vgg_static, vgg_params, (BATCH,) + vgg_hw),
        "lenet5": kernel_calls(lenet_static, lenet_params,
                               (BATCH,) + lenet_hw),
    }
    t0 = time.perf_counter()
    phase_kernels(torch, nets, results)
    phase_lm_matmul(torch, gemma_2b.ARCH, results)
    phase_attn(torch, gemma_2b.ARCH, results)
    phase_encode_kernel(torch, results)
    log(f"[kernel] phase 2: {time.perf_counter() - t0:.1f} s")

    # each path: counters at 0 just before it, read just after
    paths = {}
    reset_counters()
    runs = {
        "lenet5": phase_net(torch, "lenet5", lenet_static, lenet_params,
                            lenet_hw, results),
        "vgg11": phase_net(torch, "vgg11", vgg_static, vgg_params, vgg_hw,
                           results),
    }
    paths["cnn"] = counters()
    copies = {"cnn": transposes()}
    phase_quantize(torch, results)
    phase_profile(torch, runs, results)
    del runs
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    reset_counters()
    phase_lm(torch, gemma_2b.ARCH, results)
    paths["lm"] = counters()
    copies["lm"] = transposes()
    log(f"[lm] phase 7: {time.perf_counter() - t0:.1f} s")

    reset_counters()
    phase_encode(torch, results)
    paths["encode"] = counters()
    results["path_launches"] = paths
    for path, names in (("cnn", ("radix_conv2d", "radix_matmul")),
                        ("lm", ("radix_matmul", "radix_decode_attn")),
                        ("encode", ("spike_encode",))):
        check(all(paths[path][k] > 0 for k in names),
              f"a kernel of the {path} path was not launched: "
              f"{paths[path]}")
    check(all(v == 0 for c in copies.values() for v in c.values()),
          f"per-call weight transposes on the main path: {copies}")
    results["path_weight_transposes"] = copies
    log(f"[paths] launches per path: {paths}; per-call weight transposes "
        f"{copies}")

    seen = results.pop("seen")
    vgg_calls = nets["vgg11"]
    kernels = []
    for kname in ("radix_conv2d", "radix_matmul"):
        source, replaces = KERNEL_INFO[kname]
        mine = [seen[_shape_key(c)] for c in vgg_calls if c["kernel"] == kname]
        bound_ms = sum(r["bound_ms"] for r in mine)
        bytes_ms = sum(r["bound_ms"] for r in mine if r["bound_by"] == "bytes")
        kernels.append(dict(
            name=kname, route="cuda", source=source, replaces=replaces,
            launches=sum(p[kname] for p in paths.values()),
            max_abs_err=results["max_abs_err"][kname],
            ms=sum(r["ms"] for r in mine),
            plain_ms=sum(r["plain_fused_ms"] for r in mine),
            bound_ms=bound_ms,
            bound_by="bytes" if bytes_ms * 2 >= bound_ms else "operations",
            library_ms=(None if any(r.get("library_device_ms") is None
                                    for r in mine)
                        else sum(r["library_device_ms"] for r in mine))))
    attn = next(r for r in results["attn_rows"]
                if r["packed"] and r["method"] == "fused")
    enc = results["encode_rows"][0]
    for kname, row in (("radix_decode_attn", attn), ("spike_encode", enc)):
        source, replaces = KERNEL_INFO[kname]
        kernels.append(dict(
            name=kname, route="cuda", source=source, replaces=replaces,
            launches=paths["lm" if kname == "radix_decode_attn"
                           else "encode"][kname],
            max_abs_err=results["max_abs_err"][kname], ms=row["ms"],
            plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
            bound_by=row["bound_by"], library_ms=row["library_ms"]))
    results["kernels"] = kernels
    results["total_s"] = time.perf_counter() - t_start
    out_dir = ROOT / "build"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(results, indent=1,
                                                        default=str))
    log(f"[done] {results['total_s']:.1f} s; kernel line: conv and matmul "
        "device times summed over one VGG-11 batch-8 fused execution's "
        "launches "
        "(matmul launches: CNN + LM paths); decode attention at the LM "
        "decode shape (packed, fused); encoder at 8x224x224x3, T=4")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
