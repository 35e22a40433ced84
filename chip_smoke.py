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
   - ``radix_decode_attn`` at the ``ATTN_EDGES`` cases: the LM's decode
     shape (B = 8, H = 8, Hkv = 1, hd = 256, S = 512, T = 4 packed, bf16
     query, a mask set with causal prefixes, ring windows and an
     all-masked row, an empty plane in the whole cache), S in {1, 33,
     129, 300, 512, 4096}, Hkv in {1, 2, 8}, g in {1, 4, 6, 8, 10, 16}, hd
     in {64, 112, 128, 256, 512} (Kimi-K2's hd = 112 packs a 56-byte row,
     not a multiple of 16), T = 1 and 8 unpacked and 4 packed, a plane
     empty in one tile only, ring windows whose middle splits are fully
     masked, bf16 and f32 queries; each with both dataflows and the
     occupancy gate on and off: ``torch.equal``; GLM4-9B's group (g = 16,
     hd = 128) is timed beside its bound.  At the decode shape (packed
     and unpacked) and at
     S = 8192 one ``ops.radix_decode_attention`` call must launch the
     kernel once, run at most 2 device kernels (profiler; the same work
     as separate PyTorch ops is counted beside it) and no occupancy
     prepass;
   - ``spike_encode`` on a seeded 8 x 224 x 224 x 3 batch at T in
     {1, 4, 8} and three scales: ``torch.equal``;
   each row timed by CUDA events beside its bound, its plain version and a
   library yardstick, checked equal where it computes the same integers
   (fp32 cuBLAS mm, and fp32 ``F.conv2d`` with cuDNN off, TF32 off, exact
   at VGG-11's shapes; cuDNN's own fp32 conv is timed beside it with the
   count of values it gets wrong; ``torch._int_mm`` on M padded to 32 at
   Gemma's shapes; ``F.scaled_dot_product_attention`` over the
   dequantized bf16 cache, which is not the same function, by profiler
   device time; none for the encoder);
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
   then phase 2's decode-attention checks and times (run here, next to
   the LM path, so that their profiler traces and long plain runs do
   not share the process state in which phases 3-4 time the CNN walls);
7. the LM path: Gemma-2B at full width and depth in bf16 (seeded weights
   on the card), T = 4, ``radix_kv_pack`` and ``packed_attn`` on,
   compiled for both dataflows at (batch, max_len) = (8, 512) with
   sequence buckets (64, 256), serving 8 prompts of 200 tokens (32 new)
   and 3 prompts of 40 tokens (16 new), twice.  The second round (through
   ``generate``) must build no plan and repeat the tokens; each prefill
   must launch exactly 54 ``radix_matmul`` and each decode step 54
   ``radix_matmul`` + 18 ``radix_decode_attn``.  Logits are held against
   the port's plain path (``use_kernel=False``) on the same tokens:
   ``torch.equal`` at every step, ``packed_attn`` on and off.  Prefill
   ms per bucket, decode ms per step and tokens/s by host clock, and a
   ``torch.profiler`` trace of one prefill and three decode steps
   (device time, busy share, device kernels a call, attention ms);
8. the encoder path: ``ops.radix_encode`` of the phase-5 batch at T in
   {1, 4, 8} and three scales, on the card and on the CPU: equal;
9. the emerging encodings on the CNN path (``ENC_CASES``): VGG-11 (as in
   phase 4, avg pool) and Fang CNN-2 (full width, 28 x 28 x 1) converted
   for ``TTFSEncoding(4)``, ``PhaseEncoding(8, periods=2)`` and
   ``RateEncoding(4)``, Fang also for TTFS with max pool and phase with
   "or" pool.  A TTFS or rate net whose logits do not vary across images
   is reported and converted again at T = 8.  TTFS and phase compile for
   both dataflows on the kernels backend (``out_grid="pow2"`` and
   ``periods=2`` on every layer), rate and radix (T = 4) on the ``jnp``
   backend (the eager path), with buckets (1, 8), and serve requests of
   1, 3, 8 and 11 images twice: logits ``torch.equal`` to both oracles,
   the ``jnp`` radix logits to the kernels plan's, no plan built in the
   second round, conv/matmul launches = layers x executions (0 on
   ``jnp``), and the plane-skip counters of the timed plan equal to the
   same plan's compiled for the CPU over the same requests (VGG-11: the
   request of 8 images, bucket 8, as its plain versions take seconds a
   batch there; Fang: every request size).  Images/s per bucket
   by host clock (median of 10) and a profile of bucket 8;
10. CNN serving: a ``launch.serve_cnn.CNNServer`` over VGG-11 phase
   (8, 2), bitserial, buckets (1, 8), serves a seeded stream of 64
   requests of 1-4 images through ``MicroBatchQueue`` (every ticket
   ``torch.equal`` to the oracle rows of its images, no plan built;
   requests/s, images/s, p50/p99 latency), then the same stream under a
   straggler window that flags nothing (no degraded flush); then a chaos
   drill on the same server (one NaN poison request, a transient fault
   every 5th infer call): every ticket resolves with logits equal to the
   oracle or a typed ``ServeError``, the poison alone is quarantined, and
   every infer call is either an injected fault or a resolved flush;
   conv/matmul launches over the streams and the drill = layers x the
   server's executions; then ``serve_cnn.main`` once through its CLI
   (Fang CNN-2, TTFS, avg pool, bitserial), its launches = layers x
   (executions + the warmed buckets);
11. the autotuner (``kernels/autotune.py``), against a fresh winner table
   (``REPRO_TORCH_AUTOTUNE_CACHE`` pointed at a new temporary file):
   phase 4's VGG-11 compiled with ``autotune=True`` at bucket 8 for both
   dataflows, each layer's candidate launches printed with their times
   and the winner, logits ``torch.equal`` to the untuned plan and the
   oracle, a second compile sweeping nothing (its hits = its layers, 0
   candidates skipped), tuned and untuned plans timed in turns; VGG-11's
   ``Executable.memory()`` (the paper's ping-pong buffers); every
   candidate launch of VGG-11's layers and Gemma-2B's FFN products
   ``torch.equal`` to the untuned launch (counted on no path); then
   Gemma-2B at full width with ``autotune=True`` (``kernel_autotune``)
   at bucket 64 and the decode plan, both dataflows, one request's
   logits at every step ``torch.equal`` to the plain path run with the
   same tuned launches, tuned and untuned timed in turns;
12. the LM archs beyond Gemma-2B (``ARCH_PHASES``), each at full width in
   bf16 (seeded weights on the card), T = 4, ``radix_kv_pack`` and
   ``packed_attn`` on, its weights freed before the next: GLM4-9B (40
   layers, g = 16) through ``Accelerator.compile`` at (8, 512) with
   buckets (64, 256) for both dataflows, requests of 8 x 40 and 3 x 200
   tokens with 8 new; Gemma-7B (28 layers) and DeepSeek-Coder-33B (16 of
   its 62 layers: its bf16 tree alone is ~66.8 GB) alike, fused, the
   first request only; RecurrentGemma-2B (26 layers, window 2048) through
   ``launch.serve.generate``, requests of 8 x 64 tokens with 16 new and
   2 x 2100 with 8 new (prefill keeps the last 2048 positions and rolls
   the ring; decode wraps); RWKV-6-3B (32 layers) through ``generate``,
   8 x 256 with 16 new.  Every step's logits ``torch.equal`` to the
   plain path (the same ``cfg`` with ``use_kernel=False``; through
   ``generate`` the tokens too), and per token position the launches of
   ``lm_launches``: the radix FFN products plus an untied unembed, and
   in decode one attention per attention layer.  Prefill and decode ms
   by host clock, a profile of one prefill and three decode steps
   (device ms, busy share, attention's share), seconds and peak memory
   per arch;
13. the last four LM archs (``ARCH_PHASES_13``), at full width in bf16 as
   phase 12 runs them, fused: Grok-1 (4 of its 64 layers: 8 routed
   experts of 6144 x 32768, 9.66 GB a layer) and Kimi-K2 (1 of its 61:
   384 experts of 7168 x 2048 and a shared one, 33.8 GB) through
   ``Accelerator.compile`` at (8, 512), buckets (64, 256) and (64,), a
   request of 8 x 40 tokens with 8 new; the MoE layers run the ``ref``
   dispatch (every expert on every token, routed experts exact), and
   the dense expert products of one layer are timed at the profiled
   prefill's and decode's token counts for their share of the device
   time.  Whisper-medium (24 + 24 layers) and Qwen2-VL-72B (12 of its
   80) through ``lm.model.prefill`` / ``decode_step`` with a batch dict:
   Whisper 8 x 64 and 2 x 400 tokens (within its 448 positions) over
   seeded (B, 1500, 1024) frame embeddings, 16 and 8 new, fed its greedy
   tokens; Qwen2-VL 8 x 256 seeded embeds and 8 decode steps fed seeded
   (B, 1, d) embeds.  Every step's logits ``torch.equal`` to the plain
   path, the launches of ``lm_launches`` (routed experts and the MoE
   unembed none, Kimi's shared expert 3 a position, Whisper's encoder
   FFNs once a prefill, cross-attention no attention launch), times, a
   profile, seconds and peak memory per arch.

Launch counters are set to 0 just before each path (phases 3-4, 7, 8, 9,
10, 11, and each arch of 12 and 13) and read just after; so are the GEMM
wrappers' per-call weight-transpose counters, which must stay 0 on the
CNN and LM paths (their plans hold K-major weights).  Every failure raises, so the
script exits non-zero.
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
import shutil
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
PROFILE_TRIES = 3              # traces taken when one holds no device events


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
    events around one short call also catch.  A trace now and then holds
    no device events at all; it is taken again, up to ``PROFILE_TRIES``
    times, then None (not measured)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(PROFILE_TRIES):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = sum(_dev_us(e) for e in prof.key_averages()
                 if kernel is None or kernel in e.key)
        if us:
            return us / reps / 1e3
    return None


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


# Attention cases, each the kernel against its plain version with
# ``torch.equal``, both dataflows, the occupancy gate on and off: batch,
# slots, kv heads, query heads per kv head, head dim, T, packed cache,
# query dtype, mask set and an empty plane ("cache": plane 2 empty in the
# whole cache; "tile": plane 1 empty in the second 32-slot tile only).
ATTN_DECODE = dict(b=LM_BATCH, s=LM_MAX_LEN, hkv=1, g=8, hd=256, t=T,
                   packed=True, q="bf16", mask="mixed", empty="cache")
# GLM4-9B's decode shape: 32 query heads over 2 kv heads (g = 16), hd 128
ATTN_G16 = dict(b=LM_BATCH, s=LM_MAX_LEN, hkv=2, g=16, hd=128, t=T,
                packed=True, q="bf16", mask="ring", empty="cache")
ATTN_EDGES = [
    ATTN_DECODE,
    dict(b=2, s=1, hkv=1, g=8, hd=256, t=4, packed=True, q="f32",
         mask="full", empty=None),
    dict(b=3, s=33, hkv=2, g=4, hd=64, t=4, packed=True, q="bf16",
         mask="ring", empty="tile"),
    dict(b=2, s=300, hkv=2, g=4, hd=256, t=8, packed=False, q="f32",
         mask="ring", empty="tile"),
    dict(b=3, s=300, hkv=1, g=1, hd=64, t=1, packed=False, q="bf16",
         mask="mixed", empty=None),
    dict(b=2, s=129, hkv=2, g=8, hd=64, t=4, packed=False, q="bf16",
         mask="allmasked", empty="tile"),
    dict(b=4, s=4096, hkv=1, g=8, hd=256, t=4, packed=True, q="bf16",
         mask="mixed", empty="tile"),
    dict(b=2, s=4096, hkv=2, g=4, hd=64, t=4, packed=True, q="f32",
         mask="ring", empty="cache"),
    # groups past 8 query heads and heads past 256 dims: RecurrentGemma-2B's
    # group (10 over 1 kv head, hd 256), GLM4-9B's (32 query heads over 2
    # kv heads, hd 128) and hd = 512
    dict(b=2, s=300, hkv=1, g=10, hd=256, t=4, packed=True, q="bf16",
         mask="mixed", empty="tile"),
    ATTN_G16,
    dict(b=2, s=129, hkv=2, g=4, hd=512, t=8, packed=False, q="f32",
         mask="allmasked", empty="tile"),
    # Grok-1's group (48 query heads over 8 kv heads: g = 6, hd 128) and
    # Kimi-K2's (64 over 8, hd = 7168 / 64 = 112: a 56-byte packed row,
    # not a multiple of 16, so the tile loads take the partial-chunk path)
    dict(b=2, s=300, hkv=8, g=6, hd=128, t=4, packed=True, q="bf16",
         mask="mixed", empty="tile"),
    dict(b=2, s=300, hkv=8, g=8, hd=112, t=4, packed=True, q="bf16",
         mask="ring", empty="cache"),
]
ATTN_LONG = dict(ATTN_DECODE, s=8192)   # Gemma-2B's context


def attn_mask(torch, kind: str, b: int, s_len: int):
    """(B, S) bool on the card.  "mixed": causal prefixes, ring windows and
    an all-masked last row; "ring": a window of a ring buffer that wraps
    (valid at both ends, middle splits fully masked) beside a causal row;
    "allmasked": a prefix with row 0 fully masked; "full": all valid."""
    from repro_torch.lm import blocks

    dev = torch.device(DEV)
    slots = torch.arange(s_len, device=dev)
    if kind == "full":
        return torch.ones((b, s_len), dtype=torch.bool, device=dev)
    if kind == "mixed":
        rows = [blocks.decode_mask(p, s_len, 0, device=dev)[0]
                for p in (0, 199 * s_len // 512, 300 * s_len // 512,
                          s_len - 1)]
        rows += [blocks.decode_mask(p, s_len, s_len, device=dev)[0]
                 for p in (100, s_len + 37, 3 * s_len - 5)]
        rows = (rows * b)[:b - 1] + [torch.zeros_like(rows[0])]
        return torch.stack(rows)
    if kind == "ring":
        last, window = min(39, s_len - 1), max(1, (3 * s_len) // 8)
        ring = ((last - slots) % s_len) < window
        causal = slots <= s_len // 3
        return torch.stack([ring if i % 2 == 0 else causal
                            for i in range(b)])
    prefix = slots < max(1, (2 * s_len) // 3)
    m = prefix[None].expand(b, s_len).clone()
    m[0] = False
    return m


def attn_problem(torch, case: dict, gen):
    """Queries, a T-bit cache (packed when asked), per-token scales and the
    case's mask, all on the card from ``gen``."""
    dev = torch.device(DEV)
    b, s_len, hkv, g, hd, t = (case[k] for k in ("b", "s", "hkv", "g", "hd",
                                                 "t"))
    q = torch.randn((b, hkv * g, hd), generator=gen, device=dev)
    q = q.to(torch.bfloat16 if case["q"] == "bf16" else torch.float32)
    lv = [torch.randint(0, 1 << t, (b, s_len, hkv, hd), generator=gen,
                        device=dev, dtype=torch.int32) for _ in range(2)]
    if case["empty"] == "cache" and t > 2:
        lv = [x & ~0b100 for x in lv]
    elif case["empty"] == "tile" and t > 1:
        for x in lv:
            x[:, 32:64] &= ~0b10
    scales = [torch.rand((b, s_len, hkv), generator=gen, device=dev) + 0.25
              for _ in range(2)]
    cache = [(_pack4(x) if case["packed"] else x).to(torch.uint8)
             for x in lv]
    mask = attn_mask(torch, case["mask"], b, s_len)
    return q, cache[0], scales[0], cache[1], scales[1], mask, lv


def _pack4(x):
    """(..., hd) levels < 16 -> (..., hd // 2), hi nibble = even dim."""
    return (x[..., 0::2] << 4) | x[..., 1::2]


def attn_bound(case: dict, mask) -> tuple:
    """(ms, "bytes" | "operations", bytes): the query, the valid slots'
    levels and scales, the mask and the output over HBM bandwidth (the
    kernel neither loads nor scores a tile without a valid slot), or
    QK^T at the int8 peak plus PV at the float32 peak over those slots."""
    b, s_len, hkv, g, hd = (case[k] for k in ("b", "s", "hkv", "g", "hd"))
    valid = int(mask.sum()) * hkv                  # (row, slot) pairs
    row_bytes = hd // 2 if case["packed"] else hd
    nbytes = (b * hkv * g * hd * (2 if case["q"] == "bf16" else 4)
              + valid * (2 * row_bytes + 8) + b * s_len
              + b * hkv * g * hd * 4)
    ops = 2.0 * valid * g * hd
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = (ops / INT8_OPS_PER_S + ops / F32_OPS_PER_S) * 1e3
    return ((t_bytes, "bytes") if t_bytes >= t_ops
            else (t_ops, "operations")) + (nbytes,)


def device_kernels(torch, fn, reps: int = 5):
    """Device kernels (and memsets/copies) one call of ``fn`` runs, from a
    ``torch.profiler`` trace of ``reps`` calls, taken again (as in
    :func:`device_ms`) when it holds no device activity; None when no
    trace did (not measured)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(PROFILE_TRIES):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        n = sum(1 for e in prof.events()
                if str(e.device_type).endswith("CUDA") and _dev_us(e) > 0)
        if n:
            return n / reps
    return None


def separate_glue(torch, q, kq, vq, mask, packed: bool):
    """The work the kernel does itself, as separate PyTorch ops around a
    launch would do it, for the count: query quantize and row layout, the
    mask as int32, and the whole-cache occupancy prepass of K and V."""
    from repro_torch.kernels import radix_attn as ra

    b, h, hd = q.shape
    hkv = kq.shape[2]
    qq, qs = ra.quantize_q(q)
    qq.reshape(b * hkv, h // hkv, hd)
    qs.reshape(b * hkv, h // hkv)
    mask[:, None].expand(b, hkv, mask.shape[1]).reshape(b * hkv, -1).to(
        torch.int32).contiguous()
    ra.occupancy_rows(kq, vq, T, packed)


def phase_attn(torch, results) -> None:
    """radix_decode_attn against its plain version at the LM's decode
    shape (through ``ops.radix_decode_attention``, as the LM calls it)
    and at every ``ATTN_EDGES`` case; kernels per call; times at the
    decode shape and at S = 8192."""
    import torch.nn.functional as F

    from repro_torch.kernels import ops
    from repro_torch.kernels import radix_attn as ra
    from repro_torch.kernels import radix_matmul as rm

    gen = torch.Generator(device=DEV).manual_seed(SEED + 11)
    edges = []
    for case in ATTN_EDGES:
        q, kq, ks, vq, vs, mask, lv = attn_problem(torch, case, gen)
        if case["empty"] == "tile" and case["t"] > 1:
            check(not bool(((lv[0][:, 32:64] >> 1) & 1).any())
                  and bool(((lv[0] >> 1) & 1).any()),
                  "plane 1 should be empty in tile 1 only")
        for method in ("fused", "bitserial"):
            for sparsity in (True, False):
                kw = dict(num_steps=case["t"], method=method,
                          packed=case["packed"], sparsity=sparsity)
                got = ra.radix_decode_attn_cuda(q, kq, ks, vq, vs, mask, **kw)
                want = ra.radix_decode_attn_plain(q, kq, ks, vq, vs, mask,
                                                  **kw)
                sync(torch)
                tag = (f"{case} {method} sparsity={sparsity}")
                check(bool(torch.isfinite(got).all()), f"non-finite {tag}")
                check(torch.equal(got, want), f"radix_decode_attn {tag}: "
                      f"max |diff| {float((got - want).abs().max())}")
                dead = ~mask.any(dim=1)
                check(not got[dead].any(), f"all-masked row is not 0: {tag}")
        edges.append({k: case[k] for k in case})
    log(f"[kernel] radix_decode_attn equals its plain version (torch.equal) "
        f"at {len(edges)} cases x 2 dataflows x gate on/off: " + "; ".join(
            f"B={c['b']} S={c['s']} Hkv={c['hkv']} g={c['g']} hd={c['hd']} "
            f"T={c['t']}{' packed' if c['packed'] else ''} q={c['q']} "
            f"{c['mask']}" + (f" empty plane ({c['empty']})"
                              if c["empty"] else "") for c in edges))
    results["attn_edges"] = edges
    results["attn_wide"] = attn_wide(torch, gen)

    rows = []
    for case in (ATTN_DECODE, dict(ATTN_DECODE, packed=False), ATTN_LONG):
        q, kq, ks, vq, vs, mask, lv = attn_problem(torch, case, gen)
        args = (q, kq, ks, vq, vs, mask)
        for method in ("fused", "bitserial"):
            kw = dict(packed=case["packed"], method=method)
            akw = dict(kw, num_steps=T)
            before = ra.radix_decode_attn_cuda.launches
            occ_before = rm.plane_occupancy.calls
            got = ops.radix_decode_attention(*args, T, **kw)
            launched = ra.radix_decode_attn_cuda.launches - before
            prepasses = rm.plane_occupancy.calls - occ_before
            want = ops.radix_decode_attention(
                *args, T, **kw, config=ops.KernelConfig(impl="plain"))
            sync(torch)
            check(launched == 1 and prepasses == 0,
                  f"one ops.radix_decode_attention call: {launched} launches"
                  f", {prepasses} occupancy prepasses")
            check(torch.equal(got, want),
                  f"radix_decode_attn {case['s']} {kw}: max |diff| "
                  f"{float((got - want).abs().max())}")
            row = dict(kernel="radix_decode_attn", packed=case["packed"],
                       method=method, shape=(case["b"], case["g"],
                                             case["hkv"], case["hd"],
                                             case["s"]),
                       split_slots=ra.split_slots(case["s"]),
                       max_abs_err=float((got - want).abs().max()),
                       bitwise_equal=True)
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
                torch, lambda: ops.radix_decode_attention(*args, T, **kw),
                reps=20)
            row["kernels_per_call"] = device_kernels(
                torch, lambda: ops.radix_decode_attention(*args, T, **kw))
            check((row["kernels_per_call"] or 0) <= 2, f"one ops.radix_"
                  f"decode_attention call ran {row['kernels_per_call']} "
                  f"device kernels")
            row["glue_kernels_per_call"] = 1 + (device_kernels(
                torch, lambda: separate_glue(torch, q, kq, vq, mask,
                                             case["packed"])) or 0)
            (row["bound_ms"], row["bound_by"],
             row["bytes"]) = attn_bound(case, mask)
            row["library_ms"] = sdpa_ms(torch, F, case, q, lv, args)
            rows.append(row)
            log(f"[kernel] gemma  radix_decode_attn packed={row['packed']!s:5s}"
                f" {method:9s} B={case['b']} H={case['g'] * case['hkv']} "
                f"Hkv={case['hkv']} hd={case['hd']} S={case['s']} (split "
                f"{row['split_slots']}): kernel {row['ms']:.4f} ms on the "
                f"device ({row['call_ms']:.4f} ms a call by CUDA events; "
                f"ops.radix_decode_attention {row['wrapper_ms']:.4f} ms, "
                f"{row['kernels_per_call']} device kernel(s) a call against "
                f"{row['glue_kernels_per_call']:g} with the glue as separate "
                f"ops), "
                f"plain {row['plain_ms']:.4f} ms, bound "
                f"{row['bound_ms']:.5f} ms ({row['bound_by']}, "
                f"{100 * row['bound_ms'] / row['ms']:.1f}% of it), SDPA "
                f"yardstick {row['library_ms']:.4f} ms, bit for bit equal")
    check(any(r["kernels_per_call"] for r in rows),
          "no profiler trace counted the device kernels of one "
          "ops.radix_decode_attention call (not measured)")
    results["attn_rows"] = rows
    results["max_abs_err"]["radix_decode_attn"] = 0.0
    split_sweep(torch, gen, results)


def attn_wide(torch, gen) -> list:
    """Device time of the kernel at GLM4-9B's group (``ATTN_G16``: 32 query
    heads over 2 kv heads, hd 128, B = 8, S = 512, packed), both
    dataflows, beside its byte bound."""
    from repro_torch.kernels import radix_attn as ra

    q, kq, ks, vq, vs, mask, _ = attn_problem(torch, ATTN_G16, gen)
    rows = []
    for method in ("fused", "bitserial"):
        kw = dict(num_steps=ATTN_G16["t"], method=method, packed=True)
        fn = lambda: ra.radix_decode_attn_cuda(q, kq, ks, vq, vs, mask, **kw)
        row = dict(method=method, shape=(ATTN_G16["b"], ATTN_G16["g"],
                                         ATTN_G16["hkv"], ATTN_G16["hd"],
                                         ATTN_G16["s"]),
                   device_ms=device_ms(torch, fn, "radix_decode_attn_kernel"),
                   call_ms=cuda_ms(torch, fn, reps=20))
        row["bound_ms"], row["bound_by"], row["bytes"] = attn_bound(ATTN_G16,
                                                                    mask)
        row["ms"] = row["device_ms"] or row["call_ms"]
        rows.append(row)
        log(f"[kernel] glm4-9b radix_decode_attn packed {method:9s} B=8 H=32 "
            f"Hkv=2 g=16 hd=128 S=512: kernel {row['ms']:.4f} ms on the "
            f"device ({row['call_ms']:.4f} ms a call by CUDA events), bound "
            f"{row['bound_ms']:.5f} ms ({row['bound_by']}, "
            f"{100 * row['bound_ms'] / row['ms']:.1f}% of it)")
    return rows


def split_sweep(torch, gen, results) -> None:
    """Device time of the kernel (packed, both dataflows) at the decode
    shape and at S = 8192 for each (split_slots, max_splits) pair the
    tuner offers (``autotune.ATTN_SPLITS``): the measurement
    behind ``kernels/radix_attn.py``'s constants.  At the decode shape each
    pair is also held against the plain version, which splits alike."""
    from repro_torch.kernels import radix_attn as ra
    from repro_torch.kernels.autotune import ATTN_SPLITS

    chosen = (ra.SPLIT_SLOTS, ra.MAX_SPLITS)
    problems = [(case, attn_problem(torch, case, gen)[:6])
                for case in (ATTN_DECODE, ATTN_LONG)]
    rows = []
    for split, most in ATTN_SPLITS:
        for case, args in problems:
            for method in ("fused", "bitserial"):
                kw = dict(num_steps=T, method=method, packed=True,
                          splits=(split, most))
                if case is ATTN_DECODE:
                    check(torch.equal(
                        ra.radix_decode_attn_cuda(*args, **kw),
                        ra.radix_decode_attn_plain(*args, **kw)),
                        f"split {split}/{most}: kernel != plain")
                rows.append(dict(
                    split_slots=split, max_splits=most, s=case["s"],
                    method=method, splits=-(-case["s"] // ra.split_slots(
                        case["s"], split, most)),
                    device_ms=device_ms(
                        torch, lambda: ra.radix_decode_attn_cuda(
                            *args, **kw), "radix_decode_attn_kernel")))
    log("[kernel] radix_decode_attn split sweep (SPLIT_SLOTS/MAX_SPLITS, S, "
        "dataflow: splits a row, device ms; chosen "
        f"{chosen[0]}/{chosen[1]}): " + "; ".join(
            f"{r['split_slots']}/{r['max_splits']} S={r['s']} {r['method']}:"
            f" {r['splits']}, {r['device_ms']}" for r in rows))
    results["attn_split_sweep"] = rows


def sdpa_ms(torch, F, case, q, lv, args) -> float:
    """Yardstick: device time of SDPA over the dequantized bf16 cache (not
    the same function: the query is not quantized and the cache is
    float), with one causal-prefix mask row for every batch row."""
    b, s_len, hkv, g, hd = (case[k] for k in ("b", "s", "hkv", "g", "hd"))
    h = hkv * g
    lvl = (1 << case["t"]) - 1
    _, _, ks, _, vs, mask = args
    kd = ((lv[0].float() * (2.0 / lvl) - 1.0) * ks[..., None]).to(
        torch.bfloat16).transpose(1, 2).contiguous()      # (B, Hkv, S, hd)
    vd = ((lv[1].float() * (2.0 / lvl) - 1.0) * vs[..., None]).to(
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
    return device_ms(torch, sdpa, None) or cuda_ms(torch, sdpa, reps=20)


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
        rounds = serve_rounds(torch, exe, x, want_snn, f"{name}/{dataflow}")
        after = counters()
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
    return dict(exes=exes, x=x, qnet=qnet, want=want_snn)


# ---------------------------------------------------------------------------
# Phase 6: where a plan's time goes (torch.profiler).
# ---------------------------------------------------------------------------


def phase_profile(torch, runs: dict, results: dict) -> None:
    """Device time by kernel name over three calls of each (net, dataflow,
    bucket) plan, and the device's busy share: that device time over the
    unprofiled median wall time of phases 3 and 4 (the profiler slows the
    host)."""
    out = {}
    for name, run in runs.items():
        for dataflow, exe in run["exes"].items():
            for b in BUCKETS:
                key = f"{name}/{dataflow}/b{b}"
                wall_ms = results[name]["dataflows"][dataflow]["buckets"][b][
                    "ms"]
                prof = out[key] = profile_plan(
                    torch, exe.plan_for(b), run["x"][:b].contiguous(),
                    wall_ms)
                if prof is None:
                    log(f"[profile] {key}: no device time recorded "
                        "(not measured)")
                    continue
                log(f"[profile] {key}: device busy "
                    f"{prof['device_ms_per_call']:.3f} ms/call = "
                    f"{100 * prof['busy_share']:.1f}% of the unprofiled "
                    f"{wall_ms:.3f} ms "
                    f"({prof['profiled_wall_ms_per_call']:.3f} ms "
                    f"profiled): radix kernels "
                    f"{prof['radix_kernels_ms_per_call']:.3f} ms, other "
                    f"kernels {prof['other_kernels_ms_per_call']:.3f} ms; "
                    "top: " + "; ".join(f"{k} {v:.3f} ms x{c}"
                                        for k, v, c in prof["top"]))
    results["profile"] = out


def profile_plan(torch, plan, xb, wall_ms: float, calls: int = 3):
    """Device time of ``calls`` calls of ``plan`` by kernel name
    (``torch.profiler``; only device-side kernel events count: the
    CPU-side operator events carry their kernels' time too) against the
    unprofiled median ``wall_ms``; None when the trace holds no device
    time."""
    from torch.profiler import ProfilerActivity, profile

    plan(xb)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            plan(xb)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.key_averages()
               if str(e.device_type).endswith("CUDA") and _dev_us(e) > 0]
    busy_us = sum(_dev_us(e) for e in kernels)
    if busy_us == 0:
        return None
    radix_us = sum(_dev_us(e) for e in kernels if "radix_" in e.key)
    top = sorted(kernels, key=_dev_us, reverse=True)[:5]
    return dict(
        profiled_wall_ms_per_call=wall_us / calls / 1e3,
        device_ms_per_call=busy_us / calls / 1e3,
        radix_kernels_ms_per_call=radix_us / calls / 1e3,
        other_kernels_ms_per_call=(busy_us - radix_us) / calls / 1e3,
        busy_share=busy_us / calls / 1e3 / wall_ms,
        top=[(e.key[:70], _dev_us(e) / calls / 1e3, e.count // calls)
             for e in top])


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
    of ``exe`` (``torch.profiler``), and its share of the profiled wall
    time."""
    state = exe.prefill(prompts)
    sync(torch)
    tok = state["logits"].argmax(-1)[:, None]
    return profile_steps(torch, lambda: exe.prefill(prompts),
                         lambda: [exe.decode(state, tok) for _ in range(3)])


def profile_steps(torch, prefill, decode3) -> dict:
    """Device time by kernel name over ``prefill()`` (one prefill) and
    ``decode3()`` (three decode steps), and its share of the profiled
    wall time."""
    from torch.profiler import ProfilerActivity, profile

    out = {}
    for name, fn in (("prefill", prefill), ("decode", decode3)):
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
        launched = sum(1 for e in prof.events()
                       if str(e.device_type).endswith("CUDA")
                       and _dev_us(e) > 0)
        out[name] = dict(
            profiled_wall_ms=wall_ms / calls, device_ms=busy_ms / calls,
            busy_share=busy_ms / wall_ms, device_kernels=launched / calls,
            attn_ms=sum(_dev_us(e) for e in kernels
                        if "radix_decode_attn" in e.key) / 1e3 / calls,
            radix_ms=sum(_dev_us(e) for e in kernels if "radix_" in e.key)
            / 1e3 / calls,
            top=[(e.key[:60], _dev_us(e) / 1e3 / calls, e.count // calls)
                 for e in top])
    return out


def glue_kernels(results, cfg, dataflow: str, name: str, pr: dict) -> str:
    """A decode step's device kernels with the attention glue as separate
    ops: this run's count plus, for each of the step's attention calls,
    the difference phase 2 counted per call."""
    if name != "decode":
        return ""
    row = next(r for r in results["attn_rows"] if r["packed"]
               and r["method"] == dataflow and r["shape"][4] == LM_MAX_LEN)
    if not row["kernels_per_call"]:
        return " (with the attention glue as separate ops: not measured)"
    extra = row["glue_kernels_per_call"] - row["kernels_per_call"]
    pr["glue_device_kernels"] = pr["device_kernels"] + cfg.n_layers * extra
    return (f" (with the attention glue as separate ops: "
            f"{pr['glue_device_kernels']:.0f})")


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
                check(c["equal"], f"{dataflow} packed_attn={packed_attn} "
                      f"request {i}: logits differ from the plain path {c}")
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
                        f"({100 * pr['busy_share']:.1f}% busy), "
                        f"{pr['device_kernels']:.0f} device kernels a call"
                        f"{glue_kernels(results, cfg, dataflow, name, pr)}, "
                        f"radix kernels {pr['radix_ms']:.3f} ms, decode "
                        f"attention {pr['attn_ms']:.3f} ms; top: "
                        + "; ".join(f"{k} {v:.3f} ms x{c}"
                                    for k, v, c in pr["top"]))
            del exe
    if DEV == "cuda":
        out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    results["lm"] = out


def lm_timings(torch, cfg, exe, row, request=LM_REQUESTS[0],
               tag: str = "lm") -> None:
    """Prefill ms per bucket (full batch, prompts filling the bucket),
    decode ms per step and tokens/s, and one ``request`` (prompts, tokens,
    new tokens) through ``generate``; host clock ending in synchronize."""
    for bucket in exe.buckets:
        prompts = lm_prompts(torch, cfg, LM_BATCH, bucket, SEED + 40)
        ms = host_ms(torch, lambda: exe.prefill(prompts), reps=3, warmup=1)
        row[f"prefill_{bucket}_ms"] = ms
        row[f"prefill_{bucket}_tokens_per_s"] = LM_BATCH * bucket / ms * 1e3
    state = exe.prefill(lm_prompts(torch, cfg, LM_BATCH, exe.buckets[-1],
                                   SEED + 41))
    tok = state["logits"].argmax(-1)[:, None]
    ms = host_ms(torch, lambda: exe.decode(state, tok), reps=10)
    row["decode_ms"] = ms
    row["decode_tokens_per_s"] = LM_BATCH / ms * 1e3
    n, s0, new = request
    prompts = lm_prompts(torch, cfg, n, s0, SEED + 20)
    t0 = time.perf_counter()
    exe.generate(prompts, new)
    sync(torch)
    req_s = time.perf_counter() - t0
    row["request_s"] = req_s
    row["request_tokens_per_s"] = n * new / req_s
    top = exe.buckets[-1]
    log(f"[{tag}] {exe.dataflow:9s} prefill "
        + ", ".join(f"bucket {b}: {row[f'prefill_{b}_ms']:.2f} ms"
                    for b in exe.buckets)
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


# ---------------------------------------------------------------------------
# Phase 9: the emerging encodings (TTFS, phase, rate) on the CNN path.
# ---------------------------------------------------------------------------

# (net, pool mode, encoding, T, periods).  TTFS and phase run on the kernels
# backend (both dataflows), rate and radix on the jnp backend (the eager
# PyTorch path); radix is also compiled on the kernels backend and its jnp
# logits are held to that plan's.
ENC_CASES = (
    ("vgg11", "avg", "ttfs", 4, 1), ("vgg11", "avg", "phase", 8, 2),
    ("vgg11", "avg", "rate", 4, 1), ("vgg11", "avg", "radix", 4, 1),
    ("fang_cnn", "avg", "ttfs", 4, 1), ("fang_cnn", "avg", "phase", 8, 2),
    ("fang_cnn", "avg", "rate", 4, 1), ("fang_cnn", "avg", "radix", 4, 1),
    ("fang_cnn", "max", "ttfs", 4, 1), ("fang_cnn", "or", "phase", 8, 2),
)
# a TTFS or rate net whose logits do not vary across images at T = 4 is
# reported and converted again at the next T the reference accepts
RETRY_T = 8
SERVE_REQUESTS, CHAOS_REQUESTS = 64, 32      # phase 10 streams
CLI_ARGV = ["--arch", "fang_cnn", "--encoding", "ttfs", "--pool-mode", "avg",
            "--dataflow", "bitserial"]


def enc_spec(api, name: str, steps: int, periods: int):
    if name == "phase":
        return api.PhaseEncoding(steps, periods=periods)
    return {"radix": api.RadixEncoding, "rate": api.RateEncoding,
            "ttfs": api.TTFSEncoding}[name](steps)


def enc_net(np, name: str, pool: str):
    """(static, params, hw) of the phase-9 nets, numpy seed ``SEED``:
    VGG-11 as phases 3-4 build it, Fang CNN-2 at full width."""
    from repro_torch.models import fang, vgg

    if name == "vgg11":
        return vgg.make(np.random.default_rng(SEED), pool_mode=pool,
                        input_hw=(224, 224, 3), width_mult=1.0,
                        num_classes=100)
    return fang.make(np.random.default_rng(SEED), pool_mode=pool)


def gemm_layers(static) -> tuple:
    """(conv, linear) layer counts: each execution of a kernels plan
    launches the conv kernel once per conv layer and the matmul kernel
    once per linear layer."""
    kinds = [k for k, _ in static]
    return kinds.count("conv"), kinds.count("linear")


def serve_rounds(torch, exe, x, want, label: str) -> list:
    """Requests of REQUESTS sizes twice, each ``torch.equal`` to ``want``;
    returns the stats after each round and checks the second built no
    plan."""
    rounds = []
    for _ in range(2):
        for n in REQUESTS:
            got = exe(x[:n])
            check(tuple(got.shape) == (n, want.shape[1]),
                  f"{label}: logits shape {tuple(got.shape)}")
            check(torch.equal(got, want[:n]),
                  f"{label}: request of {n} != oracle (max |diff| "
                  f"{(got - want[:n]).abs().max()})")
        rounds.append(exe.stats())
    sync(torch)
    check(rounds[1]["compiles"] == rounds[0]["compiles"] == len(exe.buckets),
          f"{label}: plans built in steady state: {rounds[0]['compiles']} "
          f"-> {rounds[1]['compiles']}")
    return rounds


def time_buckets(torch, exe, x, label: str) -> dict:
    """Images/s per bucket by host clock (median of 10 plan calls, each
    ended by a synchronize), and a profile of the top bucket."""
    out = {}
    for b in exe.buckets:
        plan = exe.plan_for(b)
        xb = x[:b].contiguous()
        ms = host_ms(torch, lambda: plan(xb), reps=10)
        out[b] = dict(ms=ms, images_per_s=b / ms * 1e3)
        if b == exe.buckets[-1]:
            out[b]["profile"] = profile_plan(torch, plan, xb, ms)
        prof = out[b].get("profile")
        log(f"[enc] {label} bucket {b}: {ms:.3f} ms, "
            f"{b / ms * 1e3:.1f} images/s"
            + ("" if prof is None else
               f"; device {prof['device_ms_per_call']:.3f} ms/call "
               f"({100 * prof['busy_share']:.1f}% busy), radix kernels "
               f"{prof['radix_kernels_ms_per_call']:.3f} ms")
            + ("; profile: no device time (not measured)"
               if b == exe.buckets[-1] and prof is None else ""))
    return out


def cpu_plane_check(torch, api, exe, x, requests, label: str) -> dict:
    """The timed card plan ``exe`` and the same plan compiled for the CPU
    (the kernels' plain versions) over the same requests: logits and the
    plane-skip counters of those requests must be equal."""
    keys = ("plane_passes_skipped", "plane_passes_total")
    cpu = api.Accelerator(dataflow=exe.dataflow, device="cpu").compile(
        exe.qnet, exe.item_shape, buckets=exe.buckets)
    before = exe.stats()
    for n in requests:
        got, want = exe(x[:n]).cpu(), cpu(x[:n].cpu())
        check(torch.equal(got, want),
              f"{label}: card != CPU plan for a request of {n}")
    after, cs = exe.stats(), cpu.stats()
    out = {k: (after[k] - before[k], cs[k]) for k in keys}
    check(all(a == b for a, b in out.values()),
          f"{label}: plane counters card/CPU {out}")
    return dict(requests=list(requests), **{k: v[0] for k, v in out.items()})


def phase_encodings(torch, np, results) -> dict:
    """TTFS, phase and rate (and radix on the jnp backend) through
    ``convert`` -> ``Accelerator.compile`` -> ``Executable`` at VGG-11's
    full width and Fang CNN-2's; returns the converted nets by case."""
    from repro_torch import api

    dev = torch.device(DEV)
    out, nets, qnets = {}, {}, {}
    for net_name, pool, enc, steps, periods in ENC_CASES:
        if (net_name, pool) not in nets:
            static, params, hw = enc_net(np, net_name, pool)
            params = [None if p is None else {k: v.to(dev)
                                              for k, v in p.items()}
                      for p in params]
            calib = torch.rand((BATCH,) + hw, generator=torch.Generator()
                               .manual_seed(SEED + 1)).to(dev)
            x = torch.rand((max(REQUESTS),) + hw, generator=torch.Generator()
                           .manual_seed(SEED + 2)).to(dev)
            nets[(net_name, pool)] = (static, params, hw, calib, x)
        static, params, hw, calib, x = nets[(net_name, pool)]
        n_conv, n_lin = gemm_layers(static)
        degenerate_at = []
        while True:
            spec = enc_spec(api, enc, steps, periods)
            t0 = time.perf_counter()
            qnet = api.convert(static, params, calib, encoding=spec)
            want = api.oracle(qnet, x, mode="snn")
            packed = api.oracle(qnet, x, mode="packed")
            sync(torch)
            oracle_s = time.perf_counter() - t0
            check(torch.equal(want, packed), f"{net_name}/{spec}: snn != "
                  "packed oracle")
            check(bool(torch.isfinite(want).all()),
                  f"{net_name}/{spec}: non-finite logits")
            spread = float(want.std(dim=0).mean())
            if spread > 0 or enc not in ("ttfs", "rate") or steps == RETRY_T:
                break
            log(f"[enc] {net_name}/{pool}/{spec}: logits do not vary "
                f"across images (degenerate net); converting again at "
                f"T = {RETRY_T}")
            degenerate_at.append(steps)
            steps = RETRY_T
        check(spread > 0, f"{net_name}/{spec}: logits do not vary across "
              "images (degenerate net)")
        key = f"{net_name}/{pool}/{spec.name}{spec.num_steps}" + (
            f"p{periods}" if enc == "phase" else "")
        qnets[key] = (qnet, hw)
        row = dict(net=net_name, pool=pool, encoding=repr(spec),
                   degenerate_at_T=degenerate_at, logits_class_std=spread,
                   argmax_classes=int(torch.unique(want.argmax(1)).numel()),
                   convert_and_oracles_s=oracle_s, runs={})
        backends = (("kernels", "fused"), ("kernels", "bitserial")) \
            if enc in ("ttfs", "phase") else (("jnp", None),)
        for backend, dataflow in backends:
            label = f"{key}/{dataflow or 'jnp'}"
            exe = api.Accelerator(backend=backend, dataflow=dataflow,
                                  device=DEV).compile(qnet, hw,
                                                      buckets=BUCKETS)
            before = counters()
            rounds = serve_rounds(torch, exe, x, want, label)
            after = counters()
            execs = rounds[1]["executions"]
            launches = {k: after[k] - before[k] for k in after}
            n_k = (n_conv, n_lin) if backend == "kernels" else (0, 0)
            check(launches["radix_conv2d"] == n_k[0] * execs
                  and launches["radix_matmul"] == n_k[1] * execs,
                  f"{label}: launches {launches} != ({n_k[0]} conv, "
                  f"{n_k[1]} matmul) x {execs} executions")
            stats = exe.stats()
            run = dict(executions=execs, launches=launches,
                       plane_passes_skipped=stats["plane_passes_skipped"],
                       plane_passes_total=stats["plane_passes_total"],
                       buckets=time_buckets(torch, exe, x, label))
            if backend == "kernels":
                # VGG-11's plain versions take seconds a batch on the CPU:
                # there the check is the request that fills the top bucket,
                # the shape timed above
                run["cpu_plane_check"] = cpu_plane_check(
                    torch, api, exe, x, (BUCKETS[-1],)
                    if net_name == "vgg11" else REQUESTS, label)
            if enc == "radix":
                kexe = api.Accelerator(dataflow="fused", device=DEV).compile(
                    qnet, hw, buckets=BUCKETS)
                for n in REQUESTS:
                    check(torch.equal(exe(x[:n]), kexe(x[:n])),
                          f"{label}: jnp logits != the kernels plan's for "
                          f"a request of {n}")
                run["kernels_fused_buckets"] = time_buckets(
                    torch, kexe, x, f"{key}/fused (beside jnp)")
            row["runs"][dataflow or "jnp"] = run
            log(f"[enc] {label}: requests {REQUESTS} x 2 equal the oracles;"
                f" {execs} executions, launches {launches}, planes skipped "
                f"{stats['plane_passes_skipped']} of "
                f"{stats['plane_passes_total']}"
                + (f"; card == CPU plan ({run['cpu_plane_check']})"
                   if "cpu_plane_check" in run else ""))
        log(f"[enc] {key}: per-class std {spread:.4f}, "
            f"{row['argmax_classes']} distinct argmax classes, convert + "
            f"oracles {oracle_s:.2f} s"
            + (f"; degenerate at T = {degenerate_at}" if degenerate_at
               else ""))
        out[key] = row
    results["encodings"] = out
    return qnets


# ---------------------------------------------------------------------------
# Phase 10: CNN serving (launch/serve_cnn) with its resilience layer.
# ---------------------------------------------------------------------------


def oracle_rows(torch, np_, api, qnet, images):
    """Packed-oracle logits of numpy image batches on the card (16 images
    a call, to bound the float64 convolutions' memory)."""
    x = torch.from_numpy(np_.concatenate(images)).to(DEV)
    return torch.cat([api.oracle(qnet, x[i:i + 16], mode="packed")
                      for i in range(0, x.shape[0], 16)])


def serve_stream(torch, np_, server, queue, sizes, want, label: str) -> dict:
    """``run_request_stream`` of ``sizes`` (seed ``SEED + 11``) through
    ``queue``: every ticket equal to its rows of ``want``; returns the
    stream's rates, latency percentiles and the server counters it
    moved."""
    from repro_torch.launch import serve_cnn

    before = server.stats()
    t0 = time.perf_counter()
    tickets = serve_cnn.run_request_stream(queue, sizes, seed=SEED + 11)
    wall = time.perf_counter() - t0
    check(all(t.ok for t in tickets),
          f"{label}: unresolved or failed tickets "
          f"{[type(t.error).__name__ for t in tickets if not t.ok]}")
    off = 0
    for t in tickets:
        check(torch.equal(t.result, want[off:off + t.size]),
              f"{label}: a ticket of {t.size} images != the oracle rows")
        off += t.size
    after = server.stats()
    lat = [t.latency_s * 1e3 for t in tickets]
    n_img = int(sum(sizes))
    out = dict(requests=len(tickets), images=n_img, wall_s=wall,
               requests_per_s=len(tickets) / wall,
               images_per_s=n_img / wall,
               p50_ms=float(np_.percentile(lat, 50)),
               p99_ms=float(np_.percentile(lat, 99)),
               flushes=queue.flushes, health=queue.health.state,
               **{k: after[k] - before[k] for k in (
                   "executions", "padded_rows", "degraded_flushes")})
    log(f"[serve] {label}: {len(tickets)} requests / {n_img} images in "
        f"{wall:.3f} s: {out['requests_per_s']:.1f} requests/s, "
        f"{out['images_per_s']:.1f} images/s, latency p50 "
        f"{out['p50_ms']:.2f} ms p99 {out['p99_ms']:.2f} ms; "
        f"{queue.flushes} flushes ({out['degraded_flushes']} degraded), "
        f"{out['executions']} executions, {out['padded_rows']} padded rows,"
        f" health {queue.health.state}; every ticket equals the oracle")
    return out


def phase_serving(torch, np_, qnet, hw, results) -> None:
    """A ``CNNServer`` over VGG-11 phase (8, 2) bitserial: a clean stream,
    the same stream under a straggler window that flags nothing, a chaos
    drill on the same server, then the CLI once."""
    from repro_torch import api
    from repro_torch.launch import serve_cnn
    from repro_torch.runtime import resilience as rz
    from repro_torch.runtime.straggler import StragglerMonitor

    server = serve_cnn.CNNServer(qnet, hw, buckets=BUCKETS,
                                 dataflow="bitserial", device=DEV)
    server.warmup()
    built = server.stats()["compiles"]
    launched, execs0 = counters(), server.stats()["executions"]
    sizes = np_.random.default_rng(SEED + 10).integers(1, 5, SERVE_REQUESTS)
    # run_request_stream's draws, timed: the stream makes them inside its
    # wall
    t0 = time.perf_counter()
    rng = np_.random.default_rng(SEED + 11)
    images = [rng.uniform(0, 1, (int(n),) + tuple(hw)).astype(np_.float32)
              for n in sizes]
    gen_s = time.perf_counter() - t0
    log(f"[serve] the stream's {int(sum(sizes))} images take {gen_s:.3f} s "
        "to draw on the host")
    want = oracle_rows(torch, np_, api, qnet, images)
    clean = serve_stream(torch, np_, server, serve_cnn.MicroBatchQueue(
        server), sizes, want, "VGG-11 phase(8,2) bitserial")
    # the same stream with no flush ever flagged as a straggler: the queue
    # never degrades to smaller flush groups
    steady = serve_stream(torch, np_, server, serve_cnn.MicroBatchQueue(
        server, health=rz.HealthMonitor(StragglerMonitor(threshold=1e9))),
        sizes, want, "the same stream, no straggler flags")
    check(steady["degraded_flushes"] == 0,
          f"serving: {steady['degraded_flushes']} degraded flushes with a "
          "window that flags nothing")
    check(server.stats()["compiles"] == built == len(BUCKETS),
          f"serving: plans built in steady state: {built} -> "
          f"{server.stats()['compiles']}")

    # chaos drill: one poison request, a transient fault every 5th infer
    before = server.stats()
    plan = rz.FaultPlan(fail_every=5, poison_nan=True)
    chaos = rz.ChaosServer(server, plan)
    drill = serve_cnn.MicroBatchQueue(
        chaos, retry=rz.RetryPolicy(max_retries=2, backoff_s=0.001))
    rng = np_.random.default_rng(SEED + 12)
    sizes = rng.integers(1, 5, CHAOS_REQUESTS)
    reqs = [rng.uniform(0, 1, (int(n),) + tuple(hw)).astype(np_.float32)
            for n in sizes]
    poison_at = CHAOS_REQUESTS // 3
    reqs[poison_at][:] = np_.nan
    tickets = [drill.submit(r) for r in reqs]
    drill.flush()
    after = server.stats()
    delta = {k: after[k] - before[k] for k in (
        "rejected", "shed", "retried", "quarantined", "degraded_flushes",
        "failures", "executions")}
    errors = [type(t.error).__name__ for t in tickets if not t.ok]
    check(all(t.done for t in tickets), "chaos: a ticket never resolved")
    check(all(isinstance(t.error, rz.ServeError) for t in tickets
              if not t.ok), f"chaos: untyped ticket errors {errors}")
    check(isinstance(tickets[poison_at].error, rz.RequestPoisoned),
          f"chaos: the poison ticket resolved as "
          f"{type(tickets[poison_at].error).__name__}")
    check(errors.count("RequestPoisoned") == delta["quarantined"] == 1,
          f"chaos: quarantined {delta['quarantined']}, errors {errors}")
    check(errors.count("AdmissionError") == delta["rejected"]
          and errors.count("DeadlineExceeded") == delta["shed"] == 0,
          f"chaos: rejected/shed {delta} vs errors {errors}")
    # every infer call either took an injected fault or resolved a flush
    check(plan.calls == drill.flushes + plan.total_injected
          and delta["failures"] == 0,
          f"chaos: {plan.calls} calls != {drill.flushes} flushes + "
          f"{plan.injected}, real failures {delta['failures']}")
    check(plan.injected["transient"] > 0 and plan.injected["poison"]
          >= 1 + drill.retry.max_retries,
          f"chaos: injected {plan.injected}")
    ok = [i for i, t in enumerate(tickets) if t.ok]
    want = oracle_rows(torch, np_, api, qnet, [reqs[i] for i in ok])
    off = 0
    for i in ok:
        n = tickets[i].size
        check(torch.equal(tickets[i].result, want[off:off + n]),
              f"chaos: healthy ticket {i} != the oracle rows")
        off += n
    check(server.stats()["compiles"] == built,
          "chaos: a plan was built during the drill")
    n_conv, n_lin = gemm_layers(qnet.static)
    execs = server.stats()["executions"] - execs0
    launches = {k: v - launched[k] for k, v in counters().items()}
    check(launches["radix_conv2d"] == n_conv * execs
          and launches["radix_matmul"] == n_lin * execs,
          f"serving: launches {launches} != ({n_conv} conv, {n_lin} "
          f"matmul) x {execs} executions of the streams and the drill")
    chaos_out = dict(requests=CHAOS_REQUESTS, injected=dict(plan.injected),
                     calls=plan.calls, flushes=drill.flushes,
                     ok=len(ok), health=drill.health.state, **delta)
    log(f"[serve] chaos drill: {CHAOS_REQUESTS} requests, injected "
        f"{plan.injected} over {plan.calls} infer calls; {len(ok)} "
        f"resolved equal to the oracle, errors {errors}; counters {delta};"
        f" health {drill.health.state}")

    from repro_torch.models import fang

    launched = counters()
    t0 = time.perf_counter()
    cli = serve_cnn.main(CLI_ARGV)
    cli_s = time.perf_counter() - t0
    check(cli["ok"] == cli["requests"] and cli["stats"]["failures"] == 0,
          f"serve_cnn.main({CLI_ARGV}): {cli['ok']} of {cli['requests']} "
          "requests served")
    # the CLI's warmup runs each bucket's plan once besides the executions
    n_conv, n_lin = gemm_layers(fang.static()[0])
    runs = cli["stats"]["executions"] + len(
        serve_cnn._parse_args(CLI_ARGV).bucket_ladder)
    cli_launches = {k: v - launched[k] for k, v in counters().items()}
    check(cli_launches["radix_conv2d"] == n_conv * runs
          and cli_launches["radix_matmul"] == n_lin * runs,
          f"serve_cnn.main: launches {cli_launches} != ({n_conv} conv, "
          f"{n_lin} matmul) x {runs} plan runs")
    log(f"[serve] serve_cnn.main {' '.join(CLI_ARGV)}: {cli['requests']} "
        f"requests, {cli_s:.2f} s with conversion and warmup")
    results["serving"] = dict(
        clean=clean, no_straggler_flags=steady, image_draw_s=gen_s,
        chaos=chaos_out,
        launches=launches, cli_launches=cli_launches,
        cli=dict(argv=CLI_ARGV, s=cli_s, **{k: cli[k] for k in (
            "requests", "ok", "images", "wall_s", "p50_ms", "p95_ms",
            "health")}))


# ---------------------------------------------------------------------------
# Phase 11: the autotuner (kernels/autotune.py) and the memory model.
# ---------------------------------------------------------------------------

AUTOTUNE_BUCKET = 8            # VGG-11's tuned plans
LM_TUNE_BUCKETS = (64,)        # Gemma-2B's tuned prefill plan (+ decode)
LM_TUNE_REQUEST = (8, 48, 8)   # (prompts, tokens, new tokens)


def _launch_name(row: dict) -> str:
    return ("default" if (row["bm"], row["split"]) == (0, 0)
            else f"{row['bm']}x{row['bn']}x{row['bk']}/k{row['split']}"
            if row["bm"] else f"plan tile/k{row['split']}")


def candidate_check(torch, calls, results) -> None:
    """Every launch the tuner offers for each distinct ``calls`` problem
    (VGG-11's layers at bucket 8, Gemma-2B's FFN products at the tuned
    plans' M), both dataflows: ``torch.equal`` to the untuned launch on
    seeded levels."""
    t0 = time.perf_counter()
    from repro_torch.core.encoding import KernelSchedule
    from repro_torch.kernels import autotune, gemm

    fns = _kernel_fns()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 50)
    dev = torch.device("cuda")
    done, compared = set(), 0
    for call in calls:
        key = _shape_key(call)
        if key in done:
            continue
        done.add(key)
        kernel_fn, _, prep = fns[call["kernel"]]
        bits = call["bits"]
        x = torch.randint(0, 1 << bits, call["x"], generator=gen,
                          device=dev).to(
            torch.uint8 if bits <= 8 else torch.int32)
        wq = prep(torch.randint(-127, 128, call["w"], generator=gen,
                                device=dev).to(torch.int8))
        n = call["w"][-1]
        epi = dict(bias=torch.randint(-64, 64, (1, n), generator=gen,
                                      device=dev, dtype=torch.int32),
                   mult=torch.rand((1, n), generator=gen, device=dev)
                   * 0.002) if call["epi"] else {}
        sched = KernelSchedule(packed_bits=bits)
        base = dict(num_steps=bits, out_steps=T, kmajor=True, **epi)
        if call["kernel"] == "radix_conv2d":
            base["stride"] = call["stride"]
        for method in ("fused", "bitserial"):
            if call["kernel"] == "radix_conv2d":
                b, h, w, cin = call["x"]
                kh, kw, _, cout = call["w"]
                cands = autotune.conv_candidates(
                    h, w, cin, kh, kw, cout, call["stride"], sched, method,
                    batch=b, backend=dev, sms=gemm.device_sms(dev))
            else:
                m, k, n = call["mkn"]
                cands = autotune.matmul_candidates(
                    m, k, n, sched, method, backend=dev,
                    sms=gemm.device_sms(dev))
            want = kernel_fn(x, wq, method=method, **base)
            for cfg in cands[1:]:
                got = kernel_fn(x, wq, method=method, config=cfg, **base)
                compared += 1
                check(torch.equal(got, want),
                      f"{call['kernel']} {key} {method} {cfg}: a tuned "
                      "launch differs from the untuned one")
    sync(torch)
    results["autotune"]["candidates_compared"] = compared
    log(f"[autotune] every candidate launch equals the untuned launch "
        f"(torch.equal): {compared} launches over VGG-11's layers at "
        f"bucket 8 and Gemma-2B's FFN products, both dataflows, "
        f"{time.perf_counter() - t0:.1f} s")


def phase_autotune(torch, run: dict, hw, results) -> None:
    """VGG-11 (radix T = 4, 224 x 224 x 3) compiled with ``autotune=True``
    at bucket 8 for both dataflows against a fresh winner table; logits
    ``torch.equal`` to the untuned plan and the oracle; a second compile
    sweeps nothing; ``Executable.memory()``."""
    import os
    import tempfile

    from repro_torch import api
    from repro_torch.kernels import autotune

    table = Path(tempfile.mkdtemp(prefix="autotune-")) / "autotune.json"
    os.environ["REPRO_TORCH_AUTOTUNE_CACHE"] = str(table)
    autotune.reset_default_cache()
    cache = autotune.default_cache()
    check(cache.path == table and not table.exists(),
          f"autotune table not fresh: {cache.path}")
    qnet, x, want = run["qnet"], run["x"][:AUTOTUNE_BUCKET], run["want"]
    n_layers = sum(1 for k, _ in qnet.static if k in ("conv", "linear"))
    out = dict(table=str(table), dataflows={})
    for dataflow in ("fused", "bitserial"):
        acc = api.Accelerator(dataflow=dataflow)
        before = cache.stats.as_dict()
        t0 = time.perf_counter()
        exe = acc.compile(qnet, hw, buckets=(AUTOTUNE_BUCKET,),
                          autotune=True).warmup()
        sweep_s = time.perf_counter() - t0
        mid = cache.stats.as_dict()
        got = exe(x)
        plain = acc.compile(qnet, hw, buckets=(AUTOTUNE_BUCKET,))(x)
        sync(torch)
        check(torch.equal(got, plain) and torch.equal(got,
                                                      want[:len(x)]),
              f"vgg11/{dataflow}: tuned logits differ from the untuned plan "
              "or the oracle")
        check(mid["sweeps"] - before["sweeps"] == n_layers
              and mid["skipped"] == 0,
              f"vgg11/{dataflow}: sweeps {before} -> {mid}")
        rows = exe.stats()["autotune"]["layers"]
        impl = "cuda" if DEV == "cuda" else "plain"
        check(len(rows) == n_layers and all(r["tuned"] and r["impl"] == impl
                                            for r in rows),
              f"vgg11/{dataflow}: tuned rows {rows}")
        for r in rows:
            log(f"[autotune] vgg11 {dataflow:9s} {r['layer']:22s} "
                + "; ".join(f"{_launch_name(c)} {c['us']:.1f} us"
                            for c in r["sweep"])
                + f" -> winner {r['bm']}x{r['bn']}x{r['bk']}/k{r['split']}")
        # a second compile of the same problems: every layer a hit
        t0 = time.perf_counter()
        again = acc.compile(qnet, hw, buckets=(AUTOTUNE_BUCKET,),
                            autotune=True).warmup()
        again_s = time.perf_counter() - t0
        after = cache.stats.as_dict()
        check(torch.equal(again(x), got), f"vgg11/{dataflow}: second "
              "compile's logits differ")
        check(after["sweeps"] == mid["sweeps"]
              and after["hits"] - mid["hits"] == n_layers
              and after["skipped"] == 0,
              f"vgg11/{dataflow}: second compile {mid} -> {after}")
        ab = tuned_vs_untuned(torch, {
            "untuned": acc.compile(qnet, hw, buckets=(AUTOTUNE_BUCKET,))
            .plan_for(AUTOTUNE_BUCKET), "tuned": exe.plan_for(
                AUTOTUNE_BUCKET)}, x)
        out["dataflows"][dataflow] = dict(
            sweep_s=sweep_s, second_compile_s=again_s, layers=rows,
            stats_first=mid, stats_second=after, timing=ab)
        log(f"[autotune] vgg11 {dataflow}: compile with sweep {sweep_s:.2f} s"
            f" ({mid['sweeps'] - before['sweeps']} sweeps, "
            f"{sum(len(r['sweep']) for r in rows)} candidates, 0 skipped); "
            f"second compile {again_s:.2f} s, {after['hits'] - mid['hits']} "
            f"hits, 0 sweeps; logits equal the untuned plan and the oracle")
    mem = api.Accelerator().compile(qnet, hw).memory()
    out["memory"] = dataclasses.asdict(mem)
    log(f"[memory] vgg11 Executable.memory() (the paper's accelerator, Sec. "
        f"III-C; T = {qnet.num_steps}, {qnet.weight_bits}-bit weights): "
        f"2-D ping-pong {mem.buf2d_bytes} B, 1-D {mem.buf1d_bytes} B, total "
        f"{mem.total_buffer_bytes} B; weights {mem.total_param_bytes} B, "
        f"needs DRAM {mem.needs_dram}; per layer (name, act reads, weight "
        f"reads): " + "; ".join(f"{l.name} {l.act_reads} {l.weight_reads}"
                                for l in mem.layers))
    results["autotune"] = out


def tuned_vs_untuned(torch, plans: dict, xb) -> dict:
    """Wall ms (host clock, median of 10) and device ms by kernel kind
    (profiler, three calls) of each plan, in turns untuned, tuned, tuned,
    untuned; per plan the medians over its two turns."""
    got = {k: [] for k in plans}
    for name in ("untuned", "tuned", "tuned", "untuned"):
        plan = plans[name]
        wall = host_ms(torch, lambda: plan(xb), reps=10)
        prof = profile_plan(torch, plan, xb, wall) or {}
        got[name].append((wall, prof.get("device_ms_per_call"),
                          prof.get("radix_kernels_ms_per_call")))
    out = {}
    for name, runs in got.items():
        out[name] = dict(
            wall_ms=statistics.median(r[0] for r in runs),
            device_ms=None if None in [r[1] for r in runs]
            else statistics.median(r[1] for r in runs),
            radix_ms=None if None in [r[2] for r in runs]
            else statistics.median(r[2] for r in runs), runs=runs)
    log("[autotune] A/B at bucket 8 (untuned, tuned, tuned, untuned): "
        + "; ".join(f"{k} wall {v['wall_ms']:.3f} ms, device "
                    f"{v['device_ms']} ms, radix kernels {v['radix_ms']} ms"
                    for k, v in out.items()))
    return out


def lm_matmul_tune_calls() -> list:
    """Gemma-2B's FFN products at the tuned plans' M (bucket 64 prefill,
    decode), as ``kernel_calls`` rows."""
    from repro_torch.configs import gemma_2b

    cfg = gemma_2b.ARCH
    calls = []
    for m in (LM_BATCH * LM_TUNE_BUCKETS[0], LM_BATCH):
        for k, n in ((cfg.d_model, cfg.d_ff), (cfg.d_ff, cfg.d_model)):
            calls.append(dict(kernel="radix_matmul", x=(m, k), w=(k, n),
                              stride=1, bits=T, epi=False, mkn=(m, k, n)))
    return calls


def lm_tuned_vs_untuned(torch, cfg, exes: dict) -> dict:
    """Prefill ms (bucket 64, full batch) and decode ms a step by host
    clock, and a decode step's device ms (profiler), of each executable,
    in turns untuned, tuned, tuned, untuned; medians over the turns."""
    prompts = lm_prompts(torch, cfg, LM_BATCH, LM_TUNE_BUCKETS[0], SEED + 61)
    runs = {k: [] for k in exes}
    for name in ("untuned", "tuned", "tuned", "untuned"):
        exe = exes[name]
        state = exe.prefill(prompts)
        tok = state["logits"].argmax(-1)[:, None]
        runs[name].append((
            host_ms(torch, lambda: exe.prefill(prompts), reps=3, warmup=1),
            host_ms(torch, lambda: exe.decode(state, tok), reps=10),
            device_ms(torch, lambda: exe.decode(state, tok), None, reps=5)))
    out = {}
    for name, rs in runs.items():
        dev = [r[2] for r in rs]
        out[name] = dict(prefill_ms=statistics.median(r[0] for r in rs),
                         decode_ms=statistics.median(r[1] for r in rs),
                         decode_device_ms=None if None in dev
                         else statistics.median(dev), runs=rs)
    log("[autotune] gemma-2b A/B (untuned, tuned, tuned, untuned): "
        + "; ".join(f"{k} prefill {v['prefill_ms']:.2f} ms, decode "
                    f"{v['decode_ms']:.3f} ms a step (device "
                    f"{v['decode_device_ms']} ms)" for k, v in out.items()))
    return out


def phase_autotune_lm(torch, arch, results) -> None:
    """Gemma-2B at full width (bf16, T = 4, packed KV and attention)
    compiled with ``autotune=True`` (``kernel_autotune``) at bucket 64 and
    the decode plan, both dataflows: one request's logits at every step
    ``torch.equal`` to the plain path with the same tuned launches."""
    from repro_torch import api
    from repro_torch.kernels import autotune
    from repro_torch.lm import model

    cache = autotune.default_cache()
    cfg = dataclasses.replace(arch, radix_steps=T, radix_kv_pack=True,
                              packed_attn=True)
    params = model.init_params(
        torch.Generator(device=DEV).manual_seed(SEED), cfg, device=DEV)
    n, s0, new = LM_TUNE_REQUEST
    prompts = lm_prompts(torch, cfg, n, s0, SEED + 60)
    out = {}
    for dataflow in ("fused", "bitserial"):
        before = cache.stats.as_dict()
        t0 = time.perf_counter()
        exe = api.Accelerator(dataflow=dataflow).compile(
            (params, cfg), (LM_BATCH, LM_MAX_LEN), buckets=LM_TUNE_BUCKETS,
            autotune=True)
        sync(torch)
        sweep_s = time.perf_counter() - t0
        mid = cache.stats.as_dict()
        rows = exe.stats()["autotune"]["layers"]
        check(exe.cfg.kernel_autotune and mid["skipped"] == 0 and all(
            r["tuned"] for r in rows) and any(r["layer"] == "decode_attn"
                                              for r in rows),
              f"gemma-2b/{dataflow}: tuned rows {rows}, stats {mid}")
        r = serve_greedy(exe, prompts, new)
        check(DEV != "cuda" or (
            r["launches"]["radix_matmul"] == 3 * cfg.n_layers * new
            and r["launches"]["radix_decode_attn"]
            == cfg.n_layers * (new - 1)),
              f"gemma-2b/{dataflow} tuned: launches {r['launches']}")
        after = cache.stats.as_dict()
        check(after["sweeps"] == mid["sweeps"],
              f"gemma-2b/{dataflow}: serving swept: {mid} -> {after}")
        plain_cfg = dataclasses.replace(exe.cfg, use_kernel=False)
        ref = plain_logits(model, exe.params, plain_cfg, prompts,
                           r["tokens"], exe._cache.bucket_for(s0))
        c = compare_logits(torch, r["logits"], ref)
        check(c["equal"], f"gemma-2b/{dataflow} tuned: logits differ from "
              f"the plain path with the same launches {c}")
        untuned = api.Accelerator(dataflow=dataflow).compile(
            (params, cfg), (LM_BATCH, LM_MAX_LEN), buckets=LM_TUNE_BUCKETS)
        timing = lm_tuned_vs_untuned(torch, cfg, {"untuned": untuned,
                                                  "tuned": exe})
        out[dataflow] = dict(sweep_s=sweep_s, layers=rows, stats=after,
                             comparison=c, timing=timing)
        log(f"[autotune] gemma-2b {dataflow:9s}: compile with sweep "
            f"{sweep_s:.2f} s ({mid['sweeps'] - before['sweeps']} sweeps, 0 "
            f"skipped); winners: " + "; ".join(
                f"{row['layer']} m={row['m']}: "
                + (f"split {row['split_slots']}/{row['max_splits']}"
                   if row["layer"] == "decode_attn"
                   else _launch_name(row)) for row in rows)
            + f"; {n} x {s0} tokens + {new} new: logits equal the plain path "
            f"at every step")
    del params
    torch.cuda.empty_cache()
    results["autotune_lm"] = out


# ---------------------------------------------------------------------------
# Phase 12: the LM archs beyond Gemma-2B.
# ---------------------------------------------------------------------------

# (config module, layers kept (0: all), dataflows, requests as (prompts,
# tokens or embeds, new tokens), served through ("compile": the
# ``Accelerator``, "generate": ``launch.serve.generate``, "model":
# ``lm.model.prefill`` / ``decode_step``), buckets of a compiled arch, else
# None): DeepSeek-Coder-33B's bf16 tree is
# ~66.8 GB at its 62 layers, and radixifying a stacked FFN leaf on the card
# adds its int8 copy (8.5 GB at 62 layers) and float temporaries, so it
# runs 16 layers; RecurrentGemma's second request (2100 tokens) is longer
# than its 2048-slot window, so prefill rolls the ring and decode wraps.
ARCH_PHASES = (
    ("glm4_9b", 0, ("fused", "bitserial"), ((8, 40, 8), (3, 200, 8)),
     "compile", LM_BUCKETS),
    ("gemma_7b", 0, ("fused",), ((8, 40, 8),), "compile", LM_BUCKETS),
    ("deepseek_coder_33b", 16, ("fused",), ((8, 40, 8),), "compile",
     LM_BUCKETS),
    ("recurrentgemma_2b", 0, ("fused",), ((8, 64, 16), (2, 2100, 8)),
     "generate", None),
    ("rwkv6_3b", 0, ("fused",), ((8, 256, 16),), "generate", None),
)


def arch_cfg(name: str, layers: int):
    """The arch's published config in bf16 at T = 4 with packed KV and
    packed decode attention, cut to ``layers`` layers when non-zero."""
    import importlib

    cfg = importlib.import_module(f"repro_torch.configs.{name}").ARCH
    cfg = dataclasses.replace(cfg, radix_steps=T, radix_kv_pack=True,
                              packed_attn=True)
    return dataclasses.replace(cfg, n_layers=layers) if layers else cfg


def lm_launches(cfg) -> tuple:
    """(radix_matmul, radix_decode_attn, encoder radix_matmul) launches,
    as ``model.radixify_params`` leaves the weights: the first two of one
    forward over one token position (each layer's radix FFN products:
    none for RWKV's channel mix or routed MoE experts, the shared
    experts' for Kimi-K2; an untied unembed outside the MoE family; in
    decode one attention per self-attention layer, cross-attention being
    plain), the third of an encoder's FFNs, once per prefill."""
    gated = 3 if cfg.act in ("swiglu", "geglu") else 2
    ffn = gated if cfg.moe is None or cfg.moe.num_shared else 0
    types = cfg.layer_types
    mm = sum(ffn for t in types if t != "rwkv6")
    mm += 0 if cfg.tie_embeddings or cfg.family == "moe" else 1
    return (mm, sum(t in ("attn", "local_attn") for t in types),
            gated * cfg.encoder_layers)


def path_kernels(cfg) -> tuple:
    """The kernels an arch's path must launch (``lm_launches`` > 0)."""
    mm, attn, enc = lm_launches(cfg)
    return tuple(k for k, n in (("radix_matmul", mm + enc),
                                ("radix_decode_attn", attn)) if n)


def arch_params(torch, model, cfg) -> tuple:
    """Seeded bf16 weights drawn on the card; (params, count)."""
    params = model.init_params(
        torch.Generator(device=DEV).manual_seed(SEED), cfg)
    sizes = []
    model.tree_map(lambda t: sizes.append(t.numel()), params)
    return params, sum(sizes)


def log_arch_profile(name: str, dataflow: str, prof: dict, n_attn: int,
                     row: dict) -> None:
    for step, pr in prof.items():
        if pr is None:
            log(f"[arch] {name} {dataflow} {step} profile: no device time "
                "recorded (not measured)")
            continue
        share = pr["attn_ms"] / pr["device_ms"]
        row[f"{step}_attn_share"] = share
        log(f"[arch] {name} {dataflow} {step} profile: device "
            f"{pr['device_ms']:.3f} ms per call of "
            f"{pr['profiled_wall_ms']:.3f} ms profiled wall "
            f"({100 * pr['busy_share']:.1f}% busy), "
            f"{pr['device_kernels']:.0f} device kernels a call, radix "
            f"kernels {pr['radix_ms']:.3f} ms, decode attention "
            f"{pr['attn_ms']:.3f} ms ({100 * share:.1f}% of the device time"
            + (f"; {pr['attn_ms'] / n_attn:.4f} ms a launch"
               if n_attn and pr["attn_ms"] else "")
            + "); top: " + "; ".join(f"{k} {v:.3f} ms x{c}"
                                     for k, v, c in pr["top"]))


def phase_arch_compiled(torch, name, cfg, dataflows, requests, results,
                        buckets) -> None:
    """A dense GQA or MoE arch served through ``Accelerator.compile`` at
    (batch, max_len) = (8, 512) and ``buckets``: every request's logits
    ``torch.equal`` to the plain path at every step, and the launches of
    ``lm_launches`` per token position; for a MoE arch the dense expert
    products' share of the profiled device time."""
    from repro_torch import api
    from repro_torch.lm import model

    t_phase = time.perf_counter()
    if DEV == "cuda":
        torch.cuda.reset_peak_memory_stats()
    params, n_params = arch_params(torch, model, cfg)
    mm, attn, _ = lm_launches(cfg)
    out = dict(params=n_params, layers=cfg.n_layers,
               launches_per_step=dict(radix_matmul=mm,
                                      radix_decode_attn=attn),
               dataflows={})
    for dataflow in dataflows:
        exe = api.Accelerator(dataflow=dataflow, device=DEV).compile(
            (params, cfg), (LM_BATCH, LM_MAX_LEN), buckets=buckets)
        exe.warmup()
        built = exe.stats()["compiles"]
        check(built == len(buckets) + 1, f"{name}: warmup built {built}")
        plain_cfg = dataclasses.replace(exe.cfg, use_kernel=False)
        cmp = []
        for i, (n, s0, new) in enumerate(requests):
            prompts = lm_prompts(torch, cfg, n, s0, SEED + 70 + i)
            r = serve_greedy(exe, prompts, new)
            want = {"radix_matmul": mm * new,
                    "radix_decode_attn": attn * (new - 1),
                    "radix_conv2d": 0, "spike_encode": 0}
            check(DEV != "cuda" or r["launches"] == want,
                  f"{name} {dataflow} request {i}: "
                  f"launches {r['launches']} != {want}")
            check(all(tuple(x.shape) == (n, cfg.vocab)
                      and bool(torch.isfinite(x).all()) for x in r["logits"]),
                  f"{name}: logits shape / finiteness")
            ref = plain_logits(model, exe.params, plain_cfg, prompts,
                               r["tokens"], exe._cache.bucket_for(s0))
            c = compare_logits(torch, r["logits"], ref)
            check(c["equal"], f"{name} {dataflow} request {i}: logits "
                  f"differ from the plain path {c}")
            cmp.append(c)
        check(exe.stats()["compiles"] == built,
              f"{name} {dataflow}: plans built in steady state")
        row = out["dataflows"][dataflow] = dict(comparisons=cmp)
        log(f"[arch] {name} {dataflow}: " + "; ".join(
            f"{n} x {s0} tokens + {new} new: logits equal the plain path at "
            f"every step, {mm * new} radix_matmul + "
            f"{attn * (new - 1)} radix_decode_attn launches"
            for n, s0, new in requests))
        lm_timings(torch, cfg, exe, row, request=requests[0],
                   tag=f"arch {name}")
        row["profile"] = profile_lm(torch, exe, lm_prompts(
            torch, cfg, LM_BATCH, buckets[-1], SEED + 30))
        log_arch_profile(name, dataflow, row["profile"], attn, row)
        if cfg.moe is not None:
            expert_share(torch, name, cfg, params, row,
                         LM_BATCH * buckets[-1])
        del exe
    finish_arch(torch, name, out, params, t_phase, results)


def expert_share(torch, name, cfg, params, row, n_prefill: int) -> None:
    """The dense expert products (``moe.expert_outputs``: every expert on
    every token, the ``ref`` dispatch's three batched products) of one
    layer at the profiled prefill's and decode step's token counts,
    device time by the profiler, times the layers, as a share of the
    profiled device time."""
    from repro_torch.lm import model, moe

    lp = model.tree_map(lambda t: t[0], params["segments"][0][0]["ffn"])
    gen = torch.Generator(device=DEV).manual_seed(SEED + 95)
    for step, n in (("prefill", n_prefill), ("decode", LM_BATCH)):
        x2 = torch.randn((n, cfg.d_model), generator=gen, device=DEV).to(
            lp["w_gate"].dtype)
        with torch.inference_mode():
            ms = device_ms(torch, lambda: moe.expert_outputs(x2, lp, cfg),
                           None, reps=3)
        pr = row["profile"].get(step)
        share = (None if ms is None or pr is None
                 else cfg.n_layers * ms / pr["device_ms"])
        row[f"{step}_expert_ms"], row[f"{step}_expert_share"] = ms, share
        log(f"[arch] {name} {step}: dense expert products "
            + ("not measured" if ms is None else
               f"{ms:.3f} ms a layer at {n} tokens ({cfg.moe.num_experts} "
               f"experts x {cfg.moe.d_ff_expert} wide)")
            + (f", {100 * share:.1f}% of the profiled device time over "
               f"{cfg.n_layers} layers" if share is not None else ""))


def phase_arch_generate(torch, name, cfg, requests, results) -> None:
    """An arch served through ``launch.serve.generate`` (unbucketed
    prefill, then decode) with radix weights in the kernels' K-major
    layout, fused dataflow: tokens and every step's logits ``torch.equal``
    to the plain path, and the launches of ``lm_launches``."""
    from repro_torch.launch import serve
    from repro_torch.lm import model

    t_phase = time.perf_counter()
    if DEV == "cuda":
        torch.cuda.reset_peak_memory_stats()
    cfg = dataclasses.replace(cfg, quant="radix", use_kernel=True,
                              kernel_dataflow="fused")
    plain_cfg = dataclasses.replace(cfg, use_kernel=False)
    params, n_params = arch_params(torch, model, cfg)
    params = model.kmajor_params(model.radixify_params(params, cfg))
    mm, attn, _ = lm_launches(cfg)
    out = dict(params=n_params, layers=cfg.n_layers,
               launches_per_step=dict(radix_matmul=mm,
                                      radix_decode_attn=attn),
               dataflows={"fused": {"requests": []}})
    row = out["dataflows"]["fused"]
    for i, (n, s0, new) in enumerate(requests):
        prompts = lm_prompts(torch, cfg, n, s0, SEED + 80 + i)
        before = counters()
        t0 = time.perf_counter()
        toks, logits = serve.generate(cfg, params, prompts, new,
                                      return_logits=True)
        sync(torch)
        req_s = time.perf_counter() - t0
        after = counters()
        launches = {k: after[k] - before[k] for k in after}
        want = {"radix_matmul": mm * new,
                "radix_decode_attn": attn * (new - 1),
                "radix_conv2d": 0, "spike_encode": 0}
        check(DEV != "cuda" or launches == want,
              f"{name} request {i}: launches {launches} != {want}")
        check(tuple(toks.shape) == (n, s0 + new) and all(
            tuple(x.shape) == (n, cfg.vocab) and bool(torch.isfinite(x).all())
            for x in logits), f"{name}: output shape / finiteness")
        ptoks, plogits = serve.generate(plain_cfg, params, prompts, new,
                                        return_logits=True)
        c = compare_logits(torch, logits, plogits)
        check(c["equal"] and torch.equal(toks, ptoks), f"{name} request "
              f"{i}: tokens or logits differ from the plain path {c}")
        req = dict(request=(n, s0, new), comparison=c, request_s=req_s,
                   launches=launches)
        with torch.inference_mode():
            batch = {"tokens": torch.nn.functional.pad(prompts, (0, 1))}

            def prefill():
                return model.prefill(params, batch, cfg, max_len=s0 + new)

            req["prefill_ms"] = host_ms(torch, prefill, reps=3, warmup=1)
            caches = prefill()[1]
            tok = toks[:, s0:s0 + 1]

            def decode():
                return model.decode_step(params, caches, tok, s0, cfg)

            req["decode_ms"] = host_ms(torch, decode, reps=10)
            if i == 0:
                row["profile"] = profile_steps(
                    torch, prefill, lambda: [decode() for _ in range(3)])
        row["requests"].append(req)
        log(f"[arch] {name} fused: {n} x {s0} tokens + {new} new through "
            f"generate: tokens and logits equal the plain path at every "
            f"step, launches {launches}; request {req_s:.3f} s; prefill "
            f"{req['prefill_ms']:.2f} ms "
            f"({n * s0 / req['prefill_ms'] * 1e3:.0f} prompt tokens/s); "
            f"decode {req['decode_ms']:.3f} ms a step "
            f"({n / req['decode_ms'] * 1e3:.1f} tokens/s at batch {n})")
    log_arch_profile(name, "fused", row["profile"], attn, row)
    finish_arch(torch, name, out, params, t_phase, results)


# ---------------------------------------------------------------------------
# Phase 13: the MoE archs, Whisper-medium and Qwen2-VL-72B.
# ---------------------------------------------------------------------------

# Laid out as ``ARCH_PHASES``, all fused.  Grok-1 keeps 4 of its 64
# layers (the routed experts are 9.66 GB a layer in bf16: the tree is
# ~42.6 GB), Kimi-K2 1 of its 61 (384 experts are 33.8 GB a layer, the
# tree ~38.8 GB; two layers do not fit beside the ``ref`` dispatch's
# transients), Qwen2-VL-72B 12 of its 80 (~2.48 GB a layer with its int8
# FFN copy, the tree ~36 GB); Whisper-medium runs all 24 + 24 layers, its
# requests within the native 448 positions.
ARCH_PHASES_13 = (
    ("grok_1_314b", 4, ("fused",), ((8, 40, 8),), "compile", (64, 256)),
    ("kimi_k2_1t_a32b", 1, ("fused",), ((8, 40, 8),), "compile", (64,)),
    ("whisper_medium", 0, ("fused",), ((8, 64, 16), (2, 400, 8)), "model",
     None),
    ("qwen2_vl_72b", 12, ("fused",), ((8, 256, 8),), "model", None),
)


def model_inputs(torch, cfg, n: int, s0: int, new: int, seed: int):
    """A request's seeded inputs on the card: (prefill batch dict, the
    decode steps' (n, new, d) embeds or None).  Token prompts (plus a
    label column) for a token arch, with (n, encoder_ctx, d) frame
    embeddings for an encoder-decoder; (n, s0, d) embeds for an
    embedding-input arch."""
    from repro_torch.lm.radix import torch_dtype

    gen = torch.Generator(device=DEV).manual_seed(seed)
    dt = torch_dtype(cfg.dtype)
    if cfg.embedding_inputs:
        emb = torch.randn((n, s0 + new, cfg.d_model), generator=gen,
                          device=DEV).to(dt)
        return {"embeds": emb[:, :s0]}, emb[:, s0:]
    tokens = torch.randint(0, cfg.vocab, (n, s0 + 1), generator=gen,
                           device=DEV)
    batch = {"tokens": tokens}
    if cfg.encoder_layers:
        batch["enc_embeds"] = torch.randn(
            (n, cfg.encoder_ctx, cfg.d_model), generator=gen,
            device=DEV).to(dt)
    return batch, None


def run_model(model, params, cfg, batch, s0: int, new: int, feed) -> list:
    """``model.prefill`` of ``batch`` (cache sized s0 + new), then new - 1
    ``decode_step``s, step i fed ``feed(i, logits)``; every step's
    logits."""
    import torch

    with torch.inference_mode():
        lg, caches = model.prefill(params, batch, cfg, max_len=s0 + new)
        out = [lg]
        for i in range(new - 1):
            lg, caches = model.decode_step(params, caches, feed(i, lg),
                                           s0 + i, cfg)
            out.append(lg)
    return out


def phase_arch_model(torch, name, cfg, requests, results) -> None:
    """An encoder-decoder or embedding-input arch served through
    ``lm.model.prefill`` / ``decode_step`` with a batch dict (seeded frame
    or patch embeddings drawn on the card), radix weights K-major, fused:
    every step's logits ``torch.equal`` to the plain path (Whisper fed the
    kernel path's greedy tokens, Qwen2-VL seeded (n, 1, d) embeds), and the
    launches of ``lm_launches``, the encoder's FFNs once per prefill."""
    from repro_torch.lm import model

    t_phase = time.perf_counter()
    if DEV == "cuda":
        torch.cuda.reset_peak_memory_stats()
    cfg = dataclasses.replace(cfg, quant="radix", use_kernel=True,
                              kernel_dataflow="fused")
    plain_cfg = dataclasses.replace(cfg, use_kernel=False)
    params, n_params = arch_params(torch, model, cfg)
    params = model.kmajor_params(model.radixify_params(params, cfg))
    mm, attn, enc = lm_launches(cfg)
    out = dict(params=n_params, layers=cfg.n_layers,
               encoder_layers=cfg.encoder_layers,
               launches_per_step=dict(radix_matmul=mm,
                                      radix_decode_attn=attn,
                                      encoder_radix_matmul=enc),
               dataflows={"fused": {"requests": []}})
    row = out["dataflows"]["fused"]
    for i, (n, s0, new) in enumerate(requests):
        batch, embeds = model_inputs(torch, cfg, n, s0, new, SEED + 90 + i)
        fed = []

        def feed(j, lg):
            x = (embeds[:, j:j + 1] if embeds is not None
                 else lg.to(torch.float32).argmax(-1)[:, None])
            fed.append(x)
            return x

        before = counters()
        t0 = time.perf_counter()
        logits = run_model(model, params, cfg, batch, s0, new, feed)
        sync(torch)
        req_s = time.perf_counter() - t0
        after = counters()
        launches = {k: after[k] - before[k] for k in after}
        want = {"radix_matmul": mm * new + enc,
                "radix_decode_attn": attn * (new - 1),
                "radix_conv2d": 0, "spike_encode": 0}
        check(DEV != "cuda" or launches == want,
              f"{name} request {i}: launches {launches} != {want}")
        check(len(logits) == new and all(
            tuple(x.shape) == (n, cfg.vocab) and bool(torch.isfinite(x).all())
            for x in logits), f"{name}: output shape / finiteness")
        plain = run_model(model, params, plain_cfg, batch, s0, new,
                          lambda j, lg: fed[j])
        c = compare_logits(torch, logits, plain)
        check(c["equal"], f"{name} request {i}: logits differ from the "
              f"plain path {c}")
        req = dict(request=(n, s0, new), comparison=c, request_s=req_s,
                   launches=launches)
        with torch.inference_mode():
            def prefill():
                return model.prefill(params, batch, cfg, max_len=s0 + new)

            req["prefill_ms"] = host_ms(torch, prefill, reps=3, warmup=1)
            caches = prefill()[1]
            x = fed[0]

            def decode():
                return model.decode_step(params, caches, x, s0, cfg)

            req["decode_ms"] = host_ms(torch, decode, reps=10)
            if i == 0:
                row["profile"] = profile_steps(
                    torch, prefill, lambda: [decode() for _ in range(3)])
        row["requests"].append(req)
        log(f"[arch] {name} fused: {n} x {s0} "
            + ("embeds" if embeds is not None else "tokens")
            + (f" over {cfg.encoder_ctx} encoder frames"
               if cfg.encoder_layers else "")
            + f" + {new} new through model.prefill / decode_step: logits "
            f"equal the plain path at every step, launches {launches}; "
            f"request {req_s:.3f} s; prefill {req['prefill_ms']:.2f} ms "
            f"({n * s0 / req['prefill_ms'] * 1e3:.0f} prompt positions/s); "
            f"decode {req['decode_ms']:.3f} ms a step "
            f"({n / req['decode_ms'] * 1e3:.1f} tokens/s at batch {n})")
    log_arch_profile(name, "fused", row["profile"], attn, row)
    finish_arch(torch, name, out, params, t_phase, results)


def finish_arch(torch, name, out, params, t_phase, results) -> None:
    """Log the phase's seconds and peak device memory, then free its
    weights before the next phase."""
    del params
    sync(torch)
    out["peak_gb"] = (torch.cuda.max_memory_allocated() / 1e9
                      if DEV == "cuda" else 0.0)
    out["phase_s"] = time.perf_counter() - t_phase
    results.setdefault("archs", {})[name] = out
    if DEV == "cuda":
        torch.cuda.empty_cache()
    log(f"[arch] {name}: {out['layers']} layers, {out['params'] / 1e9:.3f} B "
        f"parameters; phase {out['phase_s']:.1f} s, peak "
        f"{out['peak_gb']:.2f} GB allocated")


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
    tune_run = {k: runs["vgg11"][k] for k in ("qnet", "x", "want")}
    del runs
    torch.cuda.empty_cache()

    # phase 2's attention part, beside the path that runs the kernel: its
    # many profiler traces and plain runs at S = 8192 are kept out of the
    # process state in which the CNN walls are timed
    t0 = time.perf_counter()
    phase_attn(torch, results)
    log(f"[kernel] phase 2, attention: {time.perf_counter() - t0:.1f} s")
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

    t0 = time.perf_counter()
    reset_counters()
    qnets = phase_encodings(torch, np, results)
    paths["cnn_encodings"] = counters()
    copies["cnn_encodings"] = transposes()
    log(f"[enc] phase 9: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    reset_counters()
    qnet, hw = qnets["vgg11/avg/phase8p2"]
    phase_serving(torch, np, qnet, hw, results)
    paths["cnn_serving"] = counters()
    copies["cnn_serving"] = transposes()
    log(f"[serve] phase 10: {time.perf_counter() - t0:.1f} s")
    del qnets, qnet
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    reset_counters()
    phase_autotune(torch, tune_run, vgg_hw, results)
    paths["cnn_autotune"] = counters()
    copies["cnn_autotune"] = transposes()
    # these launches compare kernels with each other: counted on no path
    candidate_check(torch, nets["vgg11"] + lm_matmul_tune_calls(), results)
    reset_counters()
    phase_autotune_lm(torch, gemma_2b.ARCH, results)
    paths["lm_autotune"] = counters()
    copies["lm_autotune"] = transposes()
    results["autotune_s"] = time.perf_counter() - t0
    log(f"[autotune] phase 11: {results['autotune_s']:.1f} s (script wall "
        f"so far {time.perf_counter() - t_start:.1f} s)")
    del tune_run
    shutil.rmtree(Path(results["autotune"]["table"]).parent,
                  ignore_errors=True)

    arch_paths = {}
    for phase, table in ((12, ARCH_PHASES), (13, ARCH_PHASES_13)):
        t0 = time.perf_counter()
        for name, layers, dataflows, requests, served, buckets in table:
            cfg = arch_cfg(name, layers)
            reset_counters()
            if served == "compile":
                phase_arch_compiled(torch, name, cfg, dataflows, requests,
                                    results, buckets)
            elif served == "generate":
                phase_arch_generate(torch, name, cfg, requests, results)
            else:
                phase_arch_model(torch, name, cfg, requests, results)
            paths[name] = counters()
            copies[name] = transposes()
            arch_paths[name] = path_kernels(cfg)
        log(f"[arch] phase {phase}: {time.perf_counter() - t0:.1f} s "
            f"(script wall so far {time.perf_counter() - t_start:.1f} s)")

    results["path_launches"] = paths
    cnn_kernels = ("radix_conv2d", "radix_matmul")
    for path, names in (("cnn", cnn_kernels),
                        ("lm", ("radix_matmul", "radix_decode_attn")),
                        ("encode", ("spike_encode",)),
                        ("cnn_encodings", cnn_kernels),
                        ("cnn_serving", cnn_kernels),
                        ("cnn_autotune", cnn_kernels),
                        ("lm_autotune", ("radix_matmul",
                                         "radix_decode_attn")),
                        *arch_paths.items()):
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
            launches=sum(p[kname] for p in paths.values()),
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
        "(launches: every path, phases 3-4, 7, 8, 9, 10, 11, 12 and 13); "
        "decode attention at the LM "
        "decode shape (packed, fused); encoder at 8x224x224x3, T=4")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
