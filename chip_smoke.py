#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

It builds the CUDA kernels from ``src/repro_torch/csrc`` and runs:

1. the build of both kernels (one ``nvcc`` each, in parallel);
2. each kernel against its plain PyTorch version on the card, at every
   distinct conv/linear shape of VGG-11 (224 x 224, batch 8) and LeNet-5
   (full width), both dataflows, epilogue on and off, with an empty plane
   in the occupancy row, plus ``periods=2`` and ``out_grid="pow2"`` at one
   shape each and int32 (10-bit) levels at one small shape each — all
   ``torch.equal`` — with timings by CUDA events;
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
   bucket) plan: device time by kernel name and the device's busy share.

Every failure raises, so the script exits non-zero.  It prints the card's
name and power limit (``nvidia-smi``), a ``{"kernels": [...]}`` JSON line,
and last ``{"ok": true, "device": {...}}``; the full results go to
``build/chip_smoke.json``.  It exits 1 without a CUDA device or without
the repository's ``src/repro_torch`` beside it.
"""

from __future__ import annotations

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
KERNEL_INFO = {
    "radix_conv2d": ("src/repro_torch/csrc/radix_conv.cu",
                     "src/repro/kernels/radix_conv.py:333"),
    "radix_matmul": ("src/repro_torch/csrc/radix_matmul.cu",
                     "src/repro/kernels/radix_matmul.py:382"),
}


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


def phase_kernels(torch, nets: dict, results: dict) -> None:
    from repro_torch.kernels import ops
    from repro_torch.kernels.radix_conv import (radix_conv2d_cuda,
                                                radix_conv2d_plain)
    from repro_torch.kernels.radix_matmul import (radix_matmul_cuda,
                                                  radix_matmul_plain)

    fns = {"radix_conv2d": (radix_conv2d_cuda, radix_conv2d_plain),
           "radix_matmul": (radix_matmul_cuda, radix_matmul_plain)}
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
            kernel_fn, plain_fn = fns[call["kernel"]]
            bits = call["bits"]
            # the top plane stays empty: the occupancy row gates a plane
            x = torch.randint(0, 1 << (bits - 1), call["x"], generator=gen,
                              device=dev).to(
                torch.uint8 if bits <= 8 else torch.int32)
            wq = torch.randint(-3, 4, call["w"], generator=gen,
                               device=dev).to(torch.int8)
            n = call["w"][-1]
            bias = torch.randint(-64, 64, (1, n), generator=gen, device=dev,
                                 dtype=torch.int32)
            mult = torch.rand((1, n), generator=gen, device=dev) * 0.02
            occ = ops.plane_occupancy(x, bits)[0]
            check(int(occ[0, bits - 1]) == 0 and int(occ[0, :bits].sum())
                  == bits - 1, f"{key}: occupancy row {occ[0, :bits]}")
            base = dict(num_steps=bits, occupancy=occ, out_steps=T)
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
            for m in ("fused", "bitserial"):
                row[f"{m}_ms"] = cuda_ms(
                    torch, lambda: kernel_fn(x, wq, **base, method=m, **epi),
                    reps=10)
                row[f"plain_{m}_ms"] = cuda_ms(
                    torch, lambda: plain_fn(x, wq, **base, method=m, **epi),
                    reps=3, warmup=1)
            row["library_ms"] = None
            if call["kernel"] == "radix_matmul":
                row["library_ms"] = int_mm_ms(torch, x, wq, kernel_fn, base)
            seen[key] = row
            rows.append(row)
            log(f"[kernel] {net_name:6s} {call['kernel']:12s} x={call['x']} "
                f"w={call['w']} s={call['stride']} bits={bits} "
                f"epi={call['epi']}: fused {row['fused_ms']:.4f} ms, "
                f"bitserial {row['bitserial_ms']:.4f} ms, plain "
                f"{row['plain_fused_ms']:.4f}/{row['plain_bitserial_ms']:.4f}"
                f" ms, bound {row['bound_ms']:.4f} ms ({row['bound_by']}), "
                f"library {row['library_ms']}")
    check({"radix_conv2d", "radix_matmul"} <= extra_done,
          "periods=2 / pow2 not covered for both kernels")
    # int32 levels: the avg-pool carry outgrows a byte at T >= 7 (10 bits
    # at T = 8), off this main path but shipped in both kernels
    wide = {"radix_conv2d": ((8, 14, 14, 6), (5, 5, 6, 16)),
            "radix_matmul": ((8, 400), (400, 120))}
    for kname, (xs, ws) in wide.items():
        kernel_fn, plain_fn = fns[kname]
        x = torch.randint(0, 1 << 10, xs, generator=gen, device=dev,
                          dtype=torch.int32)
        wq = torch.randint(-3, 4, ws, generator=gen, device=dev).to(
            torch.int8)
        n = ws[-1]
        bias = torch.randint(-64, 64, (1, n), generator=gen, device=dev,
                             dtype=torch.int32)
        mult = torch.rand((1, n), generator=gen, device=dev) * 0.002
        base = dict(num_steps=10, occupancy=ops.plane_occupancy(x, 10)[0],
                    out_steps=8)
        for v in [dict(method=m, periods=p, **e)
                  for m in ("fused", "bitserial") for p in (1, 2)
                  for e in ({}, dict(bias=bias, mult=mult))]:
            got, want = kernel_fn(x, wq, **base, **v), plain_fn(x, wq, **base,
                                                                **v)
            torch.cuda.synchronize()
            check(torch.equal(got, want), f"{kname} int32 levels {v}")
    log("[kernel] int32 (10-bit) levels: both kernels equal their plain "
        "versions")
    results["kernel_rows"] = rows
    results["max_abs_err"] = err
    results["seen"] = seen


def int_mm_ms(torch, x, wq, kernel_fn, base):
    """torch._int_mm's time on the same product, where it takes the shape
    (levels fit int8 exactly); None where it refuses it."""
    a = x.to(torch.int8)
    try:
        ref = torch._int_mm(a, wq)
    except RuntimeError as exc:
        log(f"[kernel] torch._int_mm refuses {tuple(x.shape)} x "
            f"{tuple(wq.shape)}: {str(exc).splitlines()[0]}")
        return None
    got = kernel_fn(x, wq, **dict(base, occupancy=None), method="fused")
    check(torch.equal(ref, got), "torch._int_mm disagrees with the kernel")
    return cuda_ms(torch, lambda: torch._int_mm(a, wq), reps=10)


# ---------------------------------------------------------------------------
# Phases 3 and 4: the main path.
# ---------------------------------------------------------------------------


def counters():
    from repro_torch.kernels.radix_conv import radix_conv2d_cuda
    from repro_torch.kernels.radix_matmul import radix_matmul_cuda

    return {"radix_conv2d": radix_conv2d_cuda.launches,
            "radix_matmul": radix_matmul_cuda.launches}


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

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0))

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
                           and dev_us(e) > 0]
                busy_us = sum(dev_us(e) for e in kernels)
                radix_us = sum(dev_us(e) for e in kernels
                               if "radix_" in e.key)
                key = f"{name}/{dataflow}/b{b}"
                if busy_us == 0:
                    log(f"[profile] {key}: no device time recorded "
                        "(not measured)")
                    out[key] = None
                    continue
                top = sorted(kernels, key=dev_us, reverse=True)[:5]
                wall_ms = results[name]["dataflows"][dataflow]["buckets"][b][
                    "ms"]
                out[key] = dict(
                    profiled_wall_ms_per_call=wall_us / 3e3,
                    device_ms_per_call=busy_us / 3e3,
                    radix_kernels_ms_per_call=radix_us / 3e3,
                    other_kernels_ms_per_call=(busy_us - radix_us) / 3e3,
                    busy_share=busy_us / 3e3 / wall_ms,
                    top=[(e.key[:70], dev_us(e) / 3e3, e.count // 3)
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

    x = torch.rand((BATCH, 224, 224, 3),
                   generator=torch.Generator().manual_seed(SEED + 3))
    x = x * 1.4 - 0.2
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
    log(f"[kernel] phase 2: {time.perf_counter() - t0:.1f} s")

    # the main path: counts from here to the end of phase 4
    from repro_torch.kernels.radix_conv import radix_conv2d_cuda
    from repro_torch.kernels.radix_matmul import radix_matmul_cuda

    radix_conv2d_cuda.launches = 0
    radix_matmul_cuda.launches = 0
    runs = {
        "lenet5": phase_net(torch, "lenet5", lenet_static, lenet_params,
                            lenet_hw, results),
        "vgg11": phase_net(torch, "vgg11", vgg_static, vgg_params, vgg_hw,
                           results),
    }
    main_launches = counters()
    check(all(v > 0 for v in main_launches.values()),
          f"a kernel was not launched on the main path: {main_launches}")

    phase_quantize(torch, results)
    phase_profile(torch, runs, results)

    seen = results.pop("seen")
    vgg_calls = nets["vgg11"]
    kernels = []
    for kname, (source, replaces) in sorted(KERNEL_INFO.items()):
        mine = [seen[_shape_key(c)] for c in vgg_calls if c["kernel"] == kname]
        libs = [r["library_ms"] for r in mine]
        bound_ms = sum(r["bound_ms"] for r in mine)
        bytes_ms = sum(r["bound_ms"] for r in mine if r["bound_by"] == "bytes")
        kernels.append(dict(
            name=kname, route="cuda", source=source, replaces=replaces,
            launches=main_launches[kname],
            max_abs_err=results["max_abs_err"][kname],
            ms=sum(r["fused_ms"] for r in mine),
            plain_ms=sum(r["plain_fused_ms"] for r in mine),
            bound_ms=bound_ms,
            bound_by="bytes" if bytes_ms * 2 >= bound_ms else "operations",
            library_ms=(None if any(v is None for v in libs)
                        else sum(libs))))
    results["kernels"] = kernels
    results["total_s"] = time.perf_counter() - t_start
    out_dir = ROOT / "build"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(results, indent=1,
                                                        default=str))
    log(f"[done] {results['total_s']:.1f} s; kernel line: times summed over "
        "one VGG-11 batch-8 fused execution's launches")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
