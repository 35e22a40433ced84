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
   - the LM's fused radix products (``lm_fused_check``): the dequantize
     epilogue (bf16 and f32, both dataflows) at GLM4-9B's gate/up and
     down shapes (M = 300), its unembed and its decode down product (M =
     8, split over K) equal to ``radix_matmul.dequantize`` of the int32
     sums; the one-pass quantize and its SwiGLU / GeGLU variants at
     GLM4-9B's widths equal to their plain versions; each timed at M =
     16,384 beside the int32 path's glue; a bf16 GLM4-9B SMOKE prefill
     launching one ``radix_matmul_kernel`` a radix product, all fused,
     its logits ``torch.equal`` to the int32 path's;
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
   batch there; Fang: every request size; the CPU plans run in a
   subprocess of 4 threads started after the phase's timed walls,
   beside phases 10-11, and are checked before phase 12).  Images/s per bucket
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
   ``packed_attn`` on, its weights freed before the next: GLM4-9B (10 of
   its 40 layers, g = 16) through ``Accelerator.compile`` at (8, 512)
   with buckets (64, 256) for both dataflows, requests of 8 x 40 and
   3 x 200 tokens with 8 new; Gemma-7B (14 of 28 layers) and
   DeepSeek-Coder-33B (8 of its 62 layers) alike, fused, the first
   request only (the depths cut since phase 19 joined the script's time
   limit; DeepSeek's bf16 tree alone is ~66.8 GB at 62 layers); RecurrentGemma-2B (26 layers, window 2048) through
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

14. LM serving: Gemma-2B at full width and depth (bf16, T = 4, packed KV
   and packed attention) behind ``launch.serve_lm``'s ``LMServer`` and
   ``make_queue`` at batch 8, ``max_len`` 512, buckets (64, 256), prompts
   of 200 tokens and 16 new: four servers over one weight tree (kernels
   fused; fused with ``autotune=True``; bitserial with ``radix_attn``;
   ``backend="jnp"``) take the same 8 seeded requests of 1-8 prompts.
   Every ticket resolves; the launches equal ``lm_launches`` (plus the
   QKV/out projections under ``radix_attn``) per ``generate`` (a flush
   of more prompts than the batch runs one per chunk of it), none on
   ``jnp``; no plan is built and the health stays healthy; the fused server's tickets equal
   ``exe.generate``, every server's tickets equal the fused server's
   (the autotuned one's where its KV split is the default), and each
   kernels server's logits equal its plain path on one request.  Then a drill of
   8 requests, one holding the token id ``vocab``: it alone is
   quarantined and the counters reconcile; then ``serve_lm.main`` once.
   Tokens/s, p50/p95, flushes, one flush's busy share by profiler and peak
   memory per server;
15. the PPA planner: ``api.autoconfigure`` over VGG-11 (224 x 224 x 3,
   100 classes, avg pool, 32 calibration images) on the card and on the
   CPU, ``t_range=(3, 4)``, ``units=(1, 2, 4, 8)``, floor 0.5 (the CPU's
   search, which needs no card, runs in a subprocess of 4 threads
   started before phase 12, beside phases 12-14; its plan view, pick and
   pick's ``stats()["ppa"]`` come back pickled): the
   two plans equal (candidates, accuracies, modeled PPA, rejections,
   frontier, winner, summary); the winner (or, with none feasible, the
   most accurate priced candidate) compiled on the card by
   ``AutoPlan.compile`` for buckets (1, 8), its logits ``torch.equal`` to
   both oracles, its launches counted, its ``stats()["ppa"]`` the CPU's;
   ``Accelerator.compile(auto=)`` on the card gives the same executable
   (or, with none feasible, the same refusal); then ``serve_cnn.main
   --auto`` over 16 requests.  The modeled PPA is the paper's FPGA build, not the GPU.

16. training on the card, then trained weights on the kernels' path:
   LeNet-5 (full width) trained by ``train.trainer.train_ann`` on
   ``SyntheticVision`` with the reference's table-1 recipe (300 steps,
   batch 128, lr 1e-2): ANN accuracy over 8 x 256 held-out images at
   least 0.8; ``convert`` (radix T = 4) of the trained weights on the
   card equal to the CPU's (``w_q``, ``b_int``, ``mult``); compiled fused
   and bitserial with buckets (1, 8): 8 held-out images' logits
   ``torch.equal`` to both oracles, SNN accuracy over the same 2048
   images, launches = layers x executions; a second ``train_ann`` run of
   the same seed gives ``torch.equal`` weights, the same conversion and
   the same SNN accuracy (training runs with deterministic kernels,
   ``train.determinism``).  VGG-11 (224 x 224 x 3, 100
   classes, avg pool) trained with the trainer's step at batch 32 for a
   wall budget on prefetched batches: the loss finite and falling (mean
   of the last 10 steps below the first 10), images/s, a profile of 5
   steps, the step's ms with and without deterministic kernels, ANN
   accuracy, radix T = 4 fused logits ``torch.equal`` to the
   oracle and SNN accuracy, whether TTFS and rate logits at T = 4 vary
   across images (recorded).  A restart drill: LeNet-5's step under
   ``runtime.RestartableRun``, 17 steps, a checkpoint every 4, a fault at
   step 9, resumed: ``torch.equal`` to the uninterrupted run (cuDNN
   deterministic for the drill).  Gemma-2B at full width and depth in
   bf16: ``launch.train.train_loop`` (adafactor, lr 3e-3, batch 8 x 512
   ``synthetic_tokens``) for 10 steps with a checkpoint every 5, the
   checkpoint restored equal to the state bit for bit, a second call
   resumed to 12; ``lm.model.make_train_step`` with adam on one repeated
   batch for 8 steps (the loss falls; step ms, tokens/s, peak memory, a
   profiled step, the step's ms with and without deterministic kernels);
   the trained weights through ``Accelerator.compile``
   fused at (8, 512), bucket 64, 8 x 40 tokens and 8 new: logits
   ``torch.equal`` to the plain path, the launches of ``lm_launches``.
17. the device mesh on a one-rank NCCL world (``init_process_group`` with
   a file store, destroyed at the end), the (1, 1) ('data', 'model')
   mesh: (a) VGG-11 radix T = 4 fused, buckets (1, 8), compiled with
   ``parallel`` None (phase 4's plan), 1 and 2: one shard a bucket on one
   card, every request ``torch.equal`` to both oracles and the plane
   counters equal; ``_compile_plan_impl(..., data_parallel=2)`` raises
   the reference's error; a ``CNNServer(data_parallel=2)`` stream of 16
   requests equal to the oracle; ``serve_cnn.main(... --data-parallel
   2)``; with more cards, k = all of them, images/s.  (b) Kimi-K2 (1 of
   61 layers; ``ep_psum``, ``ep_a2a``) and Grok-1 (4 of 64; ``tp``,
   ``ep_psum``) at full width, radix T = 4 fused, 8 x 40 tokens and 3
   decode steps through ``model.prefill`` / ``decode_step(..., mesh)``
   against ``ref`` on one device: at capacity factor E / top_k nothing
   drops, one layer within ``MESH_LAYER_BAR``, each prompt whose routes
   all match ``ref``'s within ``MESH_LOGITS_BAR`` (routes flipped by
   bf16 near-ties are counted), the two dispatches' logits equal bit for
   bit; at the config's 1.25 the dropped entries, the errors, and the
   capacity buffers' expert products' device ms and share of a decode
   step beside ``ref``'s.  (c) Gemma-2B whole, bf16, 8 x 512:
   ``launch.train.train_loop`` over the mesh, 3 adafactor steps, losses
   and weights ``torch.equal`` to the unsharded loop;
   ``runtime.elastic.reshard_checkpoint`` restores it bit for bit;
   prefill and decode over the mesh ``torch.equal`` to the unsharded
   calls.  The phase prints its wall.
18. GPipe stages, the op analysis, the roofline and the dry run: (a) on a
   one-rank NCCL world (destroyed at the end) and its ('pod',) mesh of
   one stage, ``parallel.pipeline.gpipe`` over Gemma-2B's 18 layers at
   full width (seeded weights), radix T = 4 fused, each layer
   ``lm.model._apply_layer`` without a cache over ``radixify_params`` /
   ``kmajor_params`` leaves, 4 microbatches of 2 x 512 tokens: the output
   ``torch.equal`` to the layers applied one microbatch at a time,
   ``radix_matmul`` launches = 18 x 4 x 3, host and device ms beside the
   sequential run's; then the bf16 exact layers under
   ``train.determinism.deterministic()``, 2 microbatches of 1 x 512: the
   output and the gradients of sum(out^2) ``torch.equal`` to the
   sequential run's.  (b) ``launch.op_analysis.analyze`` over one VGG-11
   fused batch-8 plan call (phase 4's plan) and one Gemma-2B fused decode
   step (phase 7's configuration): its ``radix_conv2d`` /
   ``radix_matmul`` / ``radix_decode_attn`` notes equal the launch
   counters; each ``launch.roofline`` row (H100 constants, the int8
   peak) beside the profiled device ms of the same call.  (c) ``python
   -m repro_torch.launch.dryrun --arch gemma_2b --cell train_4k --cell
   decode_32k`` in a subprocess on the CPU (16 x 16 placeholder world;
   started with phase 15's, beside phases 12-14): "2/2 cells OK" and its
   rows.  The phase prints its wall and what it waited for the dry run.
19. Tensor parallelism over 'model': the decode kernel's partials mode
   ``torch.equal`` to its plain version, and 4 ranks' partials over
   quarters of the slots merged (``radix_attn.merge_partials``)
   ``torch.equal`` to the one-card kernel, at Gemma-2B's and GLM4-9B's
   decode shapes, both dataflows (counted on no path); then (a) each arch
   of ``TP_ARCHS`` at full width (Gemma-2B all 18 layers; Gemma-7B 8 of
   28, each rank building the whole seeded tree before keeping its
   shards; RecurrentGemma-2B all 26 layers, whose 10 query heads do not
   divide 4, so its heads split head_dim and each rank attends for its
   own 50 of the 200 prompt rows: q exchanged over head_dim by an
   all-to-all, K and V gathered whole), radix T = 4 with ``radix_attn``,
   fused, packed KV, batch 8,
   ``max_len`` 512, over 4 ranks spawned on one gloo world sharing the
   card, one world for every arch ((1, 4) ('data', 'model'); gloo moves
   the collectives through the host): ``model.shard`` then ``prefill`` and 4 ``decode_step``s,
   every step's logits ``torch.equal`` to the one-card run (else within
   1e-2 relative L2; the line says which held), the launches, no
   per-call weight transpose, no attention plan built in steady state,
   each rank's prefill attention on the path its heads take
   (``blocks.ATTN_ROWS``: its query rows a layer, S/4 where the heads
   split head_dim, else S) and its peak GB.  RecurrentGemma-2B's RG-LRU
   products are bf16 and split over 'model', so its ranks sum them in
   another order, which T = 4 amplifies over 26 layers: its logits are
   finite, ``torch.equal`` (else within 1e-2 relative L2) to the same
   ranks' run on the whole attention path (every rank every query row),
   and their distance and greedy agreement with the one-card run are
   printed; its first attention layer alone, at full width on each rank's
   pieces with the sequence split, is held ``torch.equal`` to the
   one-card layer (else within 1e-2 relative L2);
   (b) Gemma-2B on a one-rank
   NCCL world, (1, 1): ``torch.equal`` to the one-card run.  The phase
   prints its wall and each rank's host times.
20. ZeRO-3 over the data axes in the sharded train step: Gemma-2B at full
   width and depth (18 layers), bf16, ``launch.train.train_loop(cfg,
   mesh)`` with phase 17's ``MESH_TRAIN`` (adafactor, batch 8 x 512, lr
   3e-3) for 2 of its 3 steps (``FSDP_TRAIN``: the script's time limit)
   over 4 gloo ranks spawned on one world sharing the card, the (2, 2)
   ('data', 'model') mesh: each layer's pieces gathered over 'data'
   where it runs, the gradients reduce-scattered back, the optimizer on
   the pieces, the loss on each rank's vocab columns.  Every rank's
   losses the same and within 5e-4 relative of phase 17's unsharded
   run's first 2 (phase 17 also saves that run's weights after them;
   run alone, this phase trains the unsharded run itself); the trained
   weights, gathered to rank 0, within ``FSDP_WEIGHT_BAR`` relative L2
   of the unsharded run's over the whole tree and ``FSDP_LEAF_BAR`` in
   each leaf (a norm's is where a fault in the gradient of a leaf
   whole over 'data' shows); each rank
   prints its peak GB, host ms a step, its largest gather over the data
   axes (one layer's leaf, and a top-level leaf) and the bytes it holds
   in parameters, gradients and optimizer state.  This path runs none of
   the four kernels (float weights).  The phase prints its wall.

Profiles read each trace's device events from its raw kineto events
(``trace_kernels``), not ``key_averages``, whose host-event tree took
most of the script's profiling time.

Launch counters are set to 0 just before each path (phases 3-4, 7, 8, 9,
10, 11, each arch of 12 and 13, 14, 15, 16, 17, 18 and 19: in each
spawned rank of 19) and read just after; so are the GEMM
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

import contextlib
import dataclasses
import json
import math
import os
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
# H100 SXM's HBM bandwidth and dense int8 tensor-core peak: the
# roofline's constants (``repro_torch.launch.roofline.HW``), set by
# load_hw() once the package is importable
HBM_BYTES_PER_S = INT8_OPS_PER_S = None
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


class CpuJob:
    """A CPU-only piece of a later phase run in a subprocess that sees no
    CUDA device, with ``threads`` intra-op threads, started early so that
    it runs beside the card's phases.  ``args`` follow ``python``; a
    ``{out}`` in them names the file the job writes its result to.
    :meth:`finish` waits for the job (killing it past its timeout);
    :meth:`stop_all` kills every job still running."""

    THREADS = 4                 # of the card machine's 8 cores
    running: list = []

    def __init__(self, name: str, args: list, threads: int = THREADS):
        import tempfile
        import threading

        (ROOT / "build").mkdir(exist_ok=True)
        self.name = name
        self.dir = Path(tempfile.mkdtemp(prefix=f"job_{name}_",
                                         dir=ROOT / "build"))
        self.out = self.dir / "result.pkl"
        env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
                   PYTHONPATH=os.pathsep.join([str(ROOT), str(ROOT / "src")]),
                   OMP_NUM_THREADS=str(threads),
                   MKL_NUM_THREADS=str(threads))
        self._logs = [open(self.dir / "stdout", "w"),
                      open(self.dir / "stderr", "w")]
        self.t0, self.t_end, self.wait_s = time.perf_counter(), None, None
        self.proc = subprocess.Popen(
            [sys.executable] + [a.format(out=str(self.out)) for a in args],
            stdout=self._logs[0], stderr=self._logs[1], env=env, cwd=ROOT)
        CpuJob.running.append(self)
        threading.Thread(target=self._watch, daemon=True).start()

    def _watch(self) -> None:
        self.proc.wait()
        self.t_end = time.perf_counter()

    @property
    def wall_s(self) -> float:
        return (self.t_end or time.perf_counter()) - self.t0

    def finish(self, timeout: float) -> tuple:
        """(exit code, stdout, stderr) once the job ends."""
        t0 = time.perf_counter()
        try:
            rc = self.proc.wait(timeout)
        except subprocess.TimeoutExpired:
            self.stop()
            raise SmokeFailure(f"CPU job {self.name} ran past {timeout} s")
        self.wait_s = time.perf_counter() - t0
        while self.t_end is None:
            time.sleep(0.01)
        for f in self._logs:
            f.close()
        text = [(self.dir / n).read_text() for n in ("stdout", "stderr")]
        self.value = None
        if rc == 0 and self.out.exists():
            import pickle

            with open(self.out, "rb") as f:
                self.value = pickle.load(f)
        shutil.rmtree(self.dir, ignore_errors=True)
        if self in CpuJob.running:
            CpuJob.running.remove(self)
        return rc, text[0], text[1]

    def result(self, timeout: float):
        """The job's pickled result; its failure fails the phase."""
        rc, _, err = self.finish(timeout)
        check(rc == 0 and self.value is not None,
              f"CPU job {self.name} exit {rc}: {err[-2000:]}")
        return self.value

    def stop(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait(10)
        for f in self._logs:
            f.close()
        shutil.rmtree(self.dir, ignore_errors=True)
        if self in CpuJob.running:
            CpuJob.running.remove(self)

    @classmethod
    def stop_all(cls) -> None:
        for job in list(cls.running):
            job.stop()


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


class _Kernel:
    """A device kernel's totals over a trace: its name, device us and
    count."""
    __slots__ = ("key", "us", "count")

    def __init__(self, key: str, us: float, count: int = 1):
        self.key, self.us, self.count = key, us, count


def trace_kernels(prof, each: bool = False) -> list:
    """The device events (kernels, copies, fills; GPU user annotations,
    which span kernels, left out) of a finished ``torch.profiler`` trace,
    totalled by name as ``key_averages`` gives them, or with ``each`` one
    row an event: read from the raw kineto events, since ``key_averages``
    and ``events()`` first build every host event's tree (most of the
    host time the script's traces took)."""
    rows = [(e.name(), e.duration_ns() / 1e3)
            for e in prof.profiler.kineto_results.events()
            if str(e.device_type()).endswith("CUDA")
            and not e.is_user_annotation() and e.duration_ns() > 0]
    if each:
        return [_Kernel(k, us) for k, us in rows]
    totals = {}
    for k, us in rows:
        row = totals.setdefault(k, _Kernel(k, 0.0, 0))
        row.us += us
        row.count += 1
    return list(totals.values())


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
        us = sum(e.us for e in trace_kernels(prof)
                 if kernel is None or kernel in e.key)
        if us:
            return us / reps / 1e3
    return None


def load_hw() -> None:
    """Set the bandwidth and int8 peak from the package's roofline
    constants (``src`` must be on the path)."""
    global HBM_BYTES_PER_S, INT8_OPS_PER_S
    from repro_torch.launch.roofline import HW

    HBM_BYTES_PER_S, INT8_OPS_PER_S = HW.hbm_bw, HW.peak_flops_int8


def bound(call: dict) -> tuple:
    """(ms, "bytes" | "operations"): the larger of every input read once
    plus the output written once over HBM bandwidth, and the products'
    operations over the int8 peak (``kernels.work.gemm``'s reckoning)."""
    from repro_torch.kernels import work

    w = work.gemm(call.get("kernel", "radix_matmul"), *call["mkn"],
                  x_bytes=call["x_bytes"], epilogue=call["epi"],
                  occupancy=True)
    t_bytes = w.nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = w.int8_ops / INT8_OPS_PER_S * 1e3
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
    lm_fused_check(torch, results)


# GLM4-9B's radix products (M, K, N) for the fused path's check: gate/up
# and down at a reduced M with ragged tile edges, the unembed (M = 8, the
# small tile), and the down product at decode's M = 8 (split over K); and
# the prefill benchmark's M = 16,384 for a check of the cell's own shape
# and the times
FUSED_PRODUCTS = [(300, 4096, 13696), (300, 13696, 4096), (8, 4096, 151552),
                  (8, 13696, 4096)]
FUSED_PREFILL_M = 8 * 2048


def lm_fused_check(torch, results) -> None:
    """The LM's fused radix products (``lm/radix.py``) on the card: the
    dequantize epilogue at ``FUSED_PRODUCTS`` (bf16 and f32, both
    dataflows) equal to :func:`radix_matmul.dequantize` of the int32
    sums; the one-pass quantize and its SwiGLU variant at GLM4-9B's
    widths equal to their plain versions; the gate product's epilogue
    and the three quantize kernels at the prefill's M (``FUSED_PREFILL_M``)
    equal to their plain versions, then timed against the int32 path's
    glue; then a prefill of a bf16 GLM4-9B
    SMOKE model: one ``radix_matmul_kernel`` a radix product (no other
    kernel named so), every product fused, logits ``torch.equal`` to the
    int32 path's."""
    import dataclasses

    from repro_torch import api
    from repro_torch.configs import glm4_9b
    from repro_torch.kernels import radix_matmul as rmm
    from repro_torch.lm import radix as radix_lib

    t0 = time.perf_counter()
    dev = torch.device(DEV)
    gen = torch.Generator(device=dev).manual_seed(SEED + 12)
    lvl = (1 << T) - 1

    def weight(k, n):
        return radix_lib.kmajor_weight(radix_lib.quantize_weight(
            torch.randn(k, n, generator=gen, device=dev) / k ** 0.5))

    for m, k, n in FUSED_PRODUCTS:
        x = torch.randn(m, k, generator=gen, device=dev).to(torch.bfloat16)
        w = weight(k, n)
        qx, sx = radix_lib._radix_activation(x, T)
        colsum = w["qt"].sum(dim=-1, dtype=torch.int32)
        for method in ("fused", "bitserial"):
            acc = rmm.radix_matmul_cuda(qx, w["qt"], num_steps=T,
                                        method=method, kmajor=True)
            for dt in (torch.bfloat16, torch.float32):
                d = rmm.Dequant(sx, w["scale"], colsum, 2.0 / lvl, dt)
                got = rmm.radix_matmul_cuda(qx, w["qt"], num_steps=T,
                                            method=method, kmajor=True,
                                            dequant=d)
                sync(torch)
                check(torch.equal(got, rmm.dequantize(acc, d)),
                      f"dequantize epilogue {(m, k, n)} {method} {dt}")
    for act, k in ((None, 4096), ("swiglu", 13696), ("geglu", 13696)):
        x, u = (torch.randn(333, k, generator=gen, device=dev)
                .to(torch.bfloat16) for _ in range(2))
        kw = {} if act is None else {"act": act, "up": u}
        got, want = (rmm.radix_quantize_cuda(x, T, **kw),
                     rmm.radix_quantize_plain(x, T, **kw))
        sync(torch)
        check(all(torch.equal(a, b) for a, b in zip(got, want)),
              f"one-pass quantize, act {act}, 333 x {k}")

    # at the prefill's M: the checks, then the times beside the int32 path
    rows = {}
    m = FUSED_PREFILL_M
    x = torch.randn(m, 4096, generator=gen, device=dev).to(torch.bfloat16)
    g, u = (torch.randn(m, 13696, generator=gen, device=dev)
            .to(torch.bfloat16) for _ in range(2))
    w = weight(4096, 13696)
    qx, sx = rmm.radix_quantize_cuda(x, T)
    colsum = w["qt"].sum(dim=-1, dtype=torch.int32)
    d = rmm.Dequant(sx, w["scale"], colsum, 2.0 / lvl, torch.bfloat16)

    def int32_glue():
        acc = rmm.radix_matmul_cuda(qx, w["qt"], num_steps=T,
                                    method="fused", kmajor=True)
        return rmm.dequantize(acc, d)

    # the kernels at the shape the cell runs, against their plain versions
    got = rmm.radix_matmul_cuda(qx, w["qt"], num_steps=T, method="fused",
                                kmajor=True, dequant=d)
    check(torch.equal(got, int32_glue()),
          f"dequantize epilogue at M = {m}, {tuple(w['qt'].shape)}")
    del got
    for v, kw in ((x, {}), (g, {"act": "swiglu", "up": u}),
                  (g, {"act": "geglu", "up": u})):
        got, want = (rmm.radix_quantize_cuda(v, T, **kw),
                     rmm.radix_quantize_plain(v, T, **kw))
        sync(torch)
        check(all(torch.equal(a, b) for a, b in zip(got, want)),
              f"one-pass quantize, act {kw.get('act')}, {m} x "
              f"{v.shape[-1]}")
    del got, want

    rows["gate_int32_glue_ms"] = cuda_ms(torch, int32_glue, reps=5)
    rows["gate_epilogue_ms"] = cuda_ms(
        torch, lambda: rmm.radix_matmul_cuda(qx, w["qt"], num_steps=T,
                                             method="fused", kmajor=True,
                                             dequant=d), reps=5)
    rows["quantize_x_torch_ms"] = cuda_ms(
        torch, lambda: radix_lib._radix_activation(x, T), reps=5)
    rows["quantize_x_ms"] = cuda_ms(
        torch, lambda: rmm.radix_quantize_cuda(x, T), reps=5)
    rows["swiglu_quantize_torch_ms"] = cuda_ms(
        torch, lambda: radix_lib._radix_activation(
            torch.nn.functional.silu(g) * u, T), reps=5)
    rows["swiglu_quantize_ms"] = cuda_ms(
        torch, lambda: rmm.radix_quantize_cuda(g, T, act="swiglu", up=u),
        reps=5)
    del x, g, u, w, qx, sx, colsum, d

    cfg = dataclasses.replace(glm4_9b.SMOKE, dtype="bfloat16")
    from repro_torch.lm import model as lm_model
    params = lm_model.init_params(
        torch.Generator(device=dev).manual_seed(SEED + 13), cfg)
    exe = api.Accelerator(dataflow="fused", device=DEV).compile(
        (params, cfg), (4, 64), buckets=(48,))
    prompts = lm_prompts(torch, cfg, 4, 37, SEED + 14)
    exe.prefill(prompts)
    before = dict(radix_lib.PRODUCTS)
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        got = exe.prefill(prompts)["logits"]
        sync(torch)
    names = [e.key for e in trace_kernels(prof, each=True)]
    products = 3 * cfg.n_layers + 1
    launched = sum("radix_matmul_kernel" in k for k in names)
    check(launched == products and radix_lib.PRODUCTS["fused"]
          == before["fused"] + products and radix_lib.PRODUCTS["int32"]
          == before["int32"],
          f"GLM4-9B SMOKE prefill: {launched} radix_matmul_kernel "
          f"launches, {products} products")
    fused_path = radix_lib.fused_path
    radix_lib.fused_path = lambda *a, **k: False
    try:
        want = exe.prefill(prompts)["logits"]
    finally:
        radix_lib.fused_path = fused_path
    sync(torch)
    check(torch.equal(got, want),
          "GLM4-9B SMOKE prefill: fused logits differ from the int32 path's")
    rows["s"] = time.perf_counter() - t0
    results["lm_fused"] = rows
    log("[kernel] GLM4-9B fused radix products equal their int32 path "
        f"({len(FUSED_PRODUCTS)} shapes and M = {m}, quantize x3 at 333 "
        f"and {m} rows, SMOKE prefill: "
        f"{launched} launches); at M = {m}: " + ", ".join(
            f"{k} {v:.3f}" for k, v in rows.items()))


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
    from repro_torch.kernels import work

    b, s_len, hkv, g, hd = (case[k] for k in ("b", "s", "hkv", "g", "hd"))
    w = work.decode_attn(b, s_len, hkv, g, hd, packed=case["packed"],
                         q_bytes=2 if case["q"] == "bf16" else 4,
                         valid=int(mask.sum()) * hkv)   # (row, slot) pairs
    t_bytes = w.nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = (w.int8_ops / INT8_OPS_PER_S + w.f32_ops / F32_OPS_PER_S) * 1e3
    return ((t_bytes, "bytes") if t_bytes >= t_ops
            else (t_ops, "operations")) + (w.nbytes,)


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
        n = len(trace_kernels(prof, each=True))
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
    from repro_torch.kernels import work
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
                w = work.encode(x.numel())
                t_bytes = w.nbytes / HBM_BYTES_PER_S * 1e3
                t_ops = w.f32_ops / F32_OPS_PER_S * 1e3
                row["bound_ms"], row["bound_by"] = (
                    (t_bytes, "bytes") if t_bytes >= t_ops
                    else (t_ops, "operations"))
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
    kernels = trace_kernels(prof)
    busy_us = sum(e.us for e in kernels)
    if busy_us == 0:
        return None
    radix_us = sum(e.us for e in kernels if "radix_" in e.key)
    top = sorted(kernels, key=lambda e: e.us, reverse=True)[:5]
    return dict(
        profiled_wall_ms_per_call=wall_us / calls / 1e3,
        device_ms_per_call=busy_us / calls / 1e3,
        radix_kernels_ms_per_call=radix_us / calls / 1e3,
        other_kernels_ms_per_call=(busy_us - radix_us) / calls / 1e3,
        busy_share=busy_us / calls / 1e3 / wall_ms,
        top=[(e.key[:70], e.us / calls / 1e3, e.count // calls)
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
        kernels = trace_kernels(prof)
        busy_ms = sum(e.us for e in kernels) / 1e3
        if busy_ms == 0:
            out[name] = None
            continue
        calls = 1 if name == "prefill" else 3
        top = sorted(kernels, key=lambda e: e.us, reverse=True)[:6]
        launched = sum(e.count for e in kernels)
        out[name] = dict(
            profiled_wall_ms=wall_ms / calls, device_ms=busy_ms / calls,
            busy_share=busy_ms / wall_ms, device_kernels=launched / calls,
            attn_ms=sum(e.us for e in kernels
                        if "radix_decode_attn" in e.key) / 1e3 / calls,
            radix_ms=sum(e.us for e in kernels if "radix_" in e.key)
            / 1e3 / calls,
            top=[(e.key[:60], e.us / 1e3 / calls, e.count // calls)
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


PLANE_KEYS = ("plane_passes_skipped", "plane_passes_total")


def card_plane_run(torch, exe, x, requests, label: str, cases: dict,
                   run: dict) -> None:
    """The timed card plan ``exe`` over ``requests``: its logits and the
    plane-skip counters those requests moved, kept in ``cases[label]``
    with what the same plan compiled for the CPU needs
    (:func:`cpu_plane_job`); :func:`plane_check` holds the two equal and
    fills ``run["cpu_plane_check"]``."""
    before = exe.stats()
    got = [exe(x[:n]).cpu() for n in requests]
    after = exe.stats()
    cases[label] = dict(
        qnet=exe.qnet, item=exe.item_shape, buckets=exe.buckets,
        dataflow=exe.dataflow,
        x=x.cpu(), requests=list(requests), logits=got,
        counters={k: after[k] - before[k] for k in PLANE_KEYS}, run=run)


def cpu_plane_job(in_path: str, out_path: str) -> None:
    """Phase 9's CPU plans (run by :func:`plane_job` in a subprocess that
    sees no CUDA device): each case of ``in_path`` compiled for the CPU
    (the kernels' plain versions) and run over its requests; pickles the
    logits and plane counters by case to ``out_path``."""
    import pickle

    import torch

    from repro_torch import api

    out = {}
    cases = torch.load(in_path, weights_only=False, map_location="cpu")
    for label, c in cases.items():
        cpu = api.Accelerator(dataflow=c["dataflow"], device="cpu").compile(
            c["qnet"], c["item"], buckets=c["buckets"])
        logits = [cpu(c["x"][:n]) for n in c["requests"]]
        out[label] = dict(logits=logits,
                          counters={k: cpu.stats()[k] for k in PLANE_KEYS})
    with open(out_path, "wb") as f:
        pickle.dump(out, f)


def plane_job(torch, cases: dict) -> "CpuJob":
    """Start :func:`cpu_plane_job` over ``cases`` (after phase 9's timed
    walls: it runs beside phases 10-11)."""
    (ROOT / "build").mkdir(exist_ok=True)
    path = ROOT / "build" / "plane_cases.pt"
    torch.save({k: {f: v for f, v in c.items() if f not in
                    ("logits", "counters", "run")}
                for k, c in cases.items()}, str(path))
    return CpuJob("plane", ["-c", "import chip_smoke; chip_smoke."
                            f"cpu_plane_job({str(path)!r}, {{out!r}})"])


def plane_check(torch, job, cases: dict) -> None:
    """Phase 9's card plans against the same plans on the CPU: logits and
    the plane-skip counters of the same requests equal."""
    cpu = job.result(900)
    (ROOT / "build" / "plane_cases.pt").unlink(missing_ok=True)
    for label, c in cases.items():
        got = cpu[label]
        for n, a, b in zip(c["requests"], c["logits"], got["logits"]):
            check(torch.equal(a, b),
                  f"{label}: card != CPU plan for a request of {n}")
        out = {k: (c["counters"][k], got["counters"][k]) for k in PLANE_KEYS}
        check(all(a == b for a, b in out.values()),
              f"{label}: plane counters card/CPU {out}")
        c["run"]["cpu_plane_check"] = dict(requests=c["requests"],
                                           **c["counters"])
        log(f"[enc] {label}: card == CPU plan over requests "
            f"{c['requests']} (logits, plane counters {c['counters']})")
    log(f"[enc] phase 9's CPU plans: a subprocess of {CpuJob.THREADS} "
        f"threads, {job.wall_s:.1f} s; waited {job.wait_s:.1f} s")


def phase_encodings(torch, np, results, plane_cases=None) -> dict:
    """TTFS, phase and rate (and radix on the jnp backend) through
    ``convert`` -> ``Accelerator.compile`` -> ``Executable`` at VGG-11's
    full width and Fang CNN-2's; returns the converted nets by case.  The
    card plans' runs for the CPU plane check go to ``plane_cases``
    (:func:`plane_check` after a :func:`plane_job`), or are checked here
    when it is None."""
    from repro_torch import api

    inline = plane_cases is None
    plane_cases = {} if inline else plane_cases
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
                card_plane_run(torch, exe, x, (BUCKETS[-1],)
                               if net_name == "vgg11" else REQUESTS, label,
                               plane_cases, run)
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
                f"{stats['plane_passes_total']}")
        log(f"[enc] {key}: per-class std {spread:.4f}, "
            f"{row['argmax_classes']} distinct argmax classes, convert + "
            f"oracles {oracle_s:.2f} s"
            + (f"; degenerate at T = {degenerate_at}" if degenerate_at
               else ""))
        out[key] = row
    results["encodings"] = out
    if inline and plane_cases:
        plane_check(torch, plane_job(torch, plane_cases), plane_cases)
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
# ran 16 layers; since phase 19 joined the script's time limit GLM4-9B
# runs 10 of its 40 layers, Gemma-7B 14 of 28 and DeepSeek-Coder-33B 8;
# RecurrentGemma's second request (2100 tokens) is longer than its
# 2048-slot window, so prefill rolls the ring and decode wraps.
ARCH_PHASES = (
    ("glm4_9b", 10, ("fused", "bitserial"), ((8, 40, 8), (3, 200, 8)),
     "compile", LM_BUCKETS),
    ("gemma_7b", 14, ("fused",), ((8, 40, 8),), "compile", LM_BUCKETS),
    ("deepseek_coder_33b", 8, ("fused",), ((8, 40, 8),), "compile",
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


# ---------------------------------------------------------------------------
# Phase 14: LM serving (launch/serve_lm) behind the resilience queue.
# ---------------------------------------------------------------------------

SERVE_LM_PROMPT, SERVE_LM_NEW = 200, 16
# 8 requests a stream (16 before), to keep the script inside its limit
SERVE_LM_REQUESTS, SERVE_LM_DRILL = 8, 8
# (server, Accelerator keywords, compile keywords, ArchConfig fields)
LM_SERVERS = (
    ("kernels fused", dict(dataflow="fused"), {}, {}),
    ("kernels fused autotune", dict(dataflow="fused"),
     dict(autotune=True), {}),
    ("kernels bitserial radix_attn", dict(dataflow="bitserial"), {},
     dict(radix_attn=True)),
    ("jnp", dict(backend="jnp"), {}, {}),
)
SERVE_LM_ARGV = ["--arch", "gemma_2b", "--batch", str(LM_BATCH),
                 "--max-len", str(LM_MAX_LEN), "--buckets",
                 ",".join(map(str, LM_BUCKETS)), "--prompt-len",
                 str(SERVE_LM_PROMPT), "--max-new", str(SERVE_LM_NEW),
                 "--dataflow", "fused", "--requests", "8"]


def serve_launches(cfg, backend: str) -> dict:
    """Launches of one ``generate`` (a prefill and ``SERVE_LM_NEW - 1``
    decode steps): ``lm_launches`` per token position, plus the QKV/out
    projections under ``radix_attn``; none on the ``jnp`` backend."""
    mm, attn, _ = lm_launches(cfg)
    mm += 4 * cfg.n_layers if cfg.radix_attn else 0
    on = backend == "kernels"
    return {"radix_conv2d": 0,
            "radix_matmul": on * mm * SERVE_LM_NEW,
            "radix_decode_attn": on * attn * (SERVE_LM_NEW - 1),
            "spike_encode": 0}


def served_launches(server, before: dict, stats0: dict, label: str) -> dict:
    """The launches since ``before`` (counters) and ``stats0`` (the
    server's stats): they must equal ``serve_launches`` per ``generate``
    the server ran; a flush of more prompts than the batch runs one per
    chunk of it, and each is ``SERVE_LM_NEW`` plan executions."""
    after, stats = counters(), server.stats()
    execs = stats["executions"] - stats0["executions"]
    check(execs % SERVE_LM_NEW == 0,
          f"{label}: {execs} executions, not whole generates")
    launches = {k: after[k] - before[k] for k in after}
    want = {k: v * (execs // SERVE_LM_NEW)
            for k, v in serve_launches(server.exe.cfg,
                                       server.exe.backend).items()}
    check(DEV != "cuda" or launches == want,
          f"{label}: launches {launches} != {want} "
          f"({execs // SERVE_LM_NEW} generates)")
    return launches


def profile_flush(torch, server, rows) -> dict:
    """Device time over the profiled wall time of one queue flush of
    ``rows`` (a full batch), by ``torch.profiler``; None when no trace
    holds device time."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch import serve_lm

    queue = serve_lm.make_queue(server)
    for _ in range(PROFILE_TRIES):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            queue.submit(rows)
            queue.flush()
            sync(torch)
            wall_ms = (time.perf_counter() - t0) * 1e3
        busy_ms = sum(e.us for e in trace_kernels(prof)) / 1e3
        if busy_ms:
            return dict(wall_ms=wall_ms, device_ms=busy_ms,
                        busy_share=busy_ms / wall_ms)
    return None


def serve_lm_stream(torch, server, sizes, seed: int, label: str) -> dict:
    """``run_prompt_stream`` of ``sizes`` through a fresh ``make_queue``:
    every ticket resolves; no ``infer`` call raises (so no flush is
    bisected); the launches equal ``serve_launches`` per ``generate``; no
    plan is built.  Returns the tickets' tokens, rates,
    latency percentiles, flushes and peak memory."""
    from repro_torch.launch import serve_cnn, serve_lm

    exe = server.exe
    built = exe.stats()["compiles"]
    queue = serve_lm.make_queue(server)
    if DEV == "cuda":
        torch.cuda.reset_peak_memory_stats()
        base_gb = torch.cuda.memory_allocated() / 1e9
    faults = []

    def infer(x, _infer=server.infer):
        try:
            return _infer(x)
        except Exception as err:
            faults.append(repr(err))
            raise

    server.infer = infer
    before, stats0 = counters(), server.stats()
    t0 = time.perf_counter()
    tickets = serve_lm.run_prompt_stream(queue, sizes, seed=seed)
    sync(torch)
    wall = time.perf_counter() - t0
    del server.infer
    check(not faults, f"{label}: infer raised {faults}")
    launches = served_launches(server, before, stats0, label)
    check(all(t.ok for t in tickets),
          f"{label}: failed tickets "
          f"{[type(t.error).__name__ for t in tickets if not t.ok]}")
    for t in tickets:
        check(tuple(t.result.shape) == (t.size, SERVE_LM_NEW),
              f"{label}: tokens of shape {tuple(t.result.shape)}")
    stats = server.stats()
    check(stats["compiles"] == built, f"{label}: plans built in serving")
    prompts = int(sum(sizes))
    p50, p95 = serve_cnn._percentiles([t.latency_s * 1e3 for t in tickets])
    out = dict(tokens=[t.result for t in tickets], wall_s=wall,
               prompts=prompts, new_tokens=prompts * SERVE_LM_NEW,
               tokens_per_s=prompts * SERVE_LM_NEW / wall, p50_ms=p50,
               p95_ms=p95, flushes=queue.flushes, launches=launches,
               health=queue.health.state,
               degraded_flushes=stats["degraded_flushes"])
    if DEV == "cuda":
        out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        out["stream_extra_gb"] = out["peak_gb"] - base_gb
    log(f"[serve_lm] {label}: {len(tickets)} requests / {prompts} prompts "
        f"-> {out['new_tokens']} tokens in {wall:.3f} s = "
        f"{out['tokens_per_s']:.1f} tokens/s; latency p50 {p50:.1f} ms p95 "
        f"{p95:.1f} ms; {queue.flushes} flushes "
        f"({stats['degraded_flushes']} degraded, health "
        f"{queue.health.state}); launches {launches}"
        + (f"; peak {out['peak_gb']:.2f} GB ({out['stream_extra_gb']:.3f} "
           "GB above the weights and plans)" if DEV == "cuda" else ""))
    return out


def plain_check(torch, model, exe, prompts, label: str) -> None:
    """One request's logits at every step ``torch.equal`` to the plain
    path with the executable's config (``use_kernel`` off)."""
    r = serve_greedy(exe, prompts, SERVE_LM_NEW)
    plain_cfg = dataclasses.replace(exe.cfg, use_kernel=False)
    ref = plain_logits(model, exe.params, plain_cfg, prompts, r["tokens"],
                       exe._cache.bucket_for(prompts.shape[1]))
    c = compare_logits(torch, r["logits"], ref)
    check(c["equal"], f"{label}: logits differ from the plain path {c}")


def lm_drill(torch, server, vocab: int) -> dict:
    """``SERVE_LM_DRILL`` seeded requests, one holding the token id
    ``vocab``: only that request is quarantined (after the retry budget),
    every other resolves to ``exe.generate``'s tokens, and the launches
    equal ``serve_launches`` per ``generate``."""
    import numpy as np

    from repro_torch.launch import serve_lm
    from repro_torch.runtime import resilience

    exe = server.exe
    rng = np.random.default_rng(SEED + 142)
    sizes = rng.integers(1, LM_BATCH + 1, SERVE_LM_DRILL)
    rows = serve_lm.prompt_rows(sizes, SERVE_LM_PROMPT, vocab,
                                seed=SEED + 143)
    bad = SERVE_LM_DRILL // 2
    rows[bad][0, SERVE_LM_PROMPT // 2] = vocab
    queue = serve_lm.make_queue(server)
    before, stats0 = counters(), server.stats()
    tickets = [queue.submit(r) for r in rows]
    queue.flush()
    sync(torch)
    launches = served_launches(server, before, stats0, "drill")
    stats1 = server.stats()
    check([t.ok for t in tickets] ==
          [i != bad for i in range(SERVE_LM_DRILL)],
          f"drill: tickets ok {[t.ok for t in tickets]}")
    check(isinstance(tickets[bad].error, resilience.RequestPoisoned),
          f"drill: poisoned ticket error {tickets[bad].error!r}")
    moved = {k: stats1[k] - stats0[k]
             for k in ("quarantined", "retried", "rejected", "shed")}
    check(moved == {"quarantined": 1, "retried": 2, "rejected": 0,
                    "shed": 0}, f"drill: counters moved {moved}")
    for i, t in enumerate(tickets):
        if i != bad:
            check(torch.equal(t.result, exe.generate(rows[i], SERVE_LM_NEW)),
                  f"drill: ticket {i} != exe.generate")
    log(f"[serve_lm] drill: {SERVE_LM_DRILL} requests {sizes.tolist()}, "
        f"request {bad} holds token id {vocab}: quarantined alone after "
        f"{moved['retried']} retries; {queue.flushes} flushes, launches "
        f"{launches} reconcile; health {queue.health.state}")
    return dict(sizes=sizes.tolist(), flushes=queue.flushes, **moved)


def phase_lm_serving(torch, arch, results) -> None:
    """Gemma-2B (full width and depth, bf16, T = 4, packed KV and packed
    attention) behind ``launch.serve_lm``: four servers over one weight
    tree take the same seeded prompt stream; then a poison drill and the
    CLI once."""
    import numpy as np

    from repro_torch import api
    from repro_torch.kernels import autotune as autotune_mod
    from repro_torch.launch import serve_lm
    from repro_torch.lm import model

    t_phase = time.perf_counter()
    cfg = dataclasses.replace(arch, radix_steps=T, radix_kv_pack=True,
                              packed_attn=True)
    params, n_params = arch_params(torch, model, cfg)
    sizes = np.random.default_rng(SEED + 140).integers(
        1, LM_BATCH + 1, SERVE_LM_REQUESTS)
    prompts = serve_lm.prompt_rows(sizes, SERVE_LM_PROMPT, cfg.vocab,
                                   seed=SEED + 141)
    out = dict(params=n_params, sizes=sizes.tolist(), servers={})
    tokens = {}
    for name, acc_kw, compile_kw, fields in LM_SERVERS:
        t0 = time.perf_counter()
        exe = api.Accelerator(device=DEV, **acc_kw).compile(
            (params, dataclasses.replace(cfg, **fields)),
            (LM_BATCH, LM_MAX_LEN), buckets=LM_BUCKETS, **compile_kw)
        server = serve_lm.LMServer(executable=exe,
                                   prompt_len=SERVE_LM_PROMPT,
                                   max_new=SERVE_LM_NEW)
        server.warmup()
        build_s = time.perf_counter() - t0
        row = serve_lm_stream(torch, server, sizes, SEED + 141, name)
        tokens[name] = row.pop("tokens")
        row["build_s"] = build_s
        first = torch.as_tensor(prompts[0], device=DEV).long()
        if exe.backend == "kernels":
            plain_check(torch, model, exe, first, name)
        if name == "kernels fused":
            for i, t in enumerate(tokens[name]):
                check(torch.equal(t, exe.generate(prompts[i], SERVE_LM_NEW)),
                      f"{name}: ticket {i} != exe.generate")
            out["drill"] = lm_drill(torch, server, cfg.vocab)
            row["profile"] = profile_flush(
                torch, server,
                np.concatenate(prompts)[:LM_BATCH])
            pr = row["profile"]
            log(f"[serve_lm] {name}: one flush of {LM_BATCH} prompts "
                + ("profile: no device time (not measured)" if pr is None
                   else f"{pr['wall_ms']:.1f} ms wall, device "
                   f"{pr['device_ms']:.1f} ms ({100 * pr['busy_share']:.1f}"
                   "% busy)"))
        if compile_kw.get("autotune"):
            attn = next(r for r in exe.stats()["autotune"]["layers"]
                        if r["layer"] == "decode_attn")
            row["attn_split"] = (attn["split_slots"], attn["max_splits"])
        out["servers"][name] = row
        log(f"[serve_lm] {name}: compile and warmup {build_s:.1f} s")
        del server, exe
        if DEV == "cuda":
            torch.cuda.empty_cache()

    ref = tokens["kernels fused"]

    def same(name):
        return [torch.equal(a, b) for a, b in zip(tokens[name], ref)]

    # jnp computes the fused server's function exactly; the tuned server
    # too at the default KV split (another split adds the softmax in
    # another order); radix_attn also quantizes the QKV/out projections,
    # another function, whose greedy tokens these seeded weights leave
    # unchanged (and whose logits are held to its own plain path above)
    default = (autotune_mod.KernelConfig().split_slots,
               autotune_mod.KernelConfig().max_splits)
    tuned = out["servers"]["kernels fused autotune"]["attn_split"]
    for name in tokens:
        agree = same(name)
        out["servers"][name]["tickets_equal_fused"] = sum(agree)
        check(all(agree) or (name == "kernels fused autotune"
                             and tuned != default),
              f"{name}: tokens != kernels fused's: {agree}")
        log(f"[serve_lm] {name}: {sum(agree)} of {len(agree)} tickets' "
            "tokens torch.equal to the kernels fused server's"
            + (f" (tuned KV split {tuned}, default {default})"
               if name == "kernels fused autotune" else ""))
    del params
    if DEV == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    cli = serve_lm.main(SERVE_LM_ARGV)
    check(cli["ok"] == cli["requests"] and cli["steady_compiles"] == 0,
          f"serve_lm.main: {cli['ok']} of {cli['requests']} served, "
          f"{cli['steady_compiles']} steady-state plans")
    out["cli"] = {k: v for k, v in cli.items() if k != "stats"}
    out["cli"]["s"] = time.perf_counter() - t0
    out["phase_s"] = time.perf_counter() - t_phase
    if DEV == "cuda":
        torch.cuda.empty_cache()
    results["lm_serving"] = out
    log(f"[serve_lm] phase 14: {out['phase_s']:.1f} s (CLI "
        f"{out['cli']['s']:.1f} s: {cli['tokens_per_s']:.1f} tokens/s, p50 "
        f"{cli['p50_ms']:.1f} ms p95 {cli['p95_ms']:.1f} ms)")


# ---------------------------------------------------------------------------
# Phase 15: the PPA planner (api.autoconfigure) on VGG-11, card and CPU.
# ---------------------------------------------------------------------------

# T in (3, 4) (3-6 before): the CPU's search took 116 s of the script's
# limit
PLAN_KW = dict(accuracy_floor=0.5, t_range=(3, 4), units=(1, 2, 4, 8))
PLAN_CALIB = 32
SERVE_CNN_AUTO_ARGV = ["--arch", "vgg11", "--auto", "--pool-mode", "avg",
                       "--accuracy-floor", str(PLAN_KW["accuracy_floor"]),
                       "--requests", "16", "--buckets", "1,8"]


def plan_view(plan) -> dict:
    """What two searches must agree on: every candidate (label, accuracy,
    modeled PPA, rejections), the frontier, the winner and the summary."""
    return dict(
        candidates=[(c.label, c.backend, c.dataflow, c.units, c.accuracy,
                     None if c.ppa is None else c.ppa.to_dict(), c.rejected)
                    for c in plan.candidates],
        frontier=[c.label for c in plan.frontier],
        winner=None if plan.winner is None else plan.winner.label,
        summary=plan.summary())


def planner_net():
    """Phase 15's float VGG-11 (224 x 224 x 3, 100 classes, avg pool) and
    its calibration batch, from the seed."""
    from repro_torch.launch import serve_cnn

    return serve_cnn.build_float_net("vgg11", smoke=False, pool_mode="avg",
                                     calib_batch=PLAN_CALIB, seed=SEED)


def plan_pick(plan):
    """The candidate phase 15 compiles: the winner, or with none feasible
    the most accurate priced candidate."""
    if plan.winner is not None:
        return plan.winner
    return max((c for c in plan.candidates if c.ppa is not None),
               key=lambda c: (c.accuracy, -c.ppa.energy_uj))


def cpu_plan_job(out_path: str) -> None:
    """Phase 15's search on the CPU (run by :func:`planner_job` in a
    subprocess that sees no CUDA device): pickles its ``plan_view``, its
    pick's label and that pick compiled on the CPU's ``stats()["ppa"]``,
    and the search's seconds to ``out_path``."""
    import pickle

    from repro_torch import api

    static, params, item, calib = planner_net()
    t0 = time.perf_counter()
    plan = api.autoconfigure((static, params), item, calib=calib,
                             device="cpu", **PLAN_KW)
    search_s = time.perf_counter() - t0
    top = plan_pick(plan)
    ppa = plan.compile(candidate=top, buckets=BUCKETS).stats()["ppa"]
    with open(out_path, "wb") as f:
        pickle.dump(dict(view=plan_view(plan), top=top.label, ppa=ppa,
                         search_s=search_s), f)


def planner_job() -> "CpuJob":
    return CpuJob("planner", ["-c", "import chip_smoke; "
                              "chip_smoke.cpu_plan_job({out!r})"])


def phase_planner(torch, results, job=None) -> None:
    """``api.autoconfigure`` over VGG-11 (224 x 224 x 3, 100 classes, avg
    pool) on the card, and on the CPU in a subprocess (``job``, started
    beside earlier phases, or started here): equal plans; the winner (or,
    with none feasible, the most accurate priced candidate) compiled on
    the card, its logits ``torch.equal`` to both oracles, its launches
    counted, its ``stats()["ppa"]`` the CPU's; then ``serve_cnn
    --auto``."""
    from repro_torch import api
    from repro_torch.launch import serve_cnn

    t_phase = time.perf_counter()
    job = job or planner_job()
    static, params, item, calib = planner_net()
    out = {}
    t0 = time.perf_counter()
    plan = api.autoconfigure((static, params), item, calib=calib,
                             device=DEV, **PLAN_KW)
    sync(torch)
    out[f"search_{DEV}_s"] = time.perf_counter() - t0
    cpu = job.result(900)
    out.update(search_cpu_s=cpu["search_s"], cpu_job_s=job.wall_s,
               cpu_job_wait_s=job.wait_s)
    view, cpu_view = plan_view(plan), cpu["view"]
    if view != cpu_view:
        for key in view:
            if view[key] != cpu_view[key]:
                log(f"[plan] card and CPU differ in {key}")
    check(view == cpu_view, "the card's plan != the CPU's")
    accs = sorted({(c.spec.name, c.spec.num_steps, c.accuracy)
                   for c in plan.candidates if c.accuracy is not None},
                  key=lambda a: -a[2])
    log(f"[plan] VGG-11 search: {len(plan.candidates)} candidates, "
        f"{sum(c.feasible for c in plan.candidates)} feasible; card "
        f"{out[f'search_{DEV}_s']:.2f} s, CPU {out['search_cpu_s']:.2f} s "
        f"(a subprocess of {CpuJob.THREADS} threads, {job.wall_s:.1f} s "
        f"with its start; this phase waited {job.wait_s:.1f} s for it); "
        "plans equal; accuracy by spec: "
        + ", ".join(f"{n}/T={t} {a:.3f}" for n, t, a in accs))
    for line in plan.summary().splitlines()[:4]:
        log(f"[plan] {line}")
    top = plan_pick(plan)
    if plan.winner is None:
        log(f"[plan] no candidate passes {PLAN_KW['accuracy_floor']}; best "
            f"accuracy {top.accuracy:.3f}; rejections: "
            + "; ".join(sorted({r for c in plan.candidates
                                for r in c.rejected})))
    check(cpu["top"] == top.label, f"the CPU's pick {cpu['top']} != the "
          f"card's {top.label}")
    exe = plan.compile(candidate=top, buckets=BUCKETS)
    qnet = exe.qnet
    x = torch.rand((max(REQUESTS),) + item,
                   generator=torch.Generator().manual_seed(SEED + 150)
                   ).to(DEV)
    want = api.oracle(qnet, x, mode="snn")
    check(torch.equal(want, api.oracle(qnet, x, mode="packed")),
          "planner: snn != packed oracle")
    before = counters()
    rounds = serve_rounds(torch, exe, x, want, f"planner {top.label}")
    after = counters()
    execs = rounds[1]["executions"]
    n_conv = sum(1 for k, _ in static if k == "conv")
    n_lin = sum(1 for k, _ in static if k == "linear")
    on = exe.backend == "kernels"
    launches = {k: after[k] - before[k] for k in after}
    want_l = {"radix_conv2d": on * n_conv * execs,
              "radix_matmul": on * n_lin * execs, "radix_decode_attn": 0,
              "spike_encode": 0}
    check(DEV != "cuda" or launches == want_l,
          f"planner: launches {launches} != {want_l}")
    ppa = exe.stats()["ppa"]
    check(ppa == cpu["ppa"], "planner: stats()['ppa'] card != CPU")
    # the same search through the compile entry point, on the card
    auto = dict(PLAN_KW, calib=calib)
    try:
        auto_exe = api.Accelerator(device=DEV).compile(
            (static, params), item, buckets=BUCKETS, auto=auto)
    except ValueError as err:
        check(plan.winner is None and "no feasible configuration"
              in str(err), f"compile(auto=): {err}")
        out["compile_auto"] = "no feasible configuration"
    else:
        check(auto_exe.auto_plan.winner.label == top.label
              and torch.equal(auto_exe(x), want),
              "compile(auto=) != the plan's winner")
        out["compile_auto"] = auto_exe.auto_plan.winner.label
        del auto_exe
    log(f"[plan] compile(auto=) on the card: {out['compile_auto']}")
    out.update(winner=None if plan.winner is None else plan.winner.label,
               compiled=top.label, backend=exe.backend, accuracy=top.accuracy,
               executions=execs, launches=launches, ppa=ppa,
               candidates=len(plan.candidates),
               feasible=sum(c.feasible for c in plan.candidates))
    log(f"[plan] compiled {top.label} ({exe.backend}): requests "
        f"{REQUESTS} x 2 rounds torch.equal to both oracles, {execs} "
        f"executions, launches {launches}; modeled FPGA build (not the "
        f"GPU) at {top.ppa.units} units: {top.ppa.latency_us:.1f} us, "
        f"{top.ppa.energy_uj:.1f} uJ, {top.ppa.klut:.1f} kLUT; stats()"
        f"['ppa'] (the default {ppa['units']}-unit build) "
        f"{ppa['latency_us']:.1f} us, {ppa['energy_uj']:.1f} uJ")
    del exe, plan
    t0 = time.perf_counter()
    try:
        cli = serve_cnn.main(SERVE_CNN_AUTO_ARGV)
    except ValueError as err:
        check(out["winner"] is None and "no feasible configuration"
              in str(err), f"serve_cnn --auto: {err}")
        out["cli"] = "no feasible configuration"
        log("[plan] serve_cnn --auto: no feasible configuration, as the "
            "search above found")
    else:
        check(cli["ok"] == cli["requests"],
              f"serve_cnn --auto served {cli['ok']} of {cli['requests']}")
        out["cli"] = dict(winner=cli["plan"].winner.label,
                          images_per_s=cli["images"] / cli["wall_s"],
                          p50_ms=cli["p50_ms"], p95_ms=cli["p95_ms"])
    out["cli_s"] = time.perf_counter() - t0
    out["phase_s"] = time.perf_counter() - t_phase
    results["planner"] = out
    log(f"[plan] phase 15: {out['phase_s']:.1f} s (serve_cnn --auto "
        f"{out['cli_s']:.1f} s)")


# ---------------------------------------------------------------------------
# Phase 16: training on the card, and trained weights on the kernels' path.
# ---------------------------------------------------------------------------

# LeNet-5: the reference's table-1 recipe (benchmarks/table1_timesteps.py)
LENET_TRAIN = dict(steps=300, batch_size=128, lr=1e-2)
LENET_ACC_BAR = 0.8            # tests/test_data_train.py's bar
# VGG-11 at 224 x 224 x 3, 100 classes: trained for a fixed wall budget
VGG_TRAIN = dict(batch_size=32, lr=2e-3, budget_s=30.0, eval_batches=4,
                 eval_batch_size=64, calib=32)
RESTART = dict(steps=17, ckpt_every=4, fault_at=9)
# Gemma-2B at full width and depth, bf16
LM_TRAIN = dict(steps=10, resume_to=12, ckpt_every=5, batch=8, seq=512,
                lr=3e-3, adam_steps=8)
LM_TRAIN_REQUEST = (8, 40, 8)  # (prompts, tokens, new tokens)


def reset_peak(torch) -> None:
    if DEV == "cuda":
        torch.cuda.reset_peak_memory_stats()


def peak_gb(torch) -> float:
    return torch.cuda.max_memory_allocated() / 1e9 if DEV == "cuda" else 0.0


def empty_cache(torch) -> None:
    if DEV == "cuda":
        torch.cuda.empty_cache()


def train_profile(torch, fn, steps: int) -> dict:
    """Device time over ``steps`` calls of ``fn`` (one train step each)
    by ``torch.profiler``, and its share of the profiled wall."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        sync(torch)
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = trace_kernels(prof)
    busy_ms = sum(e.us for e in kernels) / 1e3
    if busy_ms == 0:
        return None
    top = sorted(kernels, key=lambda e: e.us, reverse=True)[:5]
    return dict(profiled_wall_ms=wall_ms / steps, device_ms=busy_ms / steps,
                busy_share=busy_ms / wall_ms,
                top=[(e.key[:60], e.us / 1e3 / steps) for e in top])


def _profile_text(pr) -> str:
    if pr is None:
        return "profile: no device time recorded (not measured)"
    return (f"profile: device {pr['device_ms']:.2f} ms a step of "
            f"{pr['profiled_wall_ms']:.2f} ms profiled wall "
            f"({100 * pr['busy_share']:.1f}% busy); top: "
            + "; ".join(f"{k} {v:.2f} ms" for k, v in pr["top"]))


def snn_accuracy(torch, exe, data, batches: int, batch_size: int) -> float:
    """The compiled plan's accuracy over the held-out batches
    ``evaluate_ann`` reads (steps 10 000 + i)."""
    correct = total = 0
    for i in range(batches):
        xb, yb = data.batch(10_000 + i, batch_size)
        pred = exe(torch.from_numpy(xb).to(DEV)).argmax(-1).cpu().numpy()
        correct += int((pred == yb).sum())
        total += batch_size
    return correct / total


def serve_trained(torch, api, name, static, qnet, hw, data, dataflows,
                  batches: int, batch_size: int) -> dict:
    """Compile ``qnet`` on the kernels backend for ``dataflows`` with
    buckets (1, 8); a request of 8 held-out images ``torch.equal`` to both
    oracles; the SNN accuracy over ``batches`` held-out batches; launches
    = layers x executions."""
    n_conv = sum(1 for k, _ in static if k == "conv")
    n_lin = sum(1 for k, _ in static if k == "linear")
    x = torch.from_numpy(data.batch(10_000, BATCH)[0]).to(DEV)
    want_snn = api.oracle(qnet, x, mode="snn")
    want_packed = api.oracle(qnet, x, mode="packed")
    check(torch.equal(want_snn, want_packed),
          f"{name}: snn != packed oracle on the trained net")
    out = dict(logits_class_std=float(want_snn.std(dim=0).mean()))
    for dataflow in dataflows:
        exe = api.Accelerator(dataflow=dataflow, backend="kernels",
                              device=DEV).compile(qnet, hw, buckets=BUCKETS)
        before = counters()
        got = exe(x)
        check(torch.equal(got, want_snn),
              f"{name} {dataflow}: trained logits differ from the oracles "
              f"(max |diff| {(got - want_snn).abs().max()})")
        acc = snn_accuracy(torch, exe, data, batches, batch_size)
        sync(torch)
        after = counters()
        execs = exe.stats()["executions"]
        launches = {k: after[k] - before[k] for k in after}
        check(DEV != "cuda" or (launches["radix_conv2d"] == n_conv * execs
                                and launches["radix_matmul"]
                                == n_lin * execs),
              f"{name} {dataflow}: launches {launches} != ({n_conv} conv, "
              f"{n_lin} linear) x {execs} executions")
        out[dataflow] = dict(snn_acc=acc, executions=execs,
                             launches=launches)
        log(f"[train] {name} {dataflow}: 8 held-out images equal both "
            f"oracles; SNN accuracy {acc:.4f} over {batches * batch_size} "
            f"images; {execs} executions, launches {launches}")
        del exe
    return out


def determinism_cost(torch, one, steps: int) -> dict:
    """Median step ms (host clock, each step ended by a synchronize) of
    ``one()`` without and with ``train.determinism.deterministic``, in
    turns: plain, deterministic, deterministic, plain, ``steps`` steps
    each."""
    from repro_torch.train.determinism import deterministic

    times = {"plain": [], "deterministic": []}
    for mode in ("plain", "deterministic", "deterministic", "plain"):
        for _ in range(steps):
            sync(torch)
            t0 = time.perf_counter()
            if mode == "plain":
                one()
            else:
                with deterministic():
                    one()
            sync(torch)
            times[mode].append((time.perf_counter() - t0) * 1e3)
    out = {f"{k}_ms": statistics.median(v) for k, v in times.items()}
    out["cost_ms"] = out["deterministic_ms"] - out["plain_ms"]
    return out


def _determinism_text(d: dict) -> str:
    return (f"{d['plain_ms']:.2f} ms a step plain, {d['deterministic_ms']:.2f}"
            f" ms with deterministic kernels ({d['cost_ms']:+.2f} ms; "
            "medians, host clock)")


def phase_train_lenet(torch, np_, results) -> None:
    """LeNet-5 at full width trained by ``train_ann`` on the table-1
    recipe; ANN accuracy >= 0.8; conversion on the card equal to the
    CPU's; both dataflows' logits equal the oracles; SNN accuracy over the
    same 2048 held-out images."""
    from repro_torch import api
    from repro_torch.core.encoding import RadixEncoding
    from repro_torch.data import SyntheticVision
    from repro_torch.models import lenet
    from repro_torch.train.trainer import TrainConfig, evaluate_ann, train_ann

    t0 = time.perf_counter()
    data = SyntheticVision()
    static, params, hw = lenet.make(np_.random.default_rng(SEED))
    cfg = TrainConfig(log_every=100, **LENET_TRAIN)
    trained, last = train_ann(static, params, data, cfg, log=log, device=DEV)
    ann_acc = evaluate_ann(static, trained, data, device=DEV)
    check(ann_acc >= LENET_ACC_BAR,
          f"lenet5: ANN accuracy {ann_acc:.4f} < {LENET_ACC_BAR}")
    calib = torch.from_numpy(data.calibration_batch(256))
    qnet = api.convert(static, trained, calib.to(DEV),
                       encoding=RadixEncoding(T))
    cpu = api.convert(static, [None if p is None else
                               {k: v.cpu() for k, v in p.items()}
                               for p in trained], calib,
                      encoding=RadixEncoding(T))
    differ = []
    for i, (a, b) in enumerate(zip(qnet.qlayers, cpu.qlayers)):
        for k in ("w_q", "b_int", "mult") if a is not None else ():
            x, y = a[k], b[k]
            if (x is None) != (y is None) or (
                    x is not None and not torch.equal(x.cpu(), y)):
                differ.append((i, k, None if x is None or y is None else
                               float((x.cpu().double() - y.double())
                                     .abs().max())))
    check(not differ, f"lenet5: (layer, field, max |diff|) converted "
          f"differently on the card: {differ}")
    check(qnet.input_scale == cpu.input_scale,
          "lenet5: input scale differs card vs CPU")
    out = dict(train_s=last["wall_s"], last_loss=last["loss"],
               last_acc=last["acc"], ann_acc=ann_acc,
               images_per_s=cfg.steps * cfg.batch_size / last["wall_s"],
               **serve_trained(torch, api, "lenet5", static, qnet, hw, data,
                               ("fused", "bitserial"), 8, 256))
    # one seed, one result: a second run's weights, conversion and SNN
    # accuracy equal the first's (train_ann's deterministic kernels)
    again, _ = train_ann(static, params, data, cfg, log=None, device=DEV)
    same = all(torch.equal(a[k], b[k]) for a, b in zip(trained, again)
               if a is not None for k in a)
    q2 = api.convert(static, again, calib.to(DEV), encoding=RadixEncoding(T))
    same_q = all(a is None or all(
        (a[k] is None and b[k] is None) or torch.equal(a[k], b[k])
        for k in ("w_q", "b_int", "mult"))
        for a, b in zip(qnet.qlayers, q2.qlayers))
    exe2 = api.Accelerator(dataflow="fused", device=DEV).compile(
        q2, hw, buckets=BUCKETS)
    acc2 = snn_accuracy(torch, exe2, data, 8, 256)
    check(same and same_q and acc2 == out["fused"]["snn_acc"],
          f"lenet5: a second train_ann run of seed {SEED} differs: weights "
          f"equal {same}, converted equal {same_q}, SNN accuracy {acc2} vs "
          f"{out['fused']['snn_acc']}")
    out["second_run"] = dict(weights_equal=same, converted_equal=same_q,
                             snn_acc=acc2)
    log(f"[train] lenet5: a second train_ann run of the same seed: weights "
        f"torch.equal, conversion equal, SNN accuracy {acc2:.4f} equal")
    out["phase_s"] = time.perf_counter() - t0
    results.setdefault("training", {})["lenet5"] = out
    log(f"[train] lenet5: {cfg.steps} steps of {cfg.batch_size} in "
        f"{last['wall_s']:.2f} s ({out['images_per_s']:.0f} images/s), "
        f"ANN accuracy {ann_acc:.4f}, SNN (radix T={T}) fused "
        f"{out['fused']['snn_acc']:.4f} bitserial "
        f"{out['bitserial']['snn_acc']:.4f}; card and CPU conversions "
        f"equal; {out['phase_s']:.1f} s")


def phase_train_vgg(torch, np_, results) -> None:
    """VGG-11 at 224 x 224 x 3, 100 classes, trained with ``train_ann``'s
    step for ``VGG_TRAIN["budget_s"]`` seconds on prefetched batches: the
    loss finite and falling; images/s; a profile of 5 steps; ANN accuracy;
    radix T = 4 fused logits equal the oracle, SNN accuracy; whether TTFS
    and rate at T = 4 now vary across images (recorded)."""
    from repro_torch import api
    from repro_torch.core.encoding import (RadixEncoding, RateEncoding,
                                           TTFSEncoding)
    from repro_torch.data import Prefetcher, SyntheticVision
    from repro_torch.models import vgg
    from repro_torch.train import optim
    from repro_torch.train.trainer import (TrainConfig, evaluate_ann,
                                           make_ann_step)
    from repro_torch.train.tree import tree_map

    t_phase = time.perf_counter()
    v = VGG_TRAIN
    data = SyntheticVision(input_hw=(224, 224, 3), num_classes=100)
    static, params, hw = vgg.make(np_.random.default_rng(SEED),
                                  pool_mode="avg", input_hw=(224, 224, 3),
                                  width_mult=1.0, num_classes=100)
    cfg = TrainConfig(batch_size=v["batch_size"], lr=v["lr"])
    opt = optim.sgd(cfg.lr, cfg.momentum, nesterov=True)
    trainable = [tree_map(lambda t: t.to(DEV), p)
                 for p in params if p is not None]
    opt_state = opt.init(trainable)
    step = make_ann_step(static, params, cfg, opt)
    losses, t0 = [], time.perf_counter()
    for s, (xb, yb) in Prefetcher(lambda s: data.batch(s, cfg.batch_size),
                                  0, 10 ** 6, depth=4):
        trainable, opt_state, loss, _ = step(
            trainable, opt_state, torch.from_numpy(xb).to(DEV),
            torch.from_numpy(yb).to(DEV))
        losses.append(float(loss))
        if time.perf_counter() - t0 > v["budget_s"]:
            break
    wall = time.perf_counter() - t0
    check(all(math.isfinite(x) for x in losses),
          f"vgg11: non-finite training loss {losses[-10:]}")
    first, last = statistics.mean(losses[:10]), statistics.mean(losses[-10:])
    check(len(losses) >= 20 and last < first,
          f"vgg11: loss did not fall over {len(losses)} steps "
          f"({first:.4f} -> {last:.4f})")
    xb, yb = data.batch(0, cfg.batch_size)
    xb, yb = torch.from_numpy(xb).to(DEV), torch.from_numpy(yb).to(DEV)
    state = [trainable, opt_state]

    def one():
        state[0], state[1], _, _ = step(state[0], state[1], xb, yb)

    one()
    prof = train_profile(torch, one, 5)
    det_ms = determinism_cost(torch, one, 5)
    trainable = state[0]
    it = iter(trainable)
    trained = [next(it) if p is not None else None for p in params]
    ann_acc = evaluate_ann(static, trained, data, batches=v["eval_batches"],
                           batch_size=v["eval_batch_size"], device=DEV)
    calib = torch.from_numpy(data.calibration_batch(v["calib"])).to(DEV)
    qnet = api.convert(static, trained, calib, encoding=RadixEncoding(T))
    out = dict(steps=len(losses), train_wall_s=wall,
               images_per_s=len(losses) * cfg.batch_size / wall,
               loss_first10=first, loss_last10=last, profile=prof,
               determinism=det_ms,
               ann_acc=ann_acc,
               **serve_trained(torch, api, "vgg11", static, qnet, hw, data,
                               ("fused",), v["eval_batches"],
                               v["eval_batch_size"]))
    x8 = torch.from_numpy(data.batch(10_000, BATCH)[0]).to(DEV)
    for spec in (TTFSEncoding(T), RateEncoding(T)):
        q = api.convert(static, trained, calib, encoding=spec)
        lg = api.oracle(q, x8, mode="snn")
        out[f"{spec.name}_varies"] = bool(lg.std(dim=0).mean() > 0)
    out["phase_s"] = time.perf_counter() - t_phase
    results.setdefault("training", {})["vgg11"] = out
    log(f"[train] vgg11: {len(losses)} steps of {cfg.batch_size} in "
        f"{wall:.1f} s ({out['images_per_s']:.1f} images/s with the "
        f"prefetched host batches), loss {first:.4f} -> {last:.4f} (mean of "
        f"the first and last 10); {_profile_text(prof)}")
    log(f"[train] vgg11 step on one repeated batch: "
        f"{_determinism_text(det_ms)}")
    log(f"[train] vgg11: ANN accuracy {ann_acc:.4f}, SNN (radix T={T}, "
        f"fused) {out['fused']['snn_acc']:.4f} over "
        f"{v['eval_batches'] * v['eval_batch_size']} held-out images; "
        f"logits at T={T} vary across images: ttfs "
        f"{out['ttfs_varies']}, rate {out['rate_varies']}; "
        f"{out['phase_s']:.1f} s")


def phase_restart_drill(torch, np_, results) -> None:
    """LeNet-5's SGD-momentum step under ``RestartableRun``: a fault at
    step 9 of 17 (checkpoints every 4), resumed; the final state
    ``torch.equal`` to an uninterrupted run's.  cuDNN's deterministic
    algorithms for the drill's duration."""
    import tempfile

    from repro_torch.data import SyntheticVision
    from repro_torch.models import lenet
    from repro_torch.runtime import FaultInjected, RestartableRun
    from repro_torch.train import optim
    from repro_torch.train.trainer import TrainConfig, make_ann_step
    from repro_torch.train.tree import leaves, tree_map

    data = SyntheticVision()
    static, params, _ = lenet.make(np_.random.default_rng(SEED))
    cfg = TrainConfig(batch_size=LENET_TRAIN["batch_size"],
                      lr=LENET_TRAIN["lr"])
    opt = optim.sgd(cfg.lr, cfg.momentum, nesterov=True)
    step = make_ann_step(static, params, cfg, opt)

    def step_fn(state, batch):
        p, o, loss, _ = step(state["params"], state["opt"], *batch)
        return {"params": p, "opt": o}, float(loss)

    def batch_fn(s):
        xb, yb = data.batch(s, cfg.batch_size)
        return torch.from_numpy(xb).to(DEV), torch.from_numpy(yb).to(DEV)

    def fresh():
        p = [tree_map(lambda t: t.to(DEV), q) for q in params
             if q is not None]
        return {"params": p, "opt": opt.init(p)}

    r = RESTART
    before = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
            ref, _ = RestartableRun(step_fn, batch_fn, f"{tmp}/ref",
                                    ckpt_every=r["ckpt_every"]).run(
                fresh(), steps=r["steps"])
            run = RestartableRun(step_fn, batch_fn, f"{tmp}/crash",
                                 ckpt_every=r["ckpt_every"])
            try:
                run.run(fresh(), steps=r["steps"], fault_at=r["fault_at"])
                check(False, "restart drill: the fault was not raised")
            except FaultInjected:
                pass
            resumed, _ = run.run(fresh(), steps=r["steps"])
    finally:
        torch.backends.cudnn.deterministic = before
    equal = all(torch.equal(a, b) for a, b in zip(leaves(ref),
                                                  leaves(resumed)))
    check(equal, "restart drill: the resumed state differs from the "
          "uninterrupted run's")
    results.setdefault("training", {})["restart"] = dict(
        r, equal=equal, cudnn_deterministic=True)
    log(f"[train] restart drill: lenet5, {r['steps']} steps, checkpoints "
        f"every {r['ckpt_every']}, fault at step {r['fault_at']}, resumed: "
        "final state torch.equal to the uninterrupted run (cuDNN "
        "deterministic for the drill)")


def phase_train_lm(torch, results) -> None:
    """Gemma-2B at full width and depth in bf16: ``launch.train.train_loop``
    (adafactor) for 10 steps with a checkpoint every 5, the checkpoint
    equal to the state bit for bit, a second call resumed to 12; then
    ``make_train_step`` with adam on one repeated batch for 8 steps (the
    loss falls; step ms, tokens/s, peak memory, a profiled step); then the
    trained weights served through ``Accelerator.compile``: logits
    ``torch.equal`` to the plain path, launches of ``lm_launches``."""
    import tempfile

    from repro_torch import api
    from repro_torch.configs import gemma_2b
    from repro_torch.data import synthetic_tokens
    from repro_torch.launch import train as train_launch
    from repro_torch.lm import model
    from repro_torch.train import checkpoint, optim
    from repro_torch.train.tree import leaves

    t_phase = time.perf_counter()
    cfg, lt = gemma_2b.ARCH, LM_TRAIN
    out = dict(layers=cfg.n_layers, batch=lt["batch"], seq=lt["seq"])
    reset_peak(torch)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        kw = dict(batch_size=lt["batch"], seq_len=lt["seq"], lr=lt["lr"],
                  ckpt_dir=tmp, ckpt_every=lt["ckpt_every"], seed=SEED,
                  log=log, device=DEV)
        t0 = time.perf_counter()
        state, hist = train_launch.train_loop(cfg, steps=lt["steps"], **kw)
        out["loop_s"] = time.perf_counter() - t0
        out["loop_peak_gb"] = peak_gb(torch)
        check(checkpoint.latest_step(tmp) == lt["steps"],
              f"gemma_2b: latest checkpoint {checkpoint.latest_step(tmp)}")
        saved, _ = checkpoint.restore(tmp, lt["steps"], state)
        same = all(a.dtype == b.dtype and torch.equal(
            a.view(torch.int16) if a.dtype == torch.bfloat16 else a,
            b.view(torch.int16) if b.dtype == torch.bfloat16 else b)
            for a, b in zip(leaves(state), leaves(saved)))
        check(same, "gemma_2b: the restored checkpoint differs from the "
              "trained state")
        del state, saved
        empty_cache(torch)
        logged = []
        t0 = time.perf_counter()
        state, more = train_launch.train_loop(
            cfg, steps=lt["resume_to"],
            **dict(kw, log=lambda s: (logged.append(s), log(s))))
        out["resume_s"] = time.perf_counter() - t0
        check(logged[0] == f"[train] resumed from step {lt['steps']}"
              and len(more) == lt["resume_to"] - lt["steps"]
              and int(state["step"]) == lt["resume_to"],
              f"gemma_2b: resume: {logged[:1]}, {len(more)} steps")
        losses = hist + more
        check(all(math.isfinite(x) for x in losses),
              f"gemma_2b: non-finite losses {losses}")
        del state
    empty_cache(torch)
    out.update(adafactor_losses=losses, checkpoint_equal=same)
    log(f"[train] gemma_2b train_loop (adafactor, batch {lt['batch']} x "
        f"{lt['seq']}): losses {[round(x, 4) for x in losses]}; checkpoint "
        f"at step {lt['steps']} restored bit for bit; resumed to "
        f"{lt['resume_to']}; {out['loop_s']:.1f} s + {out['resume_s']:.1f} "
        f"s, peak {out['loop_peak_gb']:.2f} GB")

    # adam on one repeated batch: the step's time, memory and profile
    reset_peak(torch)
    params = model.init_params(
        torch.Generator(device=DEV).manual_seed(SEED), cfg)
    opt = optim.adam(lt["lr"])
    st = [{"params": params, "opt": opt.init(params),
           "step": torch.zeros((), dtype=torch.int32, device=DEV)}]
    del params
    step = model.make_train_step(cfg, opt)
    batch = {"tokens": torch.from_numpy(synthetic_tokens(
        0, lt["batch"], lt["seq"], cfg.vocab, seed=SEED)).to(DEV)}
    losses, times = [], []
    for _ in range(lt["adam_steps"]):
        t0 = time.perf_counter()
        st[0], m = step(st[0], batch)
        losses.append(float(m["loss"]))
        times.append((time.perf_counter() - t0) * 1e3)
    check(all(math.isfinite(x) for x in losses) and losses[-1] < losses[0],
          f"gemma_2b: adam losses on the repeated batch {losses}")
    step_ms = statistics.median(times[1:])
    out.update(adam_losses=losses, step_ms=step_ms, step_ms_all=times,
               tokens_per_s=lt["batch"] * lt["seq"] / step_ms * 1e3,
               peak_gb=peak_gb(torch))

    def one():
        st[0], _ = step(st[0], batch)

    out["profile"] = train_profile(torch, one, 1)
    out["determinism"] = determinism_cost(torch, one, 2)
    log(f"[train] gemma_2b adam step: {_determinism_text(out['determinism'])}")
    log(f"[train] gemma_2b make_train_step (adam, one repeated batch): "
        f"losses {[round(x, 4) for x in losses]}; step {step_ms:.1f} ms "
        f"(median of steps 2-{lt['adam_steps']}, host clock), "
        f"{out['tokens_per_s']:.0f} tokens/s, peak {out['peak_gb']:.2f} GB; "
        f"{_profile_text(out['profile'])}")

    # the trained weights through the kernels' path
    params = st[0]["params"]
    del st
    empty_cache(torch)
    serve_cfg = arch_cfg("gemma_2b", 0)
    mm, attn, _ = lm_launches(serve_cfg)
    exe = api.Accelerator(dataflow="fused", device=DEV).compile(
        (params, serve_cfg), (LM_BATCH, LM_MAX_LEN), buckets=(64,))
    n, s0, new = LM_TRAIN_REQUEST
    prompts = lm_prompts(torch, serve_cfg, n, s0, SEED + 160)
    r = serve_greedy(exe, prompts, new)
    want = {"radix_matmul": mm * new, "radix_decode_attn": attn * (new - 1),
            "radix_conv2d": 0, "spike_encode": 0}
    check(DEV != "cuda" or r["launches"] == want,
          f"gemma_2b trained: launches {r['launches']} != {want}")
    ref = plain_logits(model, exe.params,
                       dataclasses.replace(exe.cfg, use_kernel=False),
                       prompts, r["tokens"], exe._cache.bucket_for(s0))
    c = compare_logits(torch, r["logits"], ref)
    check(c["equal"], f"gemma_2b trained: logits differ from the plain "
          f"path {c}")
    out["served"] = dict(request=LM_TRAIN_REQUEST, launches=r["launches"],
                         comparison=c)
    del exe, params
    empty_cache(torch)
    out["phase_s"] = time.perf_counter() - t_phase
    results.setdefault("training", {})["gemma_2b"] = out
    log(f"[train] gemma_2b trained weights served fused at "
        f"({LM_BATCH}, {LM_MAX_LEN}), bucket 64: {n} x {s0} tokens + {new} "
        f"new, logits equal the plain path at every step, launches "
        f"{r['launches']}; phase {out['phase_s']:.1f} s")


def phase_training(torch, np_, results) -> None:
    """Phase 16: LeNet-5, VGG-11, the restart drill, Gemma-2B."""
    t0 = time.perf_counter()
    empty_cache(torch)
    if DEV == "cuda":
        log(f"[train] device memory allocated before phase 16: "
            f"{torch.cuda.memory_allocated() / 1e9:.3f} GB")
    (ROOT / "build").mkdir(exist_ok=True)      # checkpoints' temporary dirs
    phase_train_lenet(torch, np_, results)
    phase_train_vgg(torch, np_, results)
    empty_cache(torch)
    phase_restart_drill(torch, np_, results)
    phase_train_lm(torch, results)
    results["training"]["phase_s"] = time.perf_counter() - t0
    log(f"[train] phase 16: {results['training']['phase_s']:.1f} s")


# ---------------------------------------------------------------------------
# Phase 17: the device mesh, on a world of one rank (NCCL).
# ---------------------------------------------------------------------------

MESH_SERVE_REQUESTS = 16
# (arch, layers as in phase 13, the mesh dispatches it runs)
# (arch, layers as in phase 13, the mesh dispatches it runs: on (1, 1)
# the two give the same logits bit for bit)
MESH_MOE = (("kimi_k2_1t_a32b", 1, ("ep_psum", "ep_a2a")),
            ("grok_1_314b", 4, ("tp", "ep_psum")))
MESH_REQUEST = (8, 40, 4)      # (prompts, tokens, logits steps)
# bf16 at full width: the capacity combine rounds each gate product and
# sum to bf16, as the reference's _combine does (y_buf.dtype), where ref
# contracts in float32; the CPU parity test holds float32 at 1e-5
MESH_LAYER_BAR = 2e-2          # relative L2, one MoE layer, nothing dropped
# relative L2 of each prompt's logits at every step, for the prompts whose
# tokens the dispatch routed to the experts ref routes them to in every
# layer and step: past a MoE layer bf16 rounding can flip a near-tie of
# the next layer's random router, and a flipped route changes that
# prompt's result (attention never mixes prompts); flips are counted
MESH_LOGITS_BAR = 5e-2
MESH_TRAIN = dict(steps=3, batch_size=8, seq_len=512, lr=3e-3)


def start_world(torch, tmp: str):
    """A process group of one rank over NCCL (its store a file under
    ``tmp``) and the (1, 1) ('data', 'model') mesh over it."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_test_mesh

    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.FileStore(
        str(Path(tmp) / "store"), 1), rank=0, world_size=1)
    return make_test_mesh(data=1, model=1)


def rel_l2(torch, got, want) -> float:
    g, w = got.double(), want.double()
    return float(torch.linalg.vector_norm(g - w)
                 / torch.linalg.vector_norm(w))


def phase_mesh_cnn(torch, np_, run, hw, results) -> None:
    """(a) VGG-11 radix T = 4 fused, buckets (1, 8): ``compile`` with
    ``parallel`` None (phase 4's plan), 1 and 2 serve every request
    ``torch.equal`` to both oracles with equal plane counters;
    ``_compile_plan_impl(..., data_parallel=2)`` raises the reference's
    error on one card; a ``CNNServer(data_parallel=2)`` stream equal to
    the oracle; ``serve_cnn.main(... --data-parallel 2)``; with more than
    one card, k = device count, images/s."""
    from repro_torch import api
    from repro_torch.core import engine
    from repro_torch.launch import serve_cnn

    qnet, x, want = run["qnet"], run["x"], run["want"]
    check(torch.equal(api.oracle(qnet, x, mode="packed"), want),
          "mesh cnn: packed oracle != snn oracle")
    ndev = torch.cuda.device_count()
    out = dict(devices=ndev, plans={})
    ref = None
    for par in (None, 1, 2):
        exe = api.Accelerator(dataflow="fused", device=DEV).compile(
            qnet, hw, buckets=BUCKETS, parallel=par)
        rounds = serve_rounds(torch, exe, x, want, f"vgg11 parallel={par}")
        st = {k: rounds[1][k] for k in ("plane_passes_skipped",
                                        "plane_passes_total", "executions")}
        shards = [exe.plan_for(b).data_parallel for b in BUCKETS]
        check(shards == [math.gcd(b, min(par or ndev, ndev))
                         for b in BUCKETS],
              f"vgg11 parallel={par}: shards {shards}")
        ref = ref or st
        check(st == ref, f"vgg11 parallel={par}: counters {st} != {ref}")
        out["plans"][str(par)] = dict(shards=shards, **st)
    try:
        engine._compile_plan_impl(qnet, (8,) + tuple(hw), method="fused",
                                  device=DEV, data_parallel=ndev + 1)
        check(False, "data_parallel above the devices did not raise")
    except ValueError as e:
        want_msg = (f"data_parallel={ndev + 1} exceeds {ndev} visible "
                    "devices")
        check(str(e) == want_msg, f"mesh cnn: {e!r} != {want_msg!r}")
        out["error"] = str(e)
    server = serve_cnn.CNNServer(qnet, hw, buckets=BUCKETS,
                                 dataflow="fused", device=DEV,
                                 data_parallel=2)
    server.warmup()
    sizes = np_.random.default_rng(SEED + 17).integers(1, 5,
                                                       MESH_SERVE_REQUESTS)
    rng = np_.random.default_rng(SEED + 11)
    images = [rng.uniform(0, 1, (int(n),) + tuple(hw)).astype(np_.float32)
              for n in sizes]
    out["stream"] = serve_stream(
        torch, np_, server, serve_cnn.MicroBatchQueue(server), sizes,
        oracle_rows(torch, np_, api, qnet, images),
        "VGG-11 radix fused, data_parallel=2")
    cli = serve_cnn.main(CLI_ARGV + ["--data-parallel", "2"])
    check(cli["ok"] == cli["requests"] and cli["stats"]["failures"] == 0,
          f"serve_cnn.main --data-parallel 2: {cli['ok']} of "
          f"{cli['requests']}")
    out["cli_requests"] = cli["requests"]
    if ndev > 1:
        exe = api.Accelerator(dataflow="fused", device=DEV).compile(
            qnet, hw, buckets=(8 * ndev,), parallel=ndev)
        xb = x[:1].expand((8 * ndev,) + tuple(x.shape[1:])).contiguous()
        ms = host_ms(torch, lambda: exe(xb), reps=10)
        out["multi_card"] = dict(k=ndev, ms=ms,
                                 images_per_s=8 * ndev / ms * 1e3)
    results.setdefault("mesh", {})["cnn"] = out
    log(f"[mesh] vgg11 radix fused: parallel None / 1 / 2 serve "
        f"{REQUESTS} x 2 rounds equal to both oracles, plane counters "
        f"{ref} equal, shards per bucket "
        f"{[out['plans'][k]['shards'] for k in out['plans']]}; "
        f"data_parallel={ndev + 1}: {out['error']!r}; CNNServer "
        f"data_parallel=2 stream equal to the oracle; serve_cnn.main "
        f"--data-parallel 2: {cli['requests']} requests; {ndev} card(s)")


def moe_layer_check(torch, moe, lp, cfg, mesh, impl, cf, n, s_len) -> dict:
    """One MoE layer on seeded hidden states (n, s_len, d): the dispatch
    ``impl`` at capacity factor ``cf`` against ``ref``: relative L2, the
    (token, expert) entries dropped, and at decode (s_len 1) the device
    ms of the capacity buffers' expert products and of ``ref``'s dense
    ones."""
    gen = torch.Generator(device=DEV).manual_seed(SEED + 171)
    x = torch.randn((n, s_len, cfg.d_model), generator=gen, device=DEV).to(
        lp["w_gate"].dtype)
    c = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, impl=impl, capacity_factor=cf))
    with torch.inference_mode():
        want, _ = moe._moe_ref(x, lp, cfg)
        got, _ = moe.moe_ffn(x, lp, c, mesh, decode=s_len == 1)
        x2 = x.reshape(-1, cfg.d_model)
        gates, idx, _ = moe._router(x2, lp["router"], c.moe)
        cap = moe._capacity(x2.shape[0], c.moe)
        buf, meta = moe._dispatch(x2, idx, gates, 0, c.moe.num_experts, cap)
        row = dict(rel_l2=rel_l2(torch, got, want), cap=cap,
                   dropped=int((~meta[2]).sum()), entries=int(idx.numel()))
        if s_len == 1:
            row["expert_ms"] = device_ms(torch, lambda: moe._expert_ffn(
                buf, lp["w_gate"], lp["w_up"], lp["w_down"], c), None,
                reps=3)
            row["ref_expert_ms"] = device_ms(
                torch, lambda: moe.expert_outputs(x2, lp, cfg), None, reps=3)
    return row


class moe_trace:
    """Within the ``with`` block, each router call of ``moe`` appends its
    tokens' top-k expert sets to ``routes``, and each capacity dispatch
    adds its (token, expert) entries and the dropped ones to ``entries``
    and ``dropped`` (``moe._router`` and ``moe._dispatch`` wrapped, and
    restored after)."""

    def __init__(self, moe):
        self.moe = moe
        self.trace = dict(dropped=0, entries=0, routes=[])

    def __enter__(self):
        router, dispatch, trace = (self.moe._router, self.moe._dispatch,
                                   self.trace)

        def routed(x, wr, m):
            gates, idx, probs = router(x, wr, m)
            trace["routes"].append(idx.sort(-1).values)
            return gates, idx, probs

        def counted(x2, idx, gates, e_lo, e_hi, cap):
            buf, meta = dispatch(x2, idx, gates, e_lo, e_hi, cap)
            valid = (idx >= e_lo) & (idx < e_hi)
            trace["entries"] += int(valid.sum())
            trace["dropped"] += int(valid.sum()) - int(meta[2].sum())
            return buf, meta

        self.saved = (router, dispatch)
        self.moe._router, self.moe._dispatch = routed, counted
        return trace

    def __exit__(self, *exc):
        self.moe._router, self.moe._dispatch = self.saved


def route_flips(torch, a: list, b: list, prompts: int) -> tuple:
    """Two traces' router calls, in call order: (rows whose top-k expert
    sets differ, rows, a bool per prompt: any of its rows differed)."""
    flips, flipped = 0, torch.zeros(prompts, dtype=torch.bool, device=DEV)
    for x, y in zip(a, b):
        diff = (x != y).any(-1)
        flips += int(diff.sum())
        flipped |= diff.reshape(prompts, -1).any(-1)
    return flips, sum(x.shape[0] for x in a), flipped


def mesh_logits(torch, model, params, cfg, mesh, prompts, tokens) -> list:
    """Prefill of ``prompts``, then a decode step for each of ``tokens``'
    columns but the last (fed as given), every step's logits; over
    ``mesh``, or on one device for None."""
    n, s0 = prompts.shape
    with torch.inference_mode():
        lg, caches = model.prefill(params, {"tokens": torch.nn.functional.pad(
            prompts, (0, 1))}, cfg, mesh, max_len=s0 + tokens.shape[1])
        out = [lg]
        for i in range(tokens.shape[1] - 1):
            lg, caches = model.decode_step(params, caches, tokens[:, i:i + 1],
                                           s0 + i, cfg, mesh)
            out.append(lg)
    return out


def phase_mesh_moe(torch, mesh, name, layers, impls, results) -> None:
    """(b) A MoE arch at full width, phase 13's depth, radix T = 4 fused
    (routed experts exact), over the (1, 1) mesh through
    ``model.prefill`` / ``decode_step``: each named dispatch at capacity
    factor E / top_k (nothing can drop) within ``MESH_LAYER_BAR`` of
    ``ref`` on one layer and, end to end, ``MESH_LOGITS_BAR`` for each
    prompt every one of whose routes is ``ref``'s (flips counted);
    the two dispatches' logits equal bit for bit; at the config's own
    factor the entries dropped, the relative error, and the capacity
    buffers' expert products' device ms and share of a decode step
    beside ``ref``'s."""
    from repro_torch.lm import model, moe

    t0 = time.perf_counter()
    cfg = dataclasses.replace(arch_cfg(name, layers), quant="radix",
                              use_kernel=True, kernel_dataflow="fused")
    params, n_params = arch_params(torch, model, cfg)
    params = model.kmajor_params(model.radixify_params(params, cfg))
    lp = model.tree_map(lambda t: t[0], params["segments"][0][0]["ffn"])
    m = cfg.moe
    generous = m.num_experts / m.top_k
    n, s0, steps = MESH_REQUEST
    prompts = lm_prompts(torch, cfg, n, s0, SEED + 172)
    ref_cfg = dataclasses.replace(cfg, moe=dataclasses.replace(m, impl="ref"))
    feed = lm_prompts(torch, cfg, n, steps, SEED + 174)
    with moe_trace(moe) as ref_trace:
        want = mesh_logits(torch, model, params, ref_cfg, None, prompts,
                           feed)
    out = dict(layers=cfg.n_layers, params=n_params, cf_config=m.capacity_factor,
               cf_generous=generous, impls={})
    logits = {}
    for impl in impls:
        row = out["impls"][impl] = {}
        for tag, cf in (("generous", generous), ("config", m.capacity_factor)):
            c = dataclasses.replace(cfg, moe=dataclasses.replace(
                m, impl=impl, capacity_factor=cf))
            with moe_trace(moe) as trace:
                got = logits[impl, tag] = mesh_logits(
                    torch, model, params, c, mesh, prompts, feed)
            flips, rows, flipped = route_flips(
                torch, trace["routes"], ref_trace["routes"], n)
            kept = (~flipped).nonzero()[:, 0]
            r = row[tag] = dict(
                served_dropped=trace["dropped"],
                served_entries=trace["entries"],
                route_flips=flips, routed_rows=rows,
                prompts_flipped=int(flipped.sum()),
                logits_rel_l2=[rel_l2(torch, g, w) for g, w in zip(got, want)],
                unflipped_rel_l2=[rel_l2(torch, g[kept], w[kept]) if len(kept)
                                  else None for g, w in zip(got, want)],
                prefill=moe_layer_check(torch, moe, lp, cfg, mesh, impl, cf,
                                        n, s0),
                decode=moe_layer_check(torch, moe, lp, cfg, mesh, impl, cf,
                                       n, 1))
            if tag == "generous":
                check(r["prefill"]["dropped"] == r["decode"]["dropped"]
                      == r["served_dropped"] == 0
                      and max(r["prefill"]["rel_l2"], r["decode"]["rel_l2"])
                      <= MESH_LAYER_BAR
                      and len(kept) > 0
                      and max(r["unflipped_rel_l2"]) <= MESH_LOGITS_BAR
                      and all(bool(torch.isfinite(g).all()) for g in got),
                      f"{name} {impl} at capacity factor {cf}: {r}")
        with torch.inference_mode():
            c = dataclasses.replace(cfg, moe=dataclasses.replace(m, impl=impl))
            lg, caches = model.prefill(params, {"tokens": torch.nn.functional.pad(
                prompts, (0, 1))}, c, mesh, max_len=s0 + 1)
            row["decode_step_ms"] = device_ms(torch, lambda: model.decode_step(
                params, caches, feed[:, :1], s0, c, mesh), None, reps=3)
            lg, caches = model.prefill(params, {"tokens": torch.nn.functional.pad(
                prompts, (0, 1))}, ref_cfg, None, max_len=s0 + 1)
            row["ref_decode_step_ms"] = device_ms(
                torch, lambda: model.decode_step(params, caches, feed[:, :1],
                                                 s0, ref_cfg), None, reps=3)
            del caches
        dec = row["config"]["decode"]
        for key, ms in (("share", dec["expert_ms"]),
                        ("ref_share", dec["ref_expert_ms"])):
            step = row["decode_step_ms" if key == "share"
                       else "ref_decode_step_ms"]
            row[key] = (None if ms is None or not step
                        else cfg.n_layers * ms / step)
        gen = row["generous"]
        log(f"[mesh] {name} {impl} ({cfg.n_layers} layers): nothing dropped "
            f"at capacity factor {generous:g}, one layer within "
            f"{max(gen['prefill']['rel_l2'], gen['decode']['rel_l2']):.2e} "
            f"of ref; {gen['route_flips']} of {gen['routed_rows']} routes "
            f"flipped (in {gen['prompts_flipped']} of {n} prompts), the "
            f"other prompts' logits within "
            f"{max(gen['unflipped_rel_l2']):.2e}, all within "
            f"{max(gen['logits_rel_l2']):.2e}; "
            f"at the config's {m.capacity_factor:g}: the request dropped "
            f"{row['config']['served_dropped']} of "
            f"{row['config']['served_entries']} (token, expert) entries over "
            f"its layers and steps; on seeded states one layer dropped "
            f"{row['config']['prefill']['dropped']} of "
            f"{row['config']['prefill']['entries']} (prefill) and "
            f"{dec['dropped']} of {dec['entries']} (decode) entries, layer "
            f"error {row['config']['prefill']['rel_l2']:.3e} / "
            f"{dec['rel_l2']:.3e}, logits "
            f"{max(row['config']['logits_rel_l2']):.3e}; decode expert "
            f"products {dec['expert_ms']} ms a layer (cap {dec['cap']}) vs "
            f"ref's {dec['ref_expert_ms']} ms; decode step "
            f"{row['decode_step_ms']} ms device vs ref's "
            f"{row['ref_decode_step_ms']} ms; expert share "
            f"{row['share']} vs ref's {row['ref_share']}")
    if len(impls) == 2:
        same = all(torch.equal(a, b) for tag in ("generous", "config")
                   for a, b in zip(logits[impls[0], tag],
                                   logits[impls[1], tag]))
        check(same, f"{name}: {impls} differ on the (1, 1) mesh")
        out["impls_equal"] = same
    del params, lp, logits
    empty_cache(torch)
    out["phase_s"] = time.perf_counter() - t0
    results.setdefault("mesh", {})[name] = out


def phase_mesh_train(torch, mesh, results) -> None:
    """(c) Gemma-2B at full width and depth, bf16, batch 8 x 512:
    ``train_loop(cfg, mesh)`` for 3 adafactor steps with its state placed
    on the (1, 1) mesh, losses and weights ``torch.equal`` to the
    unsharded ``train_loop`` (both with deterministic kernels);
    ``reshard_checkpoint`` restores its checkpoint onto the mesh bit for
    bit; prefill and decode through ``prefill`` / ``decode_step(...,
    mesh)`` on the trained weights equal to the unsharded calls."""
    import tempfile

    from repro_torch.configs import gemma_2b
    from repro_torch.launch import train as train_launch
    from repro_torch.lm import model
    from repro_torch.parallel import sharding
    from repro_torch.runtime import elastic
    from repro_torch.train import optim
    from repro_torch.train.tree import leaves

    def bits(t):
        return t.view(torch.int16) if t.dtype == torch.bfloat16 else t

    t0 = time.perf_counter()
    cfg, mt = gemma_2b.ARCH, MESH_TRAIN
    kw = dict(steps=mt["steps"], batch_size=mt["batch_size"],
              seq_len=mt["seq_len"], lr=mt["lr"], seed=SEED, log=log)
    with saving_plain(torch, FSDP_TRAIN["steps"]):   # for phase 20
        plain, plain_losses = train_launch.train_loop(cfg, device=DEV, **kw)
    split = {"plain_train_s": time.perf_counter() - t0}
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        t1 = time.perf_counter()
        state, losses = train_launch.train_loop(cfg, mesh, ckpt_dir=tmp, **kw)
        split["mesh_train_s"] = time.perf_counter() - t1
        whole = sharding.gather(state)
        same = losses == plain_losses and all(
            torch.equal(bits(a), bits(b))
            for a, b in zip(leaves(whole), leaves(plain)))
        check(same, f"gemma_2b: train_loop over the mesh {losses} differs "
              f"from the unsharded {plain_losses}")
        t1 = time.perf_counter()
        restored, _ = elastic.reshard_checkpoint(
            tmp, mt["steps"], cfg, optim.adafactor(mt["lr"]), mesh)
        split["reshard_s"] = time.perf_counter() - t1
        back = all(torch.equal(bits(a.full_tensor()), bits(b))
                   for a, b in zip(leaves(restored), leaves(whole)))
        check(back, "gemma_2b: reshard_checkpoint differs from the state")
        del restored, whole
    n, s0, steps = MESH_REQUEST
    prompts = lm_prompts(torch, cfg, n, s0, SEED + 173)
    feed = lm_prompts(torch, cfg, n, steps, SEED + 175)
    want = mesh_logits(torch, model, plain["params"], cfg, None, prompts, feed)
    got = mesh_logits(torch, model, state["params"], cfg, mesh, prompts, feed)
    equal = all(torch.equal(a, b) for a, b in zip(got, want))
    check(equal, "gemma_2b: prefill/decode over the mesh differ from the "
          "unsharded calls")
    del plain, state
    empty_cache(torch)
    out = dict(losses=losses, train_equal=same, reshard_equal=back,
               serve_equal=equal, phase_s=time.perf_counter() - t0, **split)
    results.setdefault("mesh", {})["gemma_2b"] = out
    log(f"[mesh] gemma_2b train_loop over the (1, 1) mesh (adafactor, "
        f"batch {mt['batch_size']} x {mt['seq_len']}, {mt['steps']} steps): "
        f"losses {[round(x, 4) for x in losses]} and every weight "
        f"torch.equal to the unsharded run; reshard_checkpoint restores it "
        f"bit for bit; prefill + {steps - 1} decode steps over the mesh "
        f"torch.equal to the unsharded calls; {out['phase_s']:.1f} s ("
        + ", ".join(f"{k} {v:.1f}" for k, v in split.items()) + ")")


def phase_mesh(torch, np_, run, hw, results) -> None:
    """Phase 17: (a) CNN data parallel, (b) the MoE mesh dispatches, (c)
    mesh training and resharding, on a one-rank NCCL world that is
    destroyed at the end."""
    import tempfile

    import torch.distributed as dist

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        mesh = start_world(torch, tmp)
        try:
            phase_mesh_cnn(torch, np_, run, hw, results)
            for name, layers, impls in MESH_MOE:
                phase_mesh_moe(torch, mesh, name, layers, impls, results)
            phase_mesh_train(torch, mesh, results)
        finally:
            dist.destroy_process_group()
    results["mesh"]["phase_s"] = time.perf_counter() - t0
    log(f"[mesh] phase 17: {results['mesh']['phase_s']:.1f} s")


# ---------------------------------------------------------------------------
# Phase 18: GPipe stages, the op analysis and roofline, the dry run.
# ---------------------------------------------------------------------------

PIPE_MICRO = (4, 2, 512)       # GPipe (kernels): microbatches, rows, tokens
PIPE_GRAD_MICRO = (2, 1, 512)  # GPipe (bf16 exact): the gradient check
PIPE_DECODE_PROMPT = 200       # the analyzed decode step's prompt tokens
DRYRUN_ARGV = ["--arch", "gemma_2b", "--cell", "train_4k",
               "--cell", "decode_32k"]


def start_pipe_world(torch, tmp: str):
    """A process group of one rank (NCCL on the card, gloo off it; its
    store a file under ``tmp``) and the ('pod',) mesh of one stage."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh

    if DEV == "cuda":
        torch.cuda.set_device(0)
    dist.init_process_group("nccl" if DEV == "cuda" else "gloo",
                            store=dist.FileStore(str(Path(tmp) / "store"), 1),
                            rank=0, world_size=1)
    return make_mesh((1,), ("pod",))


def pipe_block(model, cfg, positions):
    """One decoder layer in the no-cache mode: GPipe's ``block_fn``."""
    def fn(lp, h):
        return model._apply_layer(h, lp, "attn", cfg, positions, "train")[0]
    return fn


def run_sequential(torch, block, stacked, x):
    """Every layer on each microbatch, one microbatch at a time."""
    from repro_torch.parallel.pipeline import unstack

    layers = unstack(stacked)
    outs = []
    for h in x:
        for lp in layers:
            h = block(lp, h)
        outs.append(h)
    return torch.stack(outs)


def phase_gpipe(torch, mesh, cfg, params, results) -> None:
    """(a) GPipe over the one-stage 'pod' mesh: Gemma-2B's layers at full
    width, radix T fused on the kernels, against the sequential loop;
    then the bf16 exact layers' gradients under deterministic kernels."""
    from repro_torch.lm import model
    from repro_torch.parallel.pipeline import gpipe
    from repro_torch.train.determinism import deterministic
    from repro_torch.train.tree import leaves, tree_map

    out = results["pipeline"]
    check(model.segments_for(cfg) == ((("attn",), cfg.n_layers),),
          "GPipe runs one homogeneous stack of attention layers")
    rcfg = dataclasses.replace(cfg, quant="radix", radix_steps=T,
                               use_kernel=True, kernel_dataflow="fused")
    stacked = model.kmajor_params(model.radixify_params(
        params, rcfg))["segments"][0][0]
    n_micro, rows, s_len = PIPE_MICRO
    gen = torch.Generator(device=DEV).manual_seed(SEED + 60)
    tokens = torch.randint(0, cfg.vocab, (n_micro, rows, s_len),
                           generator=gen, device=DEV)
    with torch.inference_mode():
        x = model._embed(params, tokens, cfg)
        block = pipe_block(model, rcfg, model._positions(
            rcfg, rows, s_len, device=DEV))
        pipe = gpipe(block, mesh, axis="pod")
        before = counters()["radix_matmul"]
        got = pipe(stacked, x)
        sync(torch)
        launched = counters()["radix_matmul"] - before
        want = run_sequential(torch, block, stacked, x)
        sync(torch)
    per_layer = sum(1 for k in ("w_gate", "w_up", "w_down")
                    if k in stacked["ffn"])
    check(launched == cfg.n_layers * n_micro * per_layer,
          f"GPipe launched {launched} radix_matmul, not "
          f"{cfg.n_layers} x {n_micro} x {per_layer}")
    check(tuple(got.shape) == tuple(x.shape)
          and bool(torch.isfinite(got).all()), "GPipe output shape/finite")
    check(torch.equal(got, want), "GPipe differs from the sequential loop: "
          f"max |diff| {float((got.float() - want.float()).abs().max())}")
    with torch.inference_mode():
        out["gpipe_host_ms"] = host_ms(torch, lambda: pipe(stacked, x),
                                       reps=3, warmup=1)
        out["seq_host_ms"] = host_ms(
            torch, lambda: run_sequential(torch, block, stacked, x), reps=3,
            warmup=1)
        out["gpipe_device_ms"] = device_ms(torch, lambda: pipe(stacked, x),
                                           None, reps=2)
        out["seq_device_ms"] = device_ms(
            torch, lambda: run_sequential(torch, block, stacked, x), None,
            reps=2)
    out["launches"] = launched
    log(f"[pipeline] GPipe, {cfg.n_layers} layers on 1 stage, {n_micro} "
        f"microbatches of {rows} x {s_len}: torch.equal to sequential, "
        f"{launched} radix_matmul launches; host ms {out['gpipe_host_ms']:.2f}"
        f" (sequential {out['seq_host_ms']:.2f}), device ms "
        f"{out['gpipe_device_ms']} (sequential {out['seq_device_ms']})")
    del stacked, x, got, want

    n_micro, rows, s_len = PIPE_GRAD_MICRO
    tokens = torch.randint(0, cfg.vocab, (n_micro, rows, s_len),
                           generator=gen, device=DEV)
    with torch.no_grad():
        x = model._embed(params, tokens, cfg)
    block = pipe_block(model, cfg, model._positions(cfg, rows, s_len,
                                                    device=DEV))
    layers = tree_map(lambda t: t.detach().requires_grad_(True),
                      params["segments"][0][0])
    with deterministic():
        got = gpipe(block, mesh, axis="pod")(layers, x)
        g_pipe = torch.autograd.grad(got.float().square().sum(),
                                     leaves(layers))
        want = run_sequential(torch, block, layers, x)
        g_seq = torch.autograd.grad(want.float().square().sum(),
                                    leaves(layers))
        sync(torch)
    check(torch.equal(got, want), "bf16 GPipe output differs from sequential")
    bad = [i for i, (a, b) in enumerate(zip(g_pipe, g_seq))
           if not torch.equal(a, b)]
    check(not bad, f"bf16 GPipe gradients differ from sequential at leaves "
          f"{bad}")
    check(all(bool(torch.isfinite(g).all()) for g in g_pipe),
          "GPipe gradients finite")
    out["grad_leaves_equal"] = len(g_pipe)
    log(f"[pipeline] bf16 exact, {n_micro} microbatches of {rows} x {s_len},"
        f" deterministic kernels: output and all {len(g_pipe)} gradient "
        "leaves of sum(out^2) torch.equal to sequential")


def roofline_row(torch, name, rep, dev_ms, results) -> None:
    row = dict(t_compute_ms=rep.t_compute * 1e3,
               t_memory_ms=rep.t_memory * 1e3, bottleneck=rep.bottleneck,
               step_time_lb_ms=rep.step_time_lb * 1e3,
               raw_flops=rep.raw_flops, device_flops=rep.device_flops,
               device_bytes=rep.device_bytes, device_ms=dev_ms,
               lb_over_device=(rep.step_time_lb * 1e3 / dev_ms
                               if dev_ms else None))
    results["pipeline"]["roofline"][name] = row
    log(f"[pipeline] roofline {name}: compute {row['t_compute_ms']:.4f} ms, "
        f"memory {row['t_memory_ms']:.4f} ms -> {rep.bottleneck}, "
        f"step_time_lb {row['step_time_lb_ms']:.4f} ms; flops "
        f"{rep.device_flops:.4g} (FlopCounterMode {rep.raw_flops:.4g}), "
        f"bytes {rep.device_bytes:.4g}; profiled device "
        + (f"{dev_ms:.4f} ms, lb / device {row['lb_over_device']:.3f}"
           if dev_ms else "ms not measured"))


def phase_roofline(torch, cnn_run, hw, vgg_calls, cfg, params,
                   results) -> None:
    """(b) ``op_analysis`` over one VGG-11 fused batch-8 plan call and one
    Gemma-2B fused decode step: the kernel notes equal the launches; the
    roofline rows beside the profiled device ms of the same call."""
    from repro_torch import api
    from repro_torch.launch import op_analysis
    from repro_torch.launch import roofline as RL

    exe = api.Accelerator(dataflow="fused", device=DEV).compile(
        cnn_run["qnet"], hw, buckets=(BATCH,))
    xb = cnn_run["x"][:BATCH]
    exe(xb)                                     # the plan, built
    before = counters()
    logits, cost = op_analysis.analyze(exe, xb)
    sync(torch)
    now = counters()
    for k in ("radix_conv2d", "radix_matmul"):
        check(cost.ops.get(k, 0) == now[k] - before[k] > 0,
              f"VGG-11 plan call: {cost.ops.get(k, 0)} {k} notes, "
              f"{now[k] - before[k]} launches")
    check(torch.equal(logits, exe(xb)), "VGG-11 logits under the analysis")
    rep = RL.roofline("vgg11", "plan_b8_fused", "1", 1, cost,
                      sum(2.0 * math.prod(c["mkn"]) for c in vgg_calls),
                      int8=True)
    roofline_row(torch, "vgg11_fused_b8", rep,
                 device_ms(torch, lambda: exe(xb), None, reps=3), results)
    del exe

    lcfg = dataclasses.replace(cfg, radix_steps=T, radix_kv_pack=True,
                               packed_attn=True)
    exe = api.Accelerator(dataflow="fused", device=DEV).compile(
        (params, lcfg), (LM_BATCH, LM_MAX_LEN), buckets=LM_BUCKETS)
    state = exe.prefill(lm_prompts(torch, lcfg, LM_BATCH,
                                   PIPE_DECODE_PROMPT, SEED + 61))
    tok = state["logits"].argmax(-1, keepdim=True)
    before = counters()
    nxt, cost = op_analysis.analyze(exe.decode, state, tok)
    sync(torch)
    now = counters()
    for k, want in (("radix_matmul", 3 * lcfg.n_layers),
                    ("radix_decode_attn", lcfg.n_layers)):
        check(cost.ops.get(k, 0) == now[k] - before[k] == want,
              f"Gemma-2B decode step: {cost.ops.get(k, 0)} {k} notes, "
              f"{now[k] - before[k]} launches, {want} expected")
    check(bool(torch.isfinite(nxt["logits"]).all()), "decode logits finite")
    rep = RL.roofline("gemma_2b", "decode_b8_s512", "1", 1, cost,
                      2.0 * lcfg.params_active() * LM_BATCH, int8=True)
    roofline_row(torch, "gemma_2b_fused_decode", rep,
                 device_ms(torch, lambda: exe.decode(state, tok), None,
                           reps=3), results)
    del exe, state


def dryrun_job() -> "CpuJob":
    """(c)'s subprocess: ``launch.dryrun`` on the CPU (its placeholder
    world cannot share a process with NCCL), two Gemma-2B cells on
    16 x 16."""
    return CpuJob("dryrun", ["-m", "repro_torch.launch.dryrun", *DRYRUN_ARGV,
                             "--out", str(ROOT / "build" /
                                          "dryrun_phase18.json")],
                  threads=1)


def phase_dryrun(results, job=None) -> None:
    """(c) the dry run's subprocess (``job``, started beside earlier
    phases, or started here): "2/2 cells OK" and its rows."""
    job = job or dryrun_job()
    rc, stdout, stderr = job.finish(600)
    for line in stdout.splitlines():
        log(f"[pipeline] {line.strip()}")
    check(rc == 0 and "[dryrun] 2/2 cells OK" in stdout,
          f"dry run exit {rc}: {stderr[-2000:]}")
    results["pipeline"]["dryrun_s"] = job.wall_s
    results["pipeline"]["dryrun_wait_s"] = job.wait_s
    log(f"[pipeline] dry run subprocess {job.wall_s:.1f} s, of which this "
        f"phase waited {job.wait_s:.1f} s")


def phase_pipeline(torch, cnn_run, hw, vgg_calls, results,
                   dryrun=None) -> None:
    """Phase 18: (a) GPipe, (b) the op analysis and roofline, on a
    one-rank world destroyed at the end; (c) the dry run (``dryrun``: its
    job, if started earlier)."""
    import tempfile

    import torch.distributed as dist

    from repro_torch.configs import gemma_2b
    from repro_torch.lm import model

    t0 = time.perf_counter()
    results["pipeline"] = {"roofline": {}}
    cfg = gemma_2b.ARCH
    params = model.init_params(
        torch.Generator(device=DEV).manual_seed(SEED), cfg, device=DEV)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        mesh = start_pipe_world(torch, tmp)
        try:
            phase_gpipe(torch, mesh, cfg, params, results)
        finally:
            dist.destroy_process_group()
    phase_roofline(torch, cnn_run, hw, vgg_calls, cfg, params, results)
    del params
    empty_cache(torch)
    phase_dryrun(results, dryrun)
    results["pipeline"]["phase_s"] = time.perf_counter() - t0
    log(f"[pipeline] phase 18: {results['pipeline']['phase_s']:.1f} s")


# ---------------------------------------------------------------------------
# Phase 19: tensor parallelism over 'model', 4 gloo ranks on one card.
# ---------------------------------------------------------------------------

TP_RANKS = 4
# (arch, layers (0: all), prompt tokens, decode steps); Gemma-7B is cut to
# 8 of its 28 layers to keep the phase within 60-150 s: 4 ranks each build
# the whole seeded tree before keeping their shards.  RecurrentGemma-2B's
# 10 query heads do not divide 4: its heads split head_dim, and each rank
# attends for its own 50 of the 200 prompt rows
TP_ARCHS = (("gemma_2b", 0, 200, 4), ("gemma_7b", 8, 64, 4),
            ("recurrentgemma_2b", 0, 200, 4))
TP_MAX_LEN = 512             # 128 slots a rank: 4 of the kernel's splits
TP_TIMEOUT_S = 900           # the world, every arch of TP_ARCHS


def tp_cfg(name: str, layers: int):
    """The arch at full width, radix T = 4 with ``radix_attn`` (every
    product integer), fused, packed KV and packed decode attention."""
    cfg = arch_cfg(name, layers)
    return dataclasses.replace(cfg, quant="radix", radix_attn=True,
                               use_kernel=True, kernel_dataflow="fused")


def tp_params(torch, model, cfg):
    """The seeded bf16 tree drawn on the card, radix-quantized, K-major."""
    params = model.init_params(
        torch.Generator(device=DEV).manual_seed(SEED), cfg)
    return model.kmajor_params(model.radixify_params(params, cfg))


def tp_generate(torch, model, params, cfg, tokens, s0: int, steps: int,
                mesh) -> tuple:
    """Prefill of ``tokens[:, :s0 + 1]`` and ``steps`` decode steps fed
    from ``tokens``: (every step's logits on the host, host ms of the
    prefill and of each step, the attention launch plans after each
    step)."""
    from repro_torch.kernels import radix_attn

    sync(torch)
    t0 = time.perf_counter()
    logits, caches = model.prefill(params, {"tokens": tokens[:, :s0 + 1]},
                                   cfg, mesh, max_len=TP_MAX_LEN)
    sync(torch)
    times = {"prefill_ms": (time.perf_counter() - t0) * 1e3,
             "decode_ms": []}
    out, plans = [logits.float().cpu()], []
    for i in range(steps):
        pos = s0 + i
        t0 = time.perf_counter()
        logits, caches = model.decode_step(params, caches,
                                           tokens[:, pos:pos + 1], pos, cfg,
                                           mesh)
        sync(torch)
        times["decode_ms"].append((time.perf_counter() - t0) * 1e3)
        out.append(logits.float().cpu())
        plans.append(len(radix_attn._plans))
    return out, times, plans


def tp_attn_layer(cfg):
    """(segment, block) of the first attention layer in ``cfg``'s
    ``segments`` and its block type."""
    from repro_torch.lm.config import segments_for

    for i, (pattern, _) in enumerate(segments_for(cfg)):
        for j, btype in enumerate(pattern):
            if btype in ("attn", "local_attn"):
                return i, j, btype
    raise ValueError(f"{cfg.name}: no attention layer")


def tp_layer_one_card(torch, model, cfg, params, s0: int) -> dict:
    """The first attention layer alone on one card: its weights (one slice
    of the stacked leaves of ``params``, radix levels as served), a seeded
    (batch, ``s0``, d) input and its output."""
    from repro_torch.lm import blocks

    i, j, btype = tp_attn_layer(cfg)
    lp = model.tree_map(lambda t: t[0], params["segments"][i][j]["mix"])
    gen = torch.Generator(device=DEV).manual_seed(SEED + 191)
    x = torch.randn((LM_BATCH, s0, cfg.d_model), generator=gen,
                    device=DEV).to(model._dt(cfg))
    pos = model._positions(cfg, LM_BATCH, s0, device=DEV)
    window = cfg.window if btype == "local_attn" else 0
    with torch.inference_mode():
        out = blocks.attention(x, lp, cfg, pos, window=window)
    return dict(x=x, pos=pos, window=window, want=out)


def tp_layer_check(torch, model, cfg, sharded, one: dict) -> dict:
    """The same layer on this rank's pieces over 'model', the sequence
    split (each rank's output rows gathered): equal to the one-card
    layer, else its relative L2 and max abs error."""
    from repro_torch.lm import blocks

    i, j, _ = tp_attn_layer(cfg)
    lp = model.tree_map(lambda t: t[0],
                        sharded.params["segments"][i][j]["mix"])
    tmix = sharded.tp.at("mix").with_seq(True)
    with torch.inference_mode():
        got = tmix.gather(blocks.attention(one["x"], lp, cfg, one["pos"],
                                           window=one["window"], tp=tmix), 1)
    want = one["want"]
    return dict(equal=torch.equal(got, want), rel_l2=rel_l2(torch, got, want),
                max_abs=float((got.float() - want.float()).abs().max()),
                rows=got.shape[1] // TP_RANKS)


@contextlib.contextmanager
def whole_attention():
    """Attention on the whole path under every split (each rank computing
    every query row, q gathered over head_dim), for the duration."""
    from repro_torch.lm import blocks

    rows_path = blocks._rows_path
    blocks._rows_path = lambda *a: False
    try:
        yield
    finally:
        blocks._rows_path = rows_path


def _tp_arch(torch, mesh, name: str, layers: int, s0: int,
             steps: int) -> dict:
    """One arch on a rank of phase 19's world: its shards of the seeded
    tree, then prefill and decode with the CUDA kernels; its logits,
    times and counters."""
    from repro_torch.lm import blocks, model

    cfg = tp_cfg(name, layers)
    params = tp_params(torch, model, cfg)
    # where the heads split head_dim: the first attention layer alone, on
    # one card and on the pieces
    one = (tp_layer_one_card(torch, model, cfg, params, s0)
           if cfg.n_heads % TP_RANKS else None)
    sharded = model.shard(params, cfg, mesh)
    del params
    empty_cache(torch)
    tokens = lm_prompts(torch, cfg, LM_BATCH, s0 + steps, SEED + 19)
    reset_peak(torch)
    reset_counters()
    rows0 = dict(blocks.ATTN_ROWS)
    out, times, plans = tp_generate(torch, model, sharded, cfg, tokens, s0,
                                    steps, mesh)
    res = dict(logits=out, times=times, plans=plans, launches=counters(),
               transposes=transposes(), peak_gb=peak_gb(torch),
               attn_rows={k: blocks.ATTN_ROWS[k] - rows0[k] for k in rows0})
    if one is not None:
        res["layer"] = tp_layer_check(torch, model, cfg, sharded, one)
        # the same run with every rank attending for every row
        with whole_attention():
            res["whole_path_logits"], _, _ = tp_generate(
                torch, model, sharded, cfg, tokens, s0, steps, mesh)
    return res


def _tp_rank(rank: int, store: str, out_dir: str, archs: tuple) -> None:
    """One rank of phase 19's world (a spawned process): gloo over a file
    store, cuda:0 shared, the (1, 4) ('data', 'model') mesh; each arch of
    ``archs`` in turn (:func:`_tp_arch`), its results written to
    ``out_dir``; the first failure ends the rank."""
    import datetime
    import traceback

    sys.path.insert(0, str(ROOT / "src"))
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    torch.cuda.set_device(0)
    dist.init_process_group(
        "gloo", store=dist.FileStore(store, TP_RANKS), rank=rank,
        world_size=TP_RANKS, timeout=datetime.timedelta(seconds=300))
    try:
        mesh = DeviceMesh("cuda", torch.arange(TP_RANKS).reshape(
            1, TP_RANKS), mesh_dim_names=("data", "model"))
        for name, layers, s0, steps in archs:
            try:
                res = _tp_arch(torch, mesh, name, layers, s0, steps)
            except BaseException:
                res = {"error": traceback.format_exc()}
            torch.save(res, str(Path(out_dir) / f"rank{rank}_{name}.pt"))
            failed = "error" in res
            del res
            empty_cache(torch)
            if failed:
                break
    finally:
        dist.destroy_process_group()


def tp_world(torch, archs: tuple, tmp: str) -> dict:
    """Spawn phase 19's 4 ranks once for every arch of ``archs`` and
    collect their results ({arch: the ranks' results in rank order}); a
    rank that failed or a world that hangs fails the phase, and every
    process is stopped."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_tp_rank, args=(
        r, str(Path(tmp) / "store"), tmp, archs)) for r in range(TP_RANKS)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + TP_TIMEOUT_S
    try:
        for p in procs:
            p.join(max(deadline - time.monotonic(), 1.0))
    finally:
        hung = [p for p in procs if p.is_alive()]
        for p in hung:
            p.kill()
            p.join(10)
    out = {}
    for name, *_ in archs:
        out[name] = []
        for r in range(TP_RANKS):
            f = Path(tmp) / f"rank{r}_{name}.pt"
            check(f.exists(), f"phase 19: rank {r} of {name} wrote nothing"
                  + (f" ({len(hung)} rank(s) hung)" if hung else ""))
            res = torch.load(str(f), weights_only=False)
            f.unlink()
            check("error" not in res, f"phase 19: rank {r} of {name} "
                  f"failed:\n{res.get('error')}")
            out[name].append(res)
    check(not hung, f"phase 19: {len(hung)} rank(s) hung")
    return out


def phase_tp_kernels(torch, results) -> None:
    """The kernel's partials mode against its plain version, and 4 ranks'
    partials over quarters of the slots merged against the one-card
    kernel, at Gemma-2B's decode shape (g = 8, hd = 256) and GLM4-9B's
    (g = 16, hd = 128), both dataflows; the masks leave whole quarters
    empty.  These launches compare kernels: counted on no path."""
    from repro_torch.kernels import radix_attn as ra

    gen = torch.Generator(device=DEV).manual_seed(SEED + 190)
    rows = []
    for case in (ATTN_DECODE, ATTN_G16):
        q, kq, ks, vq, vs, mask, _ = attn_problem(torch, case, gen)
        b, s_len, hkv = kq.shape[0], kq.shape[1], kq.shape[2]
        g, hd = case["g"], case["hd"]
        splits = (ra.split_slots(s_len), ra.MAX_SPLITS)
        quarter = s_len // TP_RANKS
        for method in ("fused", "bitserial"):
            kw = dict(num_steps=case["t"], method=method, packed=True,
                      splits=splits)
            plain = ra.radix_decode_attn_plain(q, kq, ks, vq, vs, mask,
                                               partials=True, **kw)
            # the caller's buffer (filled with NaN: every element written)
            part = ra.radix_decode_attn_cuda(
                q, kq, ks, vq, vs, mask, partials=True,
                out=torch.full_like(plain, float("nan")), **kw)
            parts = []
            for r in range(TP_RANKS):
                sl = slice(r * quarter, (r + 1) * quarter)
                parts.append(ra.radix_decode_attn_cuda(
                    q, kq[:, sl], ks[:, sl], vq[:, sl], vs[:, sl],
                    mask[:, sl], partials=True, **kw))
            merged = ra.merge_partials(parts, b * hkv, g, hd).reshape(
                b, hkv * g, hd)
            one = ra.radix_decode_attn_cuda(q, kq, ks, vq, vs, mask, **kw)
            empty = sum(int(not mask[i, r * quarter:(r + 1) * quarter].any())
                        for i in range(b) for r in range(TP_RANKS))
            row = dict(g=g, hd=hd, method=method,
                       partials_equal=torch.equal(part, plain),
                       merge_equal=torch.equal(merged, one),
                       merge_err=float((merged - one).abs().max()),
                       empty_quarters=empty)
            rows.append(row)
            check(row["partials_equal"], f"phase 19: partials {row}")
            check(row["merge_equal"] or row["merge_err"] <= 3e-5,
                  f"phase 19: the 4-rank merge {row}")
            log(f"[tp] attention g={g} hd={hd} {method}: partials equal to "
                f"the plain version {row['partials_equal']}; 4-rank merge "
                f"equal to the one-card kernel {row['merge_equal']} (max "
                f"abs err {row['merge_err']:.3g}; {empty} empty (row, "
                f"quarter) pairs)")
    results["tp"]["attention"] = rows


def phase_tp_nccl(torch, model, cfg, params, tokens, s0, steps, want,
                  results) -> dict:
    """(b) The same path on phase 17's one-rank NCCL world, (1, 1):
    logits ``torch.equal`` to the one-card run."""
    import tempfile

    import torch.distributed as dist

    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        mesh = start_world(torch, tmp)
        try:
            sharded = model.shard(params, cfg, mesh)
            got, times, _ = tp_generate(torch, model, sharded, cfg, tokens,
                                        s0, steps, mesh)
            del sharded
        finally:
            dist.destroy_process_group()
    equal = all(torch.equal(a, b) for a, b in zip(got, want))
    check(equal, "phase 19 (b): the one-rank NCCL world's logits differ "
          "from the one-card run")
    log(f"[tp] (b) one-rank NCCL world: logits equal to the one-card run "
        f"{equal}; prefill {times['prefill_ms']:.1f} ms, decode "
        f"{statistics.median(times['decode_ms']):.1f} ms a step")
    return dict(equal=equal, **times)


def phase_tp(torch, results) -> tuple:
    """Phase 19: (a) each arch of ``TP_ARCHS`` over 4 gloo ranks sharing
    the card against its one-card run; (b) Gemma-2B on a one-rank NCCL
    world; the kernel's partials mode and the 4-rank merge.  Returns (the
    path's launches, its per-call weight transposes): the spawned ranks'
    and (b)'s, counted from 0 just before each drives the path."""
    import tempfile

    from repro_torch.lm import model

    t0 = time.perf_counter()
    results["tp"] = {"archs": {}}
    phase_tp_kernels(torch, results)
    launches = {k: 0 for k in _wrappers()}
    copies = {k: 0 for k in transposes()}
    ones = {}
    for name, layers, s0, steps in TP_ARCHS:
        cfg = tp_cfg(name, layers)
        t1 = time.perf_counter()
        params = tp_params(torch, model, cfg)
        tokens = lm_prompts(torch, cfg, LM_BATCH, s0 + steps, SEED + 19)
        want, one_times, _ = tp_generate(torch, model, params, cfg, tokens,
                                         s0, steps, None)
        row = dict(layers=cfg.n_layers, prompt=s0, steps=steps,
                   one_card=one_times)
        if name == "gemma_2b":
            reset_counters()
            row["nccl_1x1"] = phase_tp_nccl(torch, model, cfg, params,
                                            tokens, s0, steps, want, results)
            for k, v in counters().items():
                launches[k] += v
            for k, v in transposes().items():
                copies[k] += v
        del params, tokens
        empty_cache(torch)
        row["one_card_s"] = time.perf_counter() - t1
        ones[name] = cfg, want, row
    t1 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        worlds = tp_world(torch, TP_ARCHS, tmp)
    results["tp"]["world_s"] = time.perf_counter() - t1
    for name, layers, s0, steps in TP_ARCHS:
        cfg, want, row = ones[name]
        ranks = worlds[name]
        # RG-LRU's products are float (bf16) and split over 'model': the
        # ranks sum them in another order, and at T = 4 the model
        # amplifies any float order (a level at a rounding boundary flips)
        float_split = "rglru" in cfg.layer_types
        for res in ranks:
            for k, v in res["launches"].items():
                launches[k] += v
            for k, v in res["transposes"].items():
                copies[k] += v
        same = [all(torch.equal(a, b) for a, b in zip(res["logits"], want))
                for res in ranks]
        errs = [max(rel_l2(torch, a, b) for a, b in zip(res["logits"], want))
                for res in ranks]
        steady = all(res["plans"][-1] == res["plans"][0] for res in ranks)
        row.update(
            equal=all(same), max_rel_l2=max(errs), steady_plans=steady,
            prefill_ms=[r["times"]["prefill_ms"] for r in ranks],
            decode_ms=[statistics.median(r["times"]["decode_ms"])
                       for r in ranks],
            launches=ranks[0]["launches"],
            peak_gb=[r["peak_gb"] for r in ranks])
        results["tp"]["archs"][name] = row
        agree = statistics.mean(
            float((a.argmax(-1) == b.argmax(-1)).float().mean())
            for a, b in zip(ranks[0]["logits"], want))
        row.update(greedy_agreement=agree)
        if float_split:
            # held against the same ranks' run on the whole attention path
            # and by the layer alone below; the distance from one card is
            # reported
            log(f"[tp] (a) {name}: logits {max(errs):.3g} relative L2 from "
                "the one-card run (RG-LRU's bf16 products split over 'model'"
                " sum in another order, which T = 4 amplifies), greedy "
                f"agreement {agree:.3f}")
            whole_same = [all(torch.equal(a, b) for a, b in
                              zip(res["logits"], res["whole_path_logits"]))
                          for res in ranks]
            whole_err = max(rel_l2(torch, a, b) for res in ranks for a, b in
                            zip(res["logits"], res["whole_path_logits"]))
            row.update(whole_path_equal=all(whole_same),
                       whole_path_rel_l2=whole_err)
            check(all(whole_same) or whole_err <= 1e-2,
                  f"phase 19: {name}: the rows path's logits {whole_err} "
                  "relative L2 from the same ranks' whole path")
            log(f"[tp] (a) {name}: the ranks' logits on the rows path "
                f"torch.equal to theirs on the whole attention path (every "
                f"rank every row) {all(whole_same)} (max rel L2 "
                f"{whole_err:.3g}; the bar that held: "
                f"{'torch.equal' if all(whole_same) else '1e-2 relative L2'})")
            for r, res in enumerate(ranks):
                lay = res["layer"]
                check(all(bool(torch.isfinite(x).all())
                          for x in res["logits"]),
                      f"phase 19: {name} rank {r}: non-finite logits")
                check(lay["equal"] or lay["rel_l2"] <= 1e-2,
                      f"phase 19: {name} rank {r}: the attention layer on "
                      f"the pieces {lay} from the one-card layer")
            lay = ranks[0]["layer"]
            row["layer"] = [res["layer"] for res in ranks]
            log(f"[tp] (a) {name}: its first attention layer alone, "
                f"{lay['rows']} query rows a rank, torch.equal to the "
                f"one-card layer {lay['equal']} (relative L2 "
                f"{lay['rel_l2']:.3g}, max abs {lay['max_abs']:.3g}; the bar "
                f"that held: "
                f"{'torch.equal' if lay['equal'] else '1e-2 relative L2'})")
        else:
            check(all(same) or max(errs) <= 1e-2,
                  f"phase 19: {name} over {TP_RANKS} ranks, logits rel L2 "
                  f"{errs} from the one-card run")
        # the heads split head_dim where they do not divide 'model': each
        # rank attends for its own s0 / TP_RANKS prompt rows
        n_attn = lm_launches(cfg)[1]
        path = "rows" if cfg.n_heads % TP_RANKS else "whole"
        per_layer = s0 // TP_RANKS if path == "rows" else s0
        row["attn_rows"] = [r["attn_rows"] for r in ranks]
        for r, res in enumerate(ranks):
            seen = res["attn_rows"]
            check(seen[path + "_calls"] == n_attn
                  and seen[path] == n_attn * per_layer
                  and seen["rows_calls" if path == "whole"
                           else "whole_calls"] == 0,
                  f"phase 19: {name} rank {r}: prefill attention {seen}, "
                  f"want {n_attn} {path} calls of {per_layer} rows")
            log(f"[tp] (a) {name} rank {r}: prefill attention on the "
                f"{path} path, {seen[path] // n_attn} query rows a layer "
                f"over {n_attn} attention layers; peak "
                f"{res['peak_gb']:.2f} GB")
        check(steady, f"phase 19: {name}: attention plans built in steady "
              f"state {[r['plans'] for r in ranks]}")
        check(ranks[0]["launches"]["radix_matmul"] > 0
              and ranks[0]["launches"]["radix_decode_attn"] > 0,
              f"phase 19: {name}: a kernel was not launched on a rank "
              f"{ranks[0]['launches']}")
        held = ("torch.equal" if all(same) else "1e-2 relative L2"
                if not float_split else "against the whole attention path "
                "and the layer alone")
        log(f"[tp] (a) {name} {cfg.n_layers} layers over {TP_RANKS} gloo "
            f"ranks on one card: logits torch.equal to the one-card run "
            f"{all(same)} (max rel L2 {max(errs):.3g}; the bar that held: "
            f"{held}); launches a rank "
            f"{ranks[0]['launches']}; prefill of {s0} tokens "
            f"{statistics.median(row['prefill_ms']):.1f} ms and decode "
            f"{statistics.median(row['decode_ms']):.1f} ms a step (host "
            f"wall; gloo moves every collective through the host, so these "
            f"say nothing of NCCL across cards) against one card's "
            f"{row['one_card']['prefill_ms']:.1f} / "
            f"{statistics.median(row['one_card']['decode_ms']):.1f} ms; peak "
            f"{max(row['peak_gb']):.2f} GB a rank; one-card runs "
            f"{row['one_card_s']:.1f} s")
    results["tp"]["phase_s"] = time.perf_counter() - t0
    log(f"[tp] phase 19: {results['tp']['phase_s']:.1f} s (the 4 ranks' "
        f"world, every arch: {results['tp']['world_s']:.1f} s)")
    return launches, copies


# ---------------------------------------------------------------------------
# Phase 20: ZeRO-3 over the data axes in the sharded train step.
# ---------------------------------------------------------------------------

FSDP_RANKS = 4
FSDP_MESH = (2, 2)            # ('data', 'model')
# phase 17's MESH_TRAIN at 2 of its 3 steps: with 3 the script ran
# 1135.4 s of its 1200 on the H100, each step over gloo ~26-33 s
FSDP_TRAIN = dict(MESH_TRAIN, steps=2)
FSDP_TIMEOUT_S = 900
# the unsharded run's weights after FSDP_TRAIN's steps: phase 17 saves
# them from its own unsharded run; phase 20 run alone trains one
FSDP_PLAIN = ROOT / "build" / "fsdp_plain.pt"
FSDP_LOSS_BAR = 5e-4          # relative, the CPU tests' bar
# relative L2 of the whole trained tree against the unsharded run's: the
# gradients' float order differs (rank-order sums of partial gradients
# against one GEMM over the batch), and adafactor steps at lr 3e-3
# round each weight to bf16 after an update of ~14% of its scale (4.68e-3
# measured); the embedding, 128000 x 2048, weighs most in it
FSDP_WEIGHT_BAR = 1e-2
# each leaf's relative L2 against the unsharded run's, between the sound
# run's worst leaf (a stacked norm, 3.06e-2) and what a fault in the
# gradient of a leaf whole over 'data' gives (``fsdp_copy``'s backward
# planted as the identity: ln1 0.580, ln2 0.201, the final norm 0.057,
# while the losses and the whole tree stay within their bars)
FSDP_LEAF_BAR = 0.1
CHUNK = 1 << 26               # elements a weight comparison takes at once


def save_plain(torch, params) -> None:
    """Keep an unsharded run's weights on the host, in ``FSDP_PLAIN``
    (which phase 20's rank 0 maps)."""
    from repro_torch.train.tree import tree_map

    FSDP_PLAIN.parent.mkdir(exist_ok=True)
    torch.save(tree_map(lambda t: t.cpu(), params), str(FSDP_PLAIN))


@contextlib.contextmanager
def saving_plain(torch, steps: int):
    """Within the block, the unsharded train step's weights after its
    ``steps``-th call are saved (``save_plain``): phase 17's unsharded
    run hands phase 20 its weights after ``FSDP_TRAIN``'s steps."""
    from repro_torch.lm import model

    make = model.make_train_step

    def make_train_step(*a, **k):
        step, calls = make(*a, **k), [0]

        def saving(state, batch):
            out = step(state, batch)
            calls[0] += 1
            if calls[0] == steps:
                save_plain(torch, out[0]["params"])
            return out
        return saving

    model.make_train_step = make_train_step
    try:
        yield
    finally:
        model.make_train_step = make


def fsdp_cfg(smoke: bool):
    from repro_torch.configs import gemma_2b

    return gemma_2b.SMOKE if smoke else gemma_2b.ARCH


def _nbytes(torch, tree) -> int:
    from repro_torch.train.tree import leaves

    return sum(t.numel() * t.element_size() for t in leaves(tree)
               if torch.is_tensor(t))


def watch_step(torch) -> dict:
    """Wrap the train step's entry points of this process's
    ``repro_torch`` to record, per step, its host ms (ended by a
    synchronize), the bytes ``tp.shard_params`` hands it and the
    gradients' bytes at the clip.  Returns the record."""
    from repro_torch.lm import model
    from repro_torch.parallel import tp as tp_lib

    seen = {"step_ms": [], "pieces_bytes": 0, "grads_bytes": 0,
            "gather_max_bytes": 0, "layer_leaf_max_bytes": 0,
            "layer_gathered_bytes": 0}
    make, shard = model.make_train_step, tp_lib.shard_params
    clip = model.optim_lib.clip_by_global_norm

    def make_train_step(*a, **k):
        step = make(*a, **k)

        def timed(state, batch):
            sync(torch)
            t0 = time.perf_counter()
            out = step(state, batch)
            float(out[1]["loss"])
            sync(torch)
            seen["step_ms"].append((time.perf_counter() - t0) * 1e3)
            return out
        return timed

    def shard_params(*a, **k):
        out = shard(*a, **k)
        seen["pieces_bytes"] = max(seen["pieces_bytes"],
                                   _nbytes(torch, out[0]))
        return out

    def clip_by_global_norm(grads, *a, **k):
        seen["grads_bytes"] = max(seen["grads_bytes"], _nbytes(torch, grads))
        return clip(grads, *a, **k)

    model.make_train_step, tp_lib.shard_params = make_train_step, shard_params
    model.optim_lib.clip_by_global_norm = clip_by_global_norm
    return seen


def fsdp_watch(torch, mesh) -> dict:
    """``watch_step``'s record, and also every gather over the data axes
    (``collectives.fsdp_gather``) and each layer's (``TP.over_data``).
    ``mesh`` is the rank's (unused here: a watch given to ``fsdp_world``
    may stage collectives on it)."""
    from repro_torch.parallel import collectives as C
    from repro_torch.parallel import tp as tp_lib
    from repro_torch.train.tree import leaves_with_paths

    seen = watch_step(torch)
    gather, over = C.fsdp_gather, tp_lib.TP.over_data

    def fsdp_gather(x, *a, **k):
        out = gather(x, *a, **k)
        seen["gather_max_bytes"] = max(seen["gather_max_bytes"],
                                       out.numel() * out.element_size())
        return out

    def over_data(self, tree, *prefix, layer=False):
        out = over(self, tree, *prefix, layer=layer)
        if layer and self.data:
            got = [t.numel() * t.element_size()
                   for p, t in leaves_with_paths(out)
                   if tuple(prefix) + p in self.data]
            seen["layer_gathered_bytes"] = max(seen["layer_gathered_bytes"],
                                               sum(got))
            seen["layer_leaf_max_bytes"] = max(seen["layer_leaf_max_bytes"],
                                               max(got, default=0))
        return out

    C.fsdp_gather, tp_lib.TP.over_data = fsdp_gather, over_data
    return seen


def whole_leaf(leaf):
    """A DTensor leaf joined whole on every rank by the port's
    ``collectives.gather_from`` (through the host on gloo: DTensor's own
    collectives on CUDA tensors over gloo crash the process)."""
    from repro_torch.parallel import collectives as C
    from repro_torch.parallel import sharding as SH

    full = leaf.to_local()
    for d, e in enumerate(SH.spec_of(leaf)):
        if e is not None:
            full = C.gather_from(full, d, leaf.device_mesh,
                                 SH.entry_axes(e))
    return full


def fsdp_weights(torch, state_params, plain_params, rank: int) -> dict:
    """Every trained leaf gathered whole (all ranks join each gather) and
    held on rank 0 against the unsharded run's: the whole tree's relative
    L2, each leaf's (by its path) and the worst leaf's."""
    from repro_torch.train.tree import leaves, leaves_with_paths

    num = den = 0.0
    per = {}
    wants = leaves(plain_params) if rank == 0 else None
    for i, (path, leaf) in enumerate(leaves_with_paths(state_params)):
        full = whole_leaf(leaf)
        if rank != 0:
            continue
        a, b = full.reshape(-1), wants[i].reshape(-1)
        ln = ld = 0.0
        for j in range(0, a.numel(), CHUNK):
            x = a[j:j + CHUNK].double()
            y = b[j:j + CHUNK].to(x.device).double()
            ln += float(torch.sum((x - y) ** 2))
            ld += float(torch.sum(y ** 2))
        num, den = num + ln, den + ld
        per["/".join(map(str, path))] = math.sqrt(ln / max(ld, 1e-30))
        del full
    worst = max(per, key=per.get) if per else None
    return {"rel_l2": math.sqrt(num / max(den, 1e-30)), "leaves": per,
            "worst_name": worst, "worst_leaf": per.get(worst, 0.0)}


def _fsdp_rank(rank: int, store: str, out_dir: str, src: str, dev: str,
               smoke: bool, plain_path, watch) -> None:
    """One rank of phase 20's world (a spawned process): gloo over a file
    store, ``dev`` shared ("cuda": cuda:0), the ``FSDP_MESH`` ('data',
    'model') mesh, ``train_loop`` over it with ``repro_torch`` from
    ``src``, recorded by ``watch(torch, mesh)`` (``fsdp_watch``); rank 0
    also holds the trained weights against ``plain_path``'s (None: not).
    Writes its record to ``out_dir``."""
    import datetime
    import faulthandler
    import traceback

    global DEV
    DEV = dev
    # a rank that dies outside Python (a signal) leaves its trace here
    trail = open(Path(out_dir) / f"rank{rank}.log", "a", buffering=1)
    faulthandler.enable(file=trail)
    trail.write(f"start pid {os.getpid()}\n")
    sys.path.insert(0, src)
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    res = {}
    try:
        if dev == "cuda":
            torch.cuda.set_device(0)
        dist.init_process_group(
            "gloo", store=dist.FileStore(store, FSDP_RANKS), rank=rank,
            world_size=FSDP_RANKS,
            timeout=datetime.timedelta(seconds=FSDP_TIMEOUT_S))
        trail.write("joined the world\n")
        from repro_torch.launch import dryrun
        from repro_torch.launch import train as train_launch

        mesh = DeviceMesh(dev, torch.arange(FSDP_RANKS).reshape(FSDP_MESH),
                          mesh_dim_names=("data", "model"))
        seen = watch(torch, mesh)
        cfg = fsdp_cfg(smoke)
        reset_peak(torch)
        t0 = time.perf_counter()
        state, losses = train_launch.train_loop(
            cfg, mesh, seed=SEED, log=lambda line: trail.write(line + "\n"),
            **FSDP_TRAIN)
        trail.write(f"trained {losses}\n")
        res = dict(seen, losses=losses, peak_gb=peak_gb(torch),
                   train_s=time.perf_counter() - t0,
                   params_bytes=dryrun.local_bytes(state["params"]),
                   opt_bytes=dryrun.local_bytes(state["opt"]),
                   src=src)
        if plain_path is not None:
            t0 = time.perf_counter()
            plain = (torch.load(plain_path, mmap=True, weights_only=False)
                     if rank == 0 else None)
            res["weights"] = fsdp_weights(torch, state["params"], plain,
                                          rank)
            res["weights_s"] = time.perf_counter() - t0
    except BaseException:
        res = {"error": traceback.format_exc(), "peak_gb": peak_gb(torch)}
    finally:
        trail.write(f"writing {sorted(res)}\n")
        torch.save(res, str(Path(out_dir) / f"rank{rank}.pt"))
        if dist.is_initialized():
            dist.destroy_process_group()
        trail.close()


def fsdp_world(torch, tmp: str, src: str, dev: str, smoke: bool,
               plain_path, watch=fsdp_watch) -> list:
    """Spawn phase 20's 4 ranks (``watch``: a module-level function, as
    ``_fsdp_rank`` takes it) and collect their records (in rank order; a
    rank that raised gives its traceback as "error" and its peak GB); a
    rank that wrote nothing or a world that hangs fails the phase, and
    every process is stopped."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_fsdp_rank, args=(
        r, str(Path(tmp) / "fsdp.store"), tmp, src, dev, smoke,
        None if plain_path is None else str(plain_path), watch))
        for r in range(FSDP_RANKS)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + FSDP_TIMEOUT_S
    try:
        for p in procs:
            p.join(max(deadline - time.monotonic(), 1.0))
    finally:
        hung = [p for p in procs if p.is_alive()]
        for p in hung:
            p.kill()
            p.join(10)
    trails = {r: (Path(tmp) / f"rank{r}.log").read_text()
              if (Path(tmp) / f"rank{r}.log").exists() else "(none)"
              for r in range(FSDP_RANKS)}
    why = (f"exit codes {[p.exitcode for p in procs]}; each rank's trail: "
           + "; ".join(f"rank {r}: {t[-2000:]}" for r, t in trails.items()))
    check(not hung, f"phase 20: {len(hung)} rank(s) hung; {why}")
    out = []
    for r in range(FSDP_RANKS):
        f = Path(tmp) / f"rank{r}.pt"
        check(f.exists(), f"phase 20: rank {r} wrote nothing; {why}")
        out.append(torch.load(str(f), weights_only=False))
    return out


def fsdp_rank_line(r: int, res: dict) -> str:
    gb = 1e9
    return (f"rank {r}: peak {res['peak_gb']:.2f} GB; host ms a step "
            f"{[round(x, 1) for x in res['step_ms']]}; the step's pieces "
            f"{res['pieces_bytes'] / gb:.3f} GB; largest gather over the "
            f"data axes {res['gather_max_bytes'] / 1e6:.1f} MB (a layer's "
            f"largest leaf {res['layer_leaf_max_bytes'] / 1e6:.1f} MB, a "
            f"layer's leaves {res['layer_gathered_bytes'] / 1e6:.1f} MB); "
            f"held between steps: parameters "
            f"{res['params_bytes'] / gb:.3f} GB, optimizer state "
            f"{res['opt_bytes'] / gb:.4f} GB; gradients at the clip "
            f"{res['grads_bytes'] / gb:.3f} GB")


def phase_fsdp(torch, results, smoke: bool = False) -> None:
    """Phase 20: Gemma-2B trained over the (2, 2) mesh by 4 gloo ranks
    sharing the card, against the unsharded run of ``FSDP_TRAIN``'s
    steps: phase 17's (its losses, and its weights in ``FSDP_PLAIN``)
    where phase 17 ran, else one this phase trains."""
    import tempfile

    from repro_torch.launch import train as train_launch

    t0 = time.perf_counter()
    p17 = results.get("mesh", {}).get("gemma_2b", {}).get("losses")
    if p17 is not None and FSDP_PLAIN.exists():
        want, whence = p17[:FSDP_TRAIN["steps"]], "phase 17's"
    else:
        plain, want = train_launch.train_loop(
            fsdp_cfg(smoke), device=DEV, seed=SEED, log=lambda line: None,
            **FSDP_TRAIN)
        save_plain(torch, plain["params"])
        whence = "this phase's"
        del plain
    empty_cache(torch)            # the ranks share the card
    split = {"plain_s": time.perf_counter() - t0}
    t1 = time.perf_counter()
    try:
        with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
            ranks = fsdp_world(torch, tmp, str(ROOT / "src"), DEV, smoke,
                               FSDP_PLAIN)
    finally:
        FSDP_PLAIN.unlink(missing_ok=True)
    errors = "\n".join(f"rank {r}: {res['error']}"
                       for r, res in enumerate(ranks) if "error" in res)
    check(not errors, f"phase 20: ranks failed:\n{errors}")
    split.update(world_s=time.perf_counter() - t1,
                 train_s=ranks[0]["train_s"],
                 weights_s=ranks[0]["weights_s"])
    losses = ranks[0]["losses"]
    check(all(r["losses"] == losses for r in ranks),
          f"phase 20: the ranks' losses differ {[r['losses'] for r in ranks]}")
    check(len(losses) == len(want) and all(
        abs(a - b) <= FSDP_LOSS_BAR * max(1.0, abs(b))
        for a, b in zip(losses, want)),
        f"phase 20: losses {losses} against the unsharded {want}")
    w = ranks[0]["weights"]
    check(w["rel_l2"] <= FSDP_WEIGHT_BAR and w["worst_leaf"] <= FSDP_LEAF_BAR,
          f"phase 20: trained weights {w} from the unsharded run's (bars "
          f"{FSDP_WEIGHT_BAR} the tree, {FSDP_LEAF_BAR} a leaf)")
    out = dict(losses=losses, plain_losses=want, plain_from=whence,
               weights=w,
               ranks=[{k: v for k, v in r.items() if k != "src"}
                      for r in ranks],
               phase_s=time.perf_counter() - t0, **split)
    results["fsdp"] = out
    mt = FSDP_TRAIN
    log(f"[fsdp] gemma_2b {fsdp_cfg(smoke).n_layers} layers, train_loop "
        f"over the {FSDP_MESH} ('data', 'model') mesh by {FSDP_RANKS} gloo "
        f"ranks on one card (adafactor, batch {mt['batch_size']} x "
        f"{mt['seq_len']}, {mt['steps']} steps): losses "
        f"{[round(x, 5) for x in losses]} against {whence} unsharded "
        f"{[round(x, 5) for x in want]} (bar {FSDP_LOSS_BAR} relative), "
        f"every rank the same; trained weights rel L2 {w['rel_l2']:.3g} "
        f"(bar {FSDP_WEIGHT_BAR}), worst leaf {w['worst_name']} "
        f"{w['worst_leaf']:.3g} (bar {FSDP_LEAF_BAR}); each leaf: "
        + ", ".join(f"{k} {v:.3g}" for k, v in w["leaves"].items()))
    for r, res in enumerate(ranks):
        log(f"[fsdp] {fsdp_rank_line(r, res)}")
    log(f"[fsdp] phase 20: {out['phase_s']:.1f} s ("
        + ", ".join(f"{k} {v:.1f}" for k, v in split.items())
        + "; gloo moves every collective through the host: these times "
        "say nothing of NCCL)")


def main() -> int:
    # phase 16's Adam step on Gemma-2B holds ~65 GB (bf16 weights, float32
    # moments, their successors, clipped gradients and updates): without
    # expandable segments the allocator's free blocks fragment past 80 GB
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    # training's deterministic kernels (train.determinism) need cuBLAS's
    # workspace fixed; set it before the first cuBLAS call of the process
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
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
    load_hw()
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
    mesh_run = dict(tune_run)
    pipe_run = dict(tune_run)
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
    plane_cases = {}
    qnets = phase_encodings(torch, np, results, plane_cases)
    paths["cnn_encodings"] = counters()
    copies["cnn_encodings"] = transposes()
    log(f"[enc] phase 9: {time.perf_counter() - t0:.1f} s (its CPU plans "
        "follow in a subprocess beside phases 10-11)")
    jobs = {"plane": plane_job(torch, plane_cases)}
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

    plane_check(torch, jobs.pop("plane"), plane_cases)
    del plane_cases
    # phase 15's CPU search and phase 18's dry run need no card: they run
    # in subprocesses beside phases 12-14
    jobs.update(planner=planner_job(), dryrun=dryrun_job())
    log(f"[jobs] started beside phases 12-14: {sorted(jobs)} (script wall "
        f"so far {time.perf_counter() - t_start:.1f} s)")

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

    reset_counters()
    phase_lm_serving(torch, gemma_2b.ARCH, results)
    paths["lm_serving"] = counters()
    copies["lm_serving"] = transposes()
    reset_counters()
    phase_planner(torch, results, jobs["planner"])
    paths["planner"] = counters()
    copies["planner"] = transposes()
    log(f"[plan] script wall so far {time.perf_counter() - t_start:.1f} s")

    reset_counters()
    phase_training(torch, np, results)
    paths["training"] = counters()
    copies["training"] = transposes()
    log(f"[train] script wall so far {time.perf_counter() - t_start:.1f} s")

    reset_counters()
    phase_mesh(torch, np, mesh_run, vgg_hw, results)
    paths["mesh"] = counters()
    copies["mesh"] = transposes()
    del mesh_run
    log(f"[mesh] script wall so far {time.perf_counter() - t_start:.1f} s")

    reset_counters()
    phase_pipeline(torch, pipe_run, vgg_hw, nets["vgg11"], results,
                   jobs["dryrun"])
    paths["pipeline"] = counters()
    copies["pipeline"] = transposes()
    del pipe_run
    log(f"[pipeline] script wall so far {time.perf_counter() - t_start:.1f} s")

    paths["tp"], copies["tp"] = phase_tp(torch, results)
    log(f"[tp] script wall so far {time.perf_counter() - t_start:.1f} s")

    phase_fsdp(torch, results)
    log(f"[fsdp] script wall so far {time.perf_counter() - t_start:.1f} s")

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
                        ("lm_serving", ("radix_matmul",
                                        "radix_decode_attn")),
                        ("planner", cnn_kernels
                         if results["planner"]["backend"] == "kernels"
                         else ()),
                        ("training", cnn_kernels + ("radix_decode_attn",)),
                        ("mesh", cnn_kernels + ("radix_decode_attn",)),
                        ("pipeline", cnn_kernels + ("radix_decode_attn",)),
                        ("tp", ("radix_matmul", "radix_decode_attn")),
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
        "(launches: every path, phases 3-4, 7, 8, 9, 10, 11, 12, 13, 14, "
        "15, 16, 17, 18 and 19, phase 19's spawned ranks' included); "
        "decode attention at the LM "
        "decode shape (packed, fused); encoder at 8x224x224x3, T=4")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def run() -> int:
    try:
        return main()
    finally:
        CpuJob.stop_all()


if __name__ == "__main__":
    sys.exit(run())
