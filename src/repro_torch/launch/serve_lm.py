"""Radix-LM serving over the compiled LM plan surface (port of
``repro/launch/serve_lm.py``).

``repro_torch.launch.serve`` drives the *uncompiled* LM decode loop.  This
driver serves the compiled twin: an :class:`repro_torch.api.LMExecutable`
compiled by ``Accelerator.compile`` from a ``(params, ArchConfig)`` pair,
with

1. **Bucketed prefill and one decode plan**: prompts right-pad to a
   sequence-bucket ladder (one prefill plan per bucket, last-token logits
   gathered at the true length) and every generated token reuses one
   decode-step plan over the packed radix KV cache: no plan is built in
   steady state, as the plan-cache counters in ``server.stats()`` show.
2. **Radix matmuls through the kernels**: on ``backend="kernels"`` the FFN
   and untied unembed (and, with ``--radix-attn``, the QKV/out)
   projections run the CUDA radix matmul kernel, and decode attention the
   CUDA decode-attention kernel; ``--autotune`` sweeps every (layer, m, k,
   n) problem up front.  ``backend="jnp"`` runs the exact integer product
   and the plain attention instead, with the same tokens.
3. **The resilience queue**: requests micro-batch through
   :class:`repro_torch.launch.serve_cnn.MicroBatchQueue` (bounded
   admission, deadlines, bisecting quarantine, health machine), token
   prompts riding in the queue's float32 payloads (every vocab is below
   2^24, so the cast back to integers at ``infer`` is exact).  The
   ``rejected / shed / retried / quarantined / degraded_flushes`` counters
   land in ``server.stats()`` next to the plan-cache and autotune counters.

Weights are drawn by ``lm.model.init_params`` from ``--seed`` on a
``torch.Generator`` (not the reference's PRNG draws).  Plans run on the
CUDA device unless ``--device cpu`` is given.

Usage:
  python -m repro_torch.launch.serve_lm --arch gemma_2b --smoke --device cpu
  python -m repro_torch.launch.serve_lm --arch gemma_2b --smoke --autotune \\
      --num-steps 6 --requests 32
  python -m repro_torch.launch.serve_lm --arch gemma_2b --smoke --backend jnp
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch import api
from repro_torch.configs import LM_ARCHS, get_config
from repro_torch.launch.serve_cnn import MicroBatchQueue, Ticket, _percentiles
from repro_torch.lm import model as lm_model
from repro_torch.runtime import resilience

__all__ = ["LMServer", "make_queue", "prompt_rows", "run_prompt_stream",
           "main"]


class LMServer:
    """One LM arch behind a compiled :class:`repro_torch.api.LMExecutable`.

    Sequence bucketing, plan caching and the stats counters live on the
    executable (``server.exe``).  The queue-facing surface matches
    :class:`~repro_torch.launch.serve_cnn.CNNServer` (``item_shape`` /
    ``infer`` / ``resilience``), so ``MicroBatchQueue`` drives it
    unchanged: one *item* is a fixed-length token prompt, and ``infer``
    answers ``max_new`` greedily decoded tokens per prompt.
    """

    def __init__(
        self,
        arch: str = "gemma_2b",
        *,
        smoke: bool = True,
        batch: int = 4,
        max_len: int = 48,
        prompt_len: int = 12,
        max_new: int = 8,
        buckets: Optional[Sequence[int]] = None,
        backend: str = "kernels",
        dataflow: Optional[str] = "bitserial",
        num_steps: Optional[int] = None,
        radix_attn: bool = False,
        autotune: bool = False,
        seed: int = 0,
        executable: Optional[api.LMExecutable] = None,
        device=None,
    ):
        if executable is None:
            cfg = get_config(arch, smoke=smoke)
            if num_steps is not None:
                cfg = dataclasses.replace(cfg, radix_steps=num_steps)
            if radix_attn:
                cfg = dataclasses.replace(cfg, radix_attn=True)
            acc = api.Accelerator(backend=backend, dataflow=dataflow,
                                  device=device)
            dev = api._resolve_device(device)
            params = lm_model.init_params(
                torch.Generator(device=dev).manual_seed(seed), cfg)
            executable = acc.compile((params, cfg), (batch, max_len),
                                     buckets=buckets, autotune=autotune)
        self.exe = executable
        self.prompt_len = int(prompt_len)
        self.max_new = int(max_new)
        if self.prompt_len < 1 or self.max_new < 1:
            raise ValueError(
                f"need prompt_len >= 1 and max_new >= 1, got "
                f"({prompt_len}, {max_new})")
        if self.prompt_len > self.exe.buckets[-1]:
            raise ValueError(
                f"prompt_len {self.prompt_len} exceeds the top sequence "
                f"bucket {self.exe.buckets[-1]}")
        if self.prompt_len + self.max_new - 1 > self.exe.max_len:
            raise ValueError(
                f"prompt_len {self.prompt_len} + max_new {self.max_new} "
                f"tokens exceed the compiled cache "
                f"(max_len={self.exe.max_len})")
        self.vocab = self.exe.cfg.vocab
        # the queue's payloads are float arrays; one item = one prompt row
        self.item_shape = (self.prompt_len,)
        self.resilience = resilience.ResilienceStats()
        self.exe.attach_stats(self.resilience.as_dict)

    def warmup(self) -> None:
        """Build every prefill bucket's plan and the decode plan up front."""
        self.exe.warmup()

    def stats(self) -> dict:
        return self.exe.stats()

    def infer(self, x) -> torch.Tensor:
        """(n, prompt_len) token rows (the queue's float payload, or ints)
        -> (n, max_new) greedily decoded tokens on the executable's
        device.  A token id outside ``[0, vocab)`` raises ``ValueError``
        before any device work.  More rows than the compiled batch run in
        chunks of it: a healthy queue's flush hands over everything
        pending, which can exceed the batch (the reference's ``infer``
        raises there, and its queue bisects the flush)."""
        tok = torch.as_tensor(np.asarray(x)).to(torch.long)
        if tok.ndim != 2 or tuple(tok.shape[1:]) != self.item_shape:
            raise ValueError(
                f"request item shape {tuple(tok.shape[1:])} != server's "
                f"{self.item_shape}")
        if bool((tok < 0).any()) or bool((tok >= self.vocab).any()):
            raise ValueError(
                f"token ids must be in [0, {self.vocab}), got range "
                f"[{int(tok.min())}, {int(tok.max())}]")
        b = self.exe.batch
        out = [self.exe.generate(tok[i:i + b], self.max_new)
               for i in range(0, tok.shape[0], b)]
        return out[0] if len(out) == 1 else torch.cat(out)


def make_queue(server: LMServer, **kwargs) -> MicroBatchQueue:
    """The resilience queue over an LM server.  ``max_batch`` defaults to
    the executable's *batch* capacity and ``degraded_max_batch`` to half
    of it: the CNN defaults would read the LM's sequence-bucket ladder as
    a batch ladder."""
    kwargs.setdefault("max_batch", server.exe.batch)
    kwargs.setdefault("degraded_max_batch", max(1, server.exe.batch // 2))
    return MicroBatchQueue(server, **kwargs)


def prompt_rows(sizes: Sequence[int], prompt_len: int, vocab: int, *,
                seed: int = 0) -> List[np.ndarray]:
    """The random token prompts :func:`run_prompt_stream` submits: one
    float32 (n, prompt_len) array of ids in ``[0, vocab)`` per size, drawn
    in order from ``numpy.random.default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, (int(n), prompt_len)).astype(np.float32)
            for n in sizes]


def run_prompt_stream(
    queue: MicroBatchQueue,
    sizes: Sequence[int],
    *,
    seed: int = 0,
    drain: bool = True,
    deadline_s: Optional[float] = None,
) -> List[Ticket]:
    """Submit a stream of random token prompts (numpy, from ``seed``) of
    the given batch sizes; drains the queue so every ticket is terminal.
    The LM twin of :func:`~repro_torch.launch.serve_cnn.run_request_stream`,
    with integer token rows in place of float images."""
    server: LMServer = queue.server
    tickets = [queue.submit(rows, deadline_s=deadline_s)
               for rows in prompt_rows(sizes, server.prompt_len,
                                       server.vocab, seed=seed)]
    if drain:
        queue.flush()
    return tickets


def _parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="gemma_2b", choices=sorted(LM_ARCHS))
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (the size for a CPU)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=48,
                    help="KV-cache length (prompt + generated tokens)")
    ap.add_argument("--prompt-len", type=int, default=12)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--buckets", default=None,
                    help="comma-separated sequence-bucket ladder "
                         "(default: powers of two up to max_len - 1)")
    ap.add_argument("--num-steps", type=int, default=None,
                    help="radix time steps T (default: the arch config's)")
    ap.add_argument("--backend", default="kernels",
                    choices=["kernels", "jnp"])
    ap.add_argument("--dataflow", default=None,
                    choices=["fused", "bitserial"],
                    help="in-kernel plane schedule (kernels backend)")
    ap.add_argument("--radix-attn", action="store_true",
                    help="also radix-quantize the QKV/out projections")
    ap.add_argument("--autotune", action="store_true",
                    help="sweep the kernel launch per (layer, m, k, n) "
                         "problem at compile time")
    ap.add_argument("--device", default=None,
                    help="torch device for weights and plans; default cuda "
                         "(cpu runs the kernels' plain versions)")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--timeout-ms", type=float, default=2.0)
    ap.add_argument("--deadline-ms", type=float, default=None)
    ap.add_argument("--retries", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    for flag, val, lo in (("--batch", args.batch, 1),
                          ("--max-len", args.max_len, 2),
                          ("--prompt-len", args.prompt_len, 1),
                          ("--max-new", args.max_new, 1),
                          ("--requests", args.requests, 1),
                          ("--retries", args.retries, 0)):
        if val < lo:
            ap.error(f"{flag} must be >= {lo}, got {val}")
    if args.timeout_ms < 0:
        ap.error(f"--timeout-ms must be >= 0, got {args.timeout_ms}")
    if args.deadline_ms is not None and args.deadline_ms <= 0:
        ap.error(f"--deadline-ms must be positive, got {args.deadline_ms}")
    if args.buckets is not None:
        try:
            args.buckets = tuple(int(b) for b in args.buckets.split(","))
        except ValueError:
            ap.error(f"--buckets must be comma-separated ints, got "
                     f"{args.buckets!r}")
    return args


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Serve a seeded prompt stream; prints the summary and returns it
    (requests, prompts, tokens, wall seconds, tokens/s, p50/p95 ms,
    stats, health, flushes)."""
    args = _parse_args(argv)
    t0 = time.monotonic()
    server = LMServer(
        args.arch, smoke=args.smoke, batch=args.batch,
        max_len=args.max_len, prompt_len=args.prompt_len,
        max_new=args.max_new, buckets=args.buckets,
        backend=args.backend, dataflow=args.dataflow,
        num_steps=args.num_steps, radix_attn=args.radix_attn,
        autotune=args.autotune, seed=args.seed, device=args.device)
    print(f"[serve_lm] {server.exe!r}")
    server.warmup()
    stats = server.stats()
    print(f"[serve_lm] warmed {len(server.exe.buckets)} prefill plans + 1 "
          f"decode plan in {time.monotonic() - t0:.1f}s; "
          f"compiles={stats['compiles']} "
          f"autotuned_layers={len(stats['autotune']['layers'])}")

    queue = make_queue(
        server, timeout_s=args.timeout_ms / 1e3,
        default_deadline_s=None if args.deadline_ms is None
        else args.deadline_ms / 1e3,
        retry=resilience.RetryPolicy(max_retries=args.retries))
    rng = np.random.default_rng(args.seed)
    sizes = rng.integers(1, args.batch + 1, args.requests)
    t0 = time.monotonic()
    tickets = run_prompt_stream(queue, sizes, seed=args.seed)
    wall = time.monotonic() - t0
    ok = [t for t in tickets if t.ok]
    lat = [t.latency_s * 1e3 for t in ok]
    p50, p95 = _percentiles(lat) if lat else (float("nan"), float("nan"))
    prompts = int(sum(t.size for t in ok))
    toks = prompts * args.max_new
    stats = server.stats()
    steady = stats["compiles"] - (len(server.exe.buckets) + 1)
    print(f"[serve_lm] {len(tickets)} requests / {prompts} prompts -> "
          f"{toks} tokens in {wall:.2f}s = {toks / wall:.1f} tok/s; "
          f"latency p50={p50:.1f}ms p95={p95:.1f}ms")
    print(f"[serve_lm] cache: hits={stats['hits']} "
          f"compiles={stats['compiles']} (steady-state recompiles={steady}) "
          f"executions={stats['executions']} "
          f"padded_rows={stats['padded_rows']}")
    print(f"[serve_lm] resilience: health={queue.health.state} "
          f"rejected={stats['rejected']} shed={stats['shed']} "
          f"retried={stats['retried']} quarantined={stats['quarantined']} "
          f"degraded_flushes={stats['degraded_flushes']} "
          f"failures={stats['failures']}")
    return dict(requests=len(tickets), ok=len(ok), prompts=prompts,
                tokens=toks, wall_s=wall, tokens_per_s=toks / wall,
                p50_ms=p50, p95_ms=p95, stats=stats,
                health=queue.health.state, flushes=queue.flushes,
                steady_compiles=steady)


if __name__ == "__main__":
    main()
