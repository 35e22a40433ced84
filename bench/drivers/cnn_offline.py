"""Closed loop, one client: back-to-back ``Executable`` calls of
``batch`` images, each call the next ``batch`` of a pool of
``pool_images`` resident on the device.

Set-up converts and compiles the seed's net for the cell's buckets
(``Executable.warmup`` builds and runs each bucket's plan once).  The
window ends with the first call that finishes after ``seconds`` and a
device synchronize; the rate is every image over the whole window.  The
check compares every call's logits with the reference's for its images:
an exact comparison of integer paths."""

from __future__ import annotations

import time

import torch

from bench.harness import Check
from bench.nets import cnn


class Driver:
    def __init__(self, run):
        self.run = run
        cfg, wl = run.config, run.workload
        self.batch = int(wl["batch"])
        if wl["pool_images"] % self.batch:
            raise ValueError("pool_images must be a multiple of batch")
        self.exe = cnn.build(cfg, run.seed, run.device, wl["buckets"])
        self.pool = cnn.images(cfg, run.seed, 2, wl["pool_images"],
                               run.device)
        self.outs = []
        self.elapsed = 0.0
        self.stats = {}

    def window(self) -> None:
        run, exe, pool, b = self.run, self.exe, self.pool, self.batch
        outs = []
        run.sync()
        t0 = time.perf_counter()
        deadline = t0 + run.seconds
        while True:
            off = len(outs) * b % len(pool)
            with run.span("Executable.__call__"):
                outs.append((off, exe(pool[off:off + b])))
            if time.perf_counter() >= deadline:
                break
        run.sync()
        self.elapsed = time.perf_counter() - t0
        self.outs = outs

    def metrics(self) -> dict:
        return {"images_per_s": len(self.outs) * self.batch / self.elapsed}

    def attempted(self):
        return len(self.outs), 0

    def info(self) -> dict:
        return {"calls": len(self.outs), "batch": self.batch,
                "images": len(self.outs) * self.batch}

    def release(self) -> None:
        self.exe = None

    def check(self):
        cfg, pool = self.run.config, self.pool
        ref = cnn.reference_logits(cfg, self.run.seed, pool, self.batch)
        differing = sum(int((y != ref[off:off + len(y)]).sum())
                        for off, y in self.outs)
        return [Check("logits_differing", float(differing), 0.0)]


def control(run) -> list:
    """The control in the program's place: the reference with its output
    logic in bfloat16, over the cell's pool, held to the cell's check."""
    cfg = run.config
    pool = cnn.images(cfg, run.seed, 2, run.workload["pool_images"],
                      run.device)
    b = int(run.workload["batch"])
    ref = cnn.reference_logits(cfg, run.seed, pool, b)
    low = cnn.reference_logits(cfg, run.seed, pool, b, torch.bfloat16)
    return [Check("logits_differing", float((low != ref).sum()), 0.0)]
