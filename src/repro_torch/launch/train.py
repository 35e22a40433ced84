"""LM training loop on one device (port of ``repro/launch/train.py``).

Wires the training layers together: config -> seeded init -> prefetched
``synthetic_tokens`` batches -> ``lm.model.make_train_step`` -> async
checkpoints (``train.checkpoint.CheckpointManager``, resumed from the
newest) -> the straggler monitor.  The reference lays the same loop over
a device mesh; the port runs it on one device, and a mesh of more than
one (``--data``/``--model`` > 1) waits for multi-GPU (ROADMAP.md, queue 1
item 7).

Usage::

  python -m repro_torch.launch.train --arch gemma_2b --smoke --steps 100 --device cpu
  python -m repro_torch.launch.train --arch gemma_2b --steps 10 --batch 8 --seq 512
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.api import _resolve_device
from repro_torch.configs import get_config
from repro_torch.data.pipeline import Prefetcher
from repro_torch.data.synthetic import synthetic_tokens
from repro_torch.lm import model as M
from repro_torch.runtime.straggler import StragglerMonitor
from repro_torch.train import checkpoint as ckpt_lib
from repro_torch.train import optim as optim_lib

__all__ = ["train_loop", "main"]


def train_loop(cfg, *, steps: int, batch_size: int, seq_len: int,
               lr: float = 3e-3, ckpt_dir=None, ckpt_every: int = 50,
               resume: bool = True, log=print, seed: int = 0,
               optimizer: str = "adafactor", device=None):
    """Train ``cfg`` from ``init_params(seed)`` (or the newest checkpoint
    in ``ckpt_dir`` when ``resume``) to ``steps`` steps on ``device``
    (``None`` means CUDA, and raises without it).  Returns (state,
    per-step losses of this call)."""
    device = _resolve_device(device)
    opt = (optim_lib.adafactor(lr) if optimizer == "adafactor"
           else optim_lib.adam(lr))
    gen = torch.Generator(device=device).manual_seed(seed)
    params = M.init_params(gen, cfg)
    state = {"params": params, "opt": opt.init(params),
             "step": torch.zeros((), dtype=torch.int32, device=device)}
    step_fn = M.make_train_step(cfg, opt)

    start = 0
    manager = ckpt_lib.CheckpointManager(ckpt_dir) if ckpt_dir else None
    if manager and resume:
        last = ckpt_lib.latest_step(ckpt_dir)
        if last is not None:
            state, _ = ckpt_lib.restore(ckpt_dir, last, state)
            start = last
            log(f"[train] resumed from step {last}")

    monitor = StragglerMonitor()
    history = []
    pf = Prefetcher(lambda s: torch.from_numpy(synthetic_tokens(
        s, batch_size, seq_len, cfg.vocab, seed=seed)), start, steps - start,
        depth=2)
    for s, tokens in pf:
        t0 = time.time()
        state, metrics = step_fn(state, {"tokens": tokens.to(device)})
        loss = float(metrics["loss"])        # waits for the step
        dt = time.time() - t0
        monitor.record(s, dt)
        history.append(loss)
        if s % 10 == 0 or s == steps - 1:
            log(f"[train] step {s:5d} loss {loss:.4f} "
                f"acc {float(metrics['acc']):.3f} "
                f"gnorm {float(metrics['grad_norm']):.2f} {dt*1e3:.0f}ms"
                + (" STRAGGLER" if monitor.is_outlier(dt) else ""))
        if manager and (s + 1) % ckpt_every == 0:
            manager.save(s + 1, state)
    if manager:
        manager.save(steps, state)
        manager.wait()
    return state, history


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-trainable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--data", type=int, default=1)
    ap.add_argument("--model", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)
    if args.data > 1 or args.model > 1:
        raise NotImplementedError(
            f"--data {args.data} --model {args.model}: training over a "
            "device mesh is not ported yet (ROADMAP.md, queue 1 item 7: "
            "multi-GPU)")
    cfg = get_config(args.arch, smoke=args.smoke)
    train_loop(cfg, steps=args.steps, batch_size=args.batch,
               seq_len=args.seq, lr=args.lr, ckpt_dir=args.ckpt_dir,
               device=args.device)


if __name__ == "__main__":
    main()
