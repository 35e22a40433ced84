"""LM training loop (port of ``repro/launch/train.py``).

Wires the training layers together: config -> seeded init, placed over a
device mesh when one is given -> prefetched ``synthetic_tokens`` batches
(``data.pipeline.ShardedLoader`` over a mesh) ->
``lm.model.make_train_step`` -> async checkpoints
(``train.checkpoint.CheckpointManager``, resumed from the newest) -> the
straggler monitor.  Training runs with deterministic kernels
(``train.determinism``), so one seed gives one result on the card too.

A mesh needs a process group of ``--data`` x ``--model`` ranks, one
process each (``torch.distributed.init_process_group`` with its store,
rank and world size; ``launch/mesh.make_test_mesh`` raises without one).

Usage::

  python -m repro_torch.launch.train --arch gemma_2b --smoke --steps 100 --device cpu
  python -m repro_torch.launch.train --arch gemma_2b --steps 10 --batch 8 --seq 512
  (in each of 4 ranks) main(["--arch", "glm4_9b", "--smoke", "--data", "2",
                             "--model", "2"])
"""

from __future__ import annotations

import argparse
import time

import torch
import torch.distributed as dist

from repro_torch.api import _resolve_device
from repro_torch.configs import get_config
from repro_torch.data.pipeline import Prefetcher, ShardedLoader
from repro_torch.data.synthetic import synthetic_tokens
from repro_torch.lm import model as M
from repro_torch.parallel import sharding as SH
from repro_torch.runtime.straggler import StragglerMonitor
from repro_torch.train import checkpoint as ckpt_lib
from repro_torch.train import optim as optim_lib
from repro_torch.train.determinism import deterministic

__all__ = ["train_loop", "main"]


def train_loop(cfg, mesh=None, *, steps: int, batch_size: int, seq_len: int,
               lr: float = 3e-3, ckpt_dir=None, ckpt_every: int = 50,
               resume: bool = True, log=print, seed: int = 0,
               optimizer: str = "adafactor", device=None):
    """Train ``cfg`` from ``init_params(seed)`` (or the newest checkpoint
    in ``ckpt_dir`` when ``resume``) to ``steps`` steps, with
    deterministic kernels.  ``mesh=None`` runs on ``device`` (``None``
    means CUDA, and raises without it); a ``DeviceMesh`` runs on its
    ranks' devices, the state placed by ``parallel.sharding``'s specs
    (each rank storing its piece) and the batches by ``batch_specs``.
    Returns (state, per-step losses of this call)."""
    with deterministic():
        return _train_loop(cfg, mesh, steps, batch_size, seq_len, lr,
                           ckpt_dir, ckpt_every, resume, log, seed, optimizer,
                           device)


def _train_loop(cfg, mesh, steps, batch_size, seq_len, lr, ckpt_dir,
                ckpt_every, resume, log, seed, optimizer, device):
    device = (_resolve_device(device) if mesh is None
              else SH.mesh_device(mesh))
    opt = (optim_lib.adafactor(lr) if optimizer == "adafactor"
           else optim_lib.adam(lr))
    gen = torch.Generator(device=device).manual_seed(seed)
    params = M.init_params(gen, cfg)
    state = {"params": params, "opt": opt.init(params),
             "step": torch.zeros((), dtype=torch.int32, device=device)}
    del params

    def batch_fn(s):
        return (synthetic_tokens(s, batch_size, seq_len, cfg.vocab,
                                 seed=seed),)

    if mesh is None:
        def loader(s):
            return (torch.from_numpy(batch_fn(s)[0]).to(device),)
    else:
        pspecs = SH.param_specs(state["params"], cfg, mesh)
        state = SH.place(state, {
            "params": pspecs,
            "opt": SH.opt_state_specs(pspecs, state["opt"], mesh),
            "step": ()}, mesh)
        tokens = torch.empty((batch_size, seq_len + 1), device="meta")
        loader = ShardedLoader(batch_fn, mesh, [SH.batch_specs(
            {"tokens": tokens}, cfg, mesh)["tokens"]])
    step_fn = M.make_train_step(cfg, opt, mesh=mesh)

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
    for s, (tokens,) in Prefetcher(loader, start, steps - start, depth=2):
        t0 = time.time()
        state, metrics = step_fn(state, {"tokens": tokens})
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
        if mesh is not None:
            dist.barrier()           # the writer rank's files are complete
    return state, history


def main(argv=None):
    """The CLI; returns ``train_loop``'s (state, losses).  ``--data`` x
    ``--model`` > 1 trains over a mesh of that many ranks (one process
    each, the process group initialized by the caller)."""
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
    cfg = get_config(args.arch, smoke=args.smoke)
    mesh = None
    if args.data * args.model > 1:
        from repro_torch.launch.mesh import make_test_mesh
        mesh = make_test_mesh(data=args.data, model=args.model)
    return train_loop(cfg, mesh, steps=args.steps, batch_size=args.batch,
                      seq_len=args.seq, lr=args.lr, ckpt_dir=args.ckpt_dir,
                      device=args.device)


if __name__ == "__main__":
    main()
