"""ANN trainer (port of ``repro/train/trainer.py``): trains the float
networks that ANN -> SNN conversion takes.

The paper trains an equivalent ANN and transfers its parameters (Sec.
IV-A).  This is that half: SGD with Nesterov momentum over the affine
leaves of ``core.conversion.float_forward``, gradients by autograd, on
``SyntheticVision`` batches indexed by step.  Layers without parameters
(``None``) keep their places in the list.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.api import _resolve_device
from repro_torch.core import conversion
from repro_torch.data.synthetic import SyntheticVision
from repro_torch.train import optim as optim_lib
from repro_torch.train.determinism import deterministic
from repro_torch.train.tree import leaves, tree_map, unflatten

__all__ = ["TrainConfig", "train_ann", "evaluate_ann", "cross_entropy"]


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    return -torch.gather(logp, -1, labels.long()[..., None]).mean()


@dataclasses.dataclass
class TrainConfig:
    steps: int = 300
    batch_size: int = 128
    lr: float = 2e-3
    momentum: float = 0.9
    weight_decay: float = 1e-4
    log_every: int = 50
    seed: int = 0


def _with_nones(params, trainable):
    it = iter(trainable)
    return [next(it) if p is not None else None for p in params]


def make_ann_step(static, params, cfg: TrainConfig, opt):
    """``step(trainable, opt_state, x, y) -> (trainable, opt_state, loss,
    acc)``: one SGD step on the affine layers' ``{"w", "b"}`` list
    (``params`` gives the places of the ``None`` layers)."""

    def step(trainable, opt_state, x, y):
        tr = tree_map(lambda t: t.detach().requires_grad_(True), trainable)
        logits = conversion.float_forward(static, _with_nones(params, tr), x)
        loss = cross_entropy(logits, y)
        acc = (logits.argmax(-1) == y).to(torch.float32).mean()
        grads = unflatten(tr, torch.autograd.grad(loss, leaves(tr)))
        trainable = tree_map(torch.Tensor.detach, trainable)
        if cfg.weight_decay:
            grads = tree_map(lambda g, p: g + cfg.weight_decay * p,
                             grads, trainable)
        updates, opt_state = opt.update(grads, opt_state, trainable)
        return (optim_lib.apply_updates(trainable, updates), opt_state,
                loss.detach(), acc)

    return step


def train_ann(
    static,
    params,
    data: SyntheticVision,
    cfg: TrainConfig = TrainConfig(),
    log: Optional[Callable[[str], None]] = print,
    *,
    device=None,
) -> Tuple[Any, Dict[str, float]]:
    """SGD-momentum training of the float ANN on the procedural dataset,
    on ``device`` (``None`` means CUDA, and raises without it), with
    deterministic kernels (``train.determinism``: one seed, one result,
    on the card as in the reference).  Returns the trained params (on
    ``device``) and the last step's metrics."""
    with deterministic():
        return _train_ann(static, params, data, cfg, log,
                          _resolve_device(device))


def _train_ann(static, params, data, cfg, log, device):
    opt = optim_lib.sgd(cfg.lr, cfg.momentum, nesterov=True)
    trainable = [tree_map(lambda t: t.to(device), p)
                 for p in params if p is not None]
    opt_state = opt.init(trainable)
    step = make_ann_step(static, params, cfg, opt)

    t0 = time.time()
    last = {}
    for s in range(cfg.steps):
        xb, yb = data.batch(s, cfg.batch_size)
        trainable, opt_state, l, acc = step(
            trainable, opt_state, torch.from_numpy(xb).to(device),
            torch.from_numpy(yb).to(device))
        if log and (s % cfg.log_every == 0 or s == cfg.steps - 1):
            log(f"[train_ann] step {s:4d} loss {float(l):.4f} "
                f"acc {float(acc):.3f}")
        last = {"loss": float(l), "acc": float(acc)}
    last["wall_s"] = time.time() - t0
    return _with_nones(params, trainable), last


def evaluate_ann(static, params, data: SyntheticVision, *, batches: int = 8,
                 batch_size: int = 256, device=None) -> float:
    """Accuracy over ``batches`` held-out batches (steps 10 000 + i), on
    ``device`` (``None`` means CUDA, and raises without it)."""
    device = _resolve_device(device)
    params = [None if p is None else tree_map(lambda t: t.to(device), p)
              for p in params]
    correct = total = 0
    with torch.no_grad():
        for i in range(batches):
            xb, yb = data.batch(10_000 + i, batch_size)
            logits = conversion.float_forward(static, params,
                                              torch.from_numpy(xb).to(device))
            pred = logits.argmax(-1).cpu().numpy()
            correct += int((pred == yb).sum())
            total += batch_size
    return correct / total
