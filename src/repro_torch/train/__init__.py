"""Training (port of ``repro/train``): optimizers, checkpoints, gradient
compression and the ANN trainer, over trees of tensors, and the
deterministic kernels training runs with (``determinism``)."""

from repro_torch.train import (checkpoint, compression, determinism, optim,
                               trainer)

__all__ = ["optim", "checkpoint", "compression", "trainer", "determinism"]
