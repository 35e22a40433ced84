"""Training (port of ``repro/train``): optimizers, checkpoints, gradient
compression and the ANN trainer, over trees of tensors."""

from repro_torch.train import checkpoint, compression, optim, trainer

__all__ = ["optim", "checkpoint", "compression", "trainer"]
