"""Fang et al. CNN-2 — Table III cross-accelerator comparison network."""

from repro_torch.models.fang import make, INPUT_HW, NUM_CLASSES  # noqa: F401
