"""LeNet-5 — the paper's primary evaluation network (Tables I-III)."""

from repro_torch.models.lenet import make, INPUT_HW, NUM_CLASSES  # noqa: F401
