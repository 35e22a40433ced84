"""VGG-11 — the paper's scalability demonstrator (Table III, CIFAR-100)."""

from repro_torch.models.vgg import make, NUM_CLASSES  # noqa: F401
