"""Plain references the benchmark holds the program's outputs against.

They import neither JAX nor any package of the program (``repro``,
``repro_torch``): each takes the float weights and the inputs that the
harness drew from the seed, redoes the program's preparation (the SNN
conversion, the LM's radix weights) itself, and computes in float32 or
exact integers with TF32 off.  ``precision`` selects the control, the same
reference one precision step below what the configuration states."""

import contextlib

import torch


@contextlib.contextmanager
def no_tf32():
    """Float32 matrix products and convolutions in float32, not TF32."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old
