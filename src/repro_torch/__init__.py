"""repro_torch — the radix SNN accelerator's inference path in PyTorch + CUDA.

A second package beside the JAX reference ``repro``; it imports neither
JAX nor ``repro``.  Each module names its counterpart:

* ``repro_torch.core.{encoding,neuron,layers,conversion,engine}`` <->
  ``repro/core/{encoding,neuron,layers,conversion,engine}.py``;
* ``repro_torch.kernels.radix_matmul`` (``radix_matmul_cuda``, CUDA
  source ``csrc/radix_matmul.cu``) <->
  ``repro/kernels/radix_matmul.py:radix_matmul_pallas``;
* ``repro_torch.kernels.radix_conv`` (``radix_conv2d_cuda``, CUDA source
  ``csrc/radix_conv.cu``) <-> ``repro/kernels/radix_conv.py:radix_conv2d_pallas``;
* ``repro_torch.kernels.{ops,ref,autotune}`` <-> ``repro/kernels/{ops,ref,autotune}.py``;
* ``repro_torch.models.{lenet,vgg,fang}`` <-> ``repro/models/{lenet,vgg,fang}.py``;
* ``repro_torch.configs`` <-> ``repro/configs`` (Gemma-2B, the CNN registry);
* ``repro_torch.api`` <-> ``repro/api.py`` (``Accelerator`` with the
  ``kernels`` and ``jnp`` backends, ``Executable``, ``oracle``,
  ``convert``, the four encoding specs and the support matrix);
* ``repro_torch.runtime.{resilience,straggler,restart}`` <->
  ``repro/runtime/*.py`` (the serving part);
* ``repro_torch.launch.serve_cnn`` <-> ``repro/launch/serve_cnn.py``;
* ``repro_torch.carry`` moves float params and converted nets across from
  the JAX package as numpy arrays (the parity tests use it).

Entry points run on the CUDA device unless the caller passes
``device="cpu"``; on CPU tensors every kernel wrapper runs its plain
PyTorch version.

Import pins float32 products to IEEE float32: cuDNN would otherwise run
float32 convolutions in TF32 (10-bit mantissa), and the calibration
forward of ``convert`` would drift from the reference.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
