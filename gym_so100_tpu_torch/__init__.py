"""gym_so100_tpu_torch: the PyTorch/CUDA port of gym_so100_tpu.

A second package beside the JAX one, module for module (`models/`, `ops/`,
`ops/collision/`, `envs/`, `parallel/`).  It imports torch, numpy, scipy
and the standard library only.  The two Pallas kernels of the JAX package
are hand-written CUDA kernels here (`csrc/`), built with nvcc at first use
(`kernels.py`); on CPU tensors every kernel wrapper runs its plain PyTorch
version instead.
"""

__version__ = "0.1.0"
