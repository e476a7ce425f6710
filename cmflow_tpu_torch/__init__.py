"""cmflow_tpu_torch — the PyTorch and CUDA port of ``cmflow_tpu``.

Same layout as the JAX package, so each module's counterpart has the same
path.  Plain tensor code is PyTorch; every Pallas kernel of the JAX package
on a ported path is a hand-written CUDA kernel for Hopper (``csrc/``), built
with ``nvcc`` at first use.  Each kernel's wrapper runs the kernel on CUDA
tensors and the kernel's plain PyTorch version on CPU tensors.
"""

__version__ = "0.1.0"
