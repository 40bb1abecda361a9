"""ozone-tpu on PyTorch and CUDA: the port of `ozone_tpu` to an NVIDIA H100.

The JAX package `ozone_tpu` is the reference; this package mirrors its
module names (codec/, storage/, client/, scm/, utils/) so each module's
counterpart is easy to find. It imports `torch` and never `jax` or any
`ozone_tpu` module: the host-side math it needs is copied here.

Device kernels are hand-written CUDA C++ under `csrc/`, compiled with
`nvcc` at first use into `_build/` (see `cuda_build.py`). Every kernel
wrapper runs its plain PyTorch version for a CPU tensor and launches the
kernel (or raises) for a CUDA tensor. Entry points default to
`device="cuda"` and raise when CUDA is absent unless the caller passes
`device="cpu"`.
"""

__version__ = "0.1.0"
