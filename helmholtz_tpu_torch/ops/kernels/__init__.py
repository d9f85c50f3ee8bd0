"""Hand-written CUDA kernels of the port and their wrappers.

Counterpart of the JAX package's `ops/pallas/`.  Each wrapper module holds
the kernel's launch code, its plain PyTorch version, a launch counter and a
note on what the kernel replaces and what bounds it.  Nothing here touches
the CUDA toolchain at import time: the library is built at the first launch.
"""
