from .dense import batched_inverse
from .spmv import stencil_matvec, stencil_matvec_flat

__all__ = ["batched_inverse", "stencil_matvec", "stencil_matvec_flat"]
