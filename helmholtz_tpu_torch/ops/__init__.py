from .dense import batched_inverse
from .spmv import stencil9_matvec, stencil_matvec, stencil_matvec_flat

__all__ = ["batched_inverse", "stencil9_matvec", "stencil_matvec",
           "stencil_matvec_flat"]
