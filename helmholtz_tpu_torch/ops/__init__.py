from .dense import batched_inverse
from .spmv import (bsr_matmat, bsr_matvec, coo_matvec, csr_matmat,
                   csr_matvec, stencil9_matvec, stencil_matvec,
                   stencil_matvec_flat)

__all__ = ["batched_inverse", "bsr_matmat", "bsr_matvec", "coo_matvec",
           "csr_matmat", "csr_matvec", "stencil9_matvec", "stencil_matvec",
           "stencil_matvec_flat"]
