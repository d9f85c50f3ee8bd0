"""The PyTorch/CUDA port of the JAX package that sits beside it.

Complex 2-D finite-difference Helmholtz assembly with PML, the sparse
formats (stencil, COO, CSR, BSR) and their products, the Engquist-Ying
sweeping preconditioner with moving PML and the exact sweeping
factorization (stored, or re-derived inside every apply), GMRES and
BiCGStab, checkpoints of factored and in-flight state, on one NVIDIA H100,
and the distributed path over ranks on `torch.distributed` (`dist`).  The four kernels are
hand-written CUDA: stencil SpMV and the sweep recursion on the solve paths
(one or many right-hand sides, over dense, shared or sample-compressed
factors, with the 5-point scheme's diagonal or the 9-point scheme's
tridiagonal coupling), the Gauss-Jordan panel inverse under every setup,
and the block-sparse product behind `bsr_matmat` / `bsr_matvec`;
everything else is plain PyTorch.  The package imports neither JAX nor the
JAX package; entry points run on the card unless the caller passes
`device="cpu"`.
"""

from .config import (HelmholtzConfig, PartitionConfig, PrecisionConfig,
                     PrecondConfig, SolverConfig)
from .core.sparse import BSR, COO, CSR, Stencil5, Stencil9
from .fd.assembly import Problem, assemble_problem, interlayer_couplings
from .fd import problems
from .ops.spmv import (bsr_matmat, bsr_matvec, coo_matvec, csr_matmat,
                       csr_matvec, stencil9_matvec, stencil_matvec,
                       stencil_matvec_flat)
from .solve import KrylovResult, bicgstab, gmres
from .driver import (SolveReport, build_preconditioner, run_multisolve,
                     run_solver)

__version__ = "0.1.0"
