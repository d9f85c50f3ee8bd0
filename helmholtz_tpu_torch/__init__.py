"""The PyTorch/CUDA port of the JAX package that sits beside it.

Complex 2-D finite-difference Helmholtz assembly with PML, the Engquist-Ying
sweeping preconditioner with moving PML, and GMRES, on one NVIDIA H100.  The
two kernels of the solve paths (stencil SpMV and the sweep recursion, for
one or many right-hand sides, over dense, shared or sample-compressed
factors, with the 5-point scheme's diagonal or the 9-point scheme's
tridiagonal coupling) are hand-written CUDA; everything else is plain
PyTorch.  The
package imports neither JAX nor the JAX package; entry points run on the
card unless the caller passes `device="cpu"`.
"""

from .config import HelmholtzConfig, PrecondConfig, SolverConfig
from .core.sparse import Stencil5, Stencil9
from .fd.assembly import Problem, assemble_problem, interlayer_couplings
from .fd import problems
from .ops.spmv import stencil9_matvec, stencil_matvec, stencil_matvec_flat
from .solve import KrylovResult, gmres
from .driver import SolveReport, run_multisolve, run_solver

__version__ = "0.1.0"
