from .batched import gmres_batched, solve_multi_problem, solve_multi_rhs
from .gmres import KrylovResult, gmres
from .ir import ir_gmres, ir_gmres_batched

__all__ = ["KrylovResult", "gmres", "gmres_batched", "ir_gmres",
           "ir_gmres_batched", "solve_multi_problem", "solve_multi_rhs"]
