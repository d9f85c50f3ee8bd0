from .batched import gmres_batched, solve_multi_problem, solve_multi_rhs
from .bicgstab import bicgstab, bicgstab_batched
from .gmres import KrylovResult, gmres
from .ir import ir_gmres, ir_gmres_batched

__all__ = ["KrylovResult", "bicgstab", "bicgstab_batched", "gmres",
           "gmres_batched", "ir_gmres", "ir_gmres_batched",
           "solve_multi_problem", "solve_multi_rhs"]
