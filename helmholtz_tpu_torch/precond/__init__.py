from .exact import ExactFactorization, factor_exact
from .sweeping import (SweepingPreconditioner, apply_fixed_rhs,
                       apply_preconditioner, apply_preconditioner_multi,
                       setup_preconditioner)
from .sweeping9 import (SweepingPreconditioner9, apply_preconditioner9,
                        setup_preconditioner9)

__all__ = ["ExactFactorization", "SweepingPreconditioner",
           "SweepingPreconditioner9", "apply_fixed_rhs",
           "apply_preconditioner", "apply_preconditioner_multi",
           "apply_preconditioner9", "factor_exact", "setup_preconditioner",
           "setup_preconditioner9"]
