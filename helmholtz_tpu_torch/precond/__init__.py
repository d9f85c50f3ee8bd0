from .sweeping import (SweepingPreconditioner, apply_preconditioner,
                       setup_preconditioner)

__all__ = ["SweepingPreconditioner", "apply_preconditioner",
           "setup_preconditioner"]
