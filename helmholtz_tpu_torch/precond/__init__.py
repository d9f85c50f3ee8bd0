from .sweeping import (SweepingPreconditioner, apply_preconditioner,
                       setup_preconditioner)
from .sweeping9 import (SweepingPreconditioner9, apply_preconditioner9,
                        setup_preconditioner9)

__all__ = ["SweepingPreconditioner", "SweepingPreconditioner9",
           "apply_preconditioner", "apply_preconditioner9",
           "setup_preconditioner", "setup_preconditioner9"]
