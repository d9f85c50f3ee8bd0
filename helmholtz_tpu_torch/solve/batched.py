"""Batched Krylov solves: multi-RHS and multi-problem.

The sweep recursion is bound by the stream of the G stack, and a batch of
right-hand sides can ride one stream (`precond.sweeping.
apply_preconditioner_multi`).  So the multi-RHS solve runs the members'
GMRES loops in LOCKSTEP, one batched operator product and one batched
preconditioner apply per step for every member still iterating, while each
member keeps its own loop state: its own iteration count at which it leaves
the inner loop, its own least-squares problem and back-substitution, its own
recomputed residual and stagnation guard.  A member's iterations, flags,
history and x are those of its single solve and do not depend on who else is
in the batch (up to the rounding of the batched products).  The loop is
`solve.gmres.gmres_batched`; `method="bicgstab"` runs the lockstep
`solve.bicgstab.bicgstab_batched` the same way.

  * multi-RHS: one operator/preconditioner, a batch of forcings (for example
    many sources at one frequency);
  * multi-problem: a batch of (A, M, f) triples, each with its own operator
    and factor stack; nothing is shared, so the solves run one after another.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch

from .bicgstab import bicgstab, bicgstab_batched
from .gmres import KrylovResult, gmres, gmres_batched

_METHODS = {"gmres": (gmres, gmres_batched),
            "bicgstab": (bicgstab, bicgstab_batched)}


def _method(method: str):
    if method not in _METHODS:
        raise ValueError(f"unknown method {method!r}")
    return _METHODS[method]


def stack_results(results: Sequence[KrylovResult]) -> KrylovResult:
    """Single solves as one batched KrylovResult."""
    return KrylovResult(
        x=torch.stack([r.x for r in results]),
        iterations=np.array([r.iterations for r in results]),
        converged=np.array([r.converged for r in results]),
        breakdown=np.array([r.breakdown for r in results]),
        residual_norm=np.array([r.residual_norm for r in results]),
        history=np.stack([r.history for r in results]))


def solve_multi_rhs(matvec: Callable, B: torch.Tensor, *,
                    M: Optional[Callable] = None,
                    method: str = "gmres", **kw) -> KrylovResult:
    """Solve A X = B for B of shape (batch, N).  Per-RHS convergence: each
    batch element runs its own iteration count; the batch runs until the
    slowest member finishes, and finished members take no part in the
    products.

    `matvec` and `M` map (k, N) batches to (k, N) batches.  A
    SweepingPreconditioner passed as `M` is applied through its
    `apply_multi`, so the whole batch rides one stream of its G stack per
    application; a RecomputeSweepingPreconditioner likewise, so the batch
    shares each chunk's re-factorization."""
    from ..precond.recompute import RecomputeSweepingPreconditioner
    from ..precond.sweeping import SweepingPreconditioner

    _, batched = _method(method)
    if isinstance(M, (SweepingPreconditioner,
                      RecomputeSweepingPreconditioner)):
        M = M.apply_multi
    return batched(matvec, B, M=M, **kw)


def solve_multi_problem(matvecs_data: Sequence, apply_matvec: Callable,
                        B: torch.Tensor, *,
                        precond_data: Optional[Sequence] = None,
                        apply_precond: Optional[Callable] = None,
                        method: str = "gmres", **kw) -> KrylovResult:
    """Solve a batch of independent systems {A_i x_i = b_i, M_i}.

    `matvecs_data` / `precond_data` are sequences with one entry per problem
    (for example Stencil5 operators and SweepingPreconditioner states);
    `apply_matvec(data_i, v)` / `apply_precond(pdata_i, v)` define the
    per-problem operators on flat (N,) vectors.  The problems share neither
    operator nor factor stack, so they are solved one after another and the
    results stacked."""
    single, _ = _method(method)
    results = []
    for i, f_i in enumerate(B):
        mv = lambda v, d=matvecs_data[i]: apply_matvec(d, v)
        Mi = None
        if apply_precond is not None:
            Mi = lambda v, d=precond_data[i]: apply_precond(d, v)
        results.append(single(mv, f_i, M=Mi, **kw))
    return stack_results(results)
