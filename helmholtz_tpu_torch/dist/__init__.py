"""The distributed path: the grid rows in bands over ranks, one process per
rank on `torch.distributed` (`launch.run_ranks`, `multihost.initialize`).

Each rank holds its band of rows as ordinary tensors on its own device and
runs the band's kernels: the stencil product (K1) inside the halo-exchange
band product, the sweep kernel (K2) for its band of the staged sweep, the
Gauss-Jordan kernel (K3) under its band's setup.  The moves between bands
are explicit (`comm`): halo rows, sweep carries, sums.
"""
from .factor import (distributed_assemble, distributed_assemble9,
                     distributed_setup, distributed_setup9)
from .launch import run_ranks
from .partition import (LAYER_AXIS, DistSweepState, DistSweepState9,
                        LayerMesh, dist_state_from_preconditioner, make_mesh,
                        shard_problem)
from .solve import distributed_solve
from .spmv import halo_stencil9_matvec, halo_stencil_matvec
from .sweep import dist_apply_preconditioner
