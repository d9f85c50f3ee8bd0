"""One thread budget for every pytest process of this repository.

It is set here, at the root, because pytest loads this file before the
conftest files under it, so the budget is in force before torch or jax is
imported.  Under pytest-xdist each worker gets `THREADS = cores // workers`
threads (at least one) and its environment variables are assigned, since a
worker inherits those of the controlling process; without xdist they are
only defaulted to all cores, so a caller's own setting stands.  The budget
covers every pool a process owns: OpenMP, MKL and OpenBLAS through their
environment variables, torch's intra-op pool, and XLA:CPU's Eigen pool
through `--xla_cpu_multi_thread_eigen=false`.  Subprocesses that tests start
inherit the environment.  Without it each of several workers sizes every
pool to all of the host's cores and the workers starve one another.
"""
import os
import sys

_POOLS = ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS")
_cores = len(os.sched_getaffinity(0))
_workers = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
if _workers:
    THREADS = max(1, _cores // int(_workers))
    for _var in _POOLS:
        os.environ[_var] = str(THREADS)
else:
    for _var in _POOLS:
        os.environ.setdefault(_var, str(_cores))
    THREADS = int(os.environ["OMP_NUM_THREADS"])

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_cpu_multi_thread_eigen" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_cpu_multi_thread_eigen=false").strip()

import torch  # noqa: E402

torch.set_num_threads(THREADS)
if _workers and "numpy" in sys.modules:
    # a pytest plugin (jaxtyping's) imported numpy before this file ran, so
    # its OpenBLAS sized its pool from the controller's environment; without
    # xdist that environment is the budget already
    from threadpoolctl import threadpool_limits
    threadpool_limits(THREADS)
