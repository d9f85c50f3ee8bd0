"""The thread budget of the root `conftest.py` holds in every test process:
a module that raises a pool's size again makes parallel workers starve one
another, and this test fails in the worker that ran it."""
import os

import torch
from threadpoolctl import threadpool_info


def test_thread_budget_holds(request):
    budget = request.config.pluginmanager.get_plugin(
        str(request.config.rootpath / "conftest.py"))
    k = budget.THREADS
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    assert k == 1 or k * workers <= len(os.sched_getaffinity(0))
    assert torch.get_num_threads() == k
    assert "--xla_cpu_multi_thread_eigen=false" in os.environ["XLA_FLAGS"]
    pools = {(p["internal_api"], p["filepath"]): p["num_threads"]
             for p in threadpool_info()}
    assert all(n <= k for n in pools.values()), pools
