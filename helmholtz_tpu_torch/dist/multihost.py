"""Ranks on several hosts.

The layer-partitioned solve is topology-agnostic: once every process has
joined the process group, `global_layer_mesh()` is the mesh over all of
them, and the moves of `dist.comm` ride whatever fabric the backend uses.
`initialize` joins the group from explicit arguments or from the
environment `torchrun` sets (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT);
for a single process it is a no-op, as the JAX package's is.

    # on each of two hosts, with its own rank:
    initialize("tcp://10.0.0.1:29500", world_size=2, rank=r)
    run_multisolve(..., mesh_devices=2)     # runs in place on every rank
"""
from __future__ import annotations

import atexit
import os

import torch
import torch.distributed as dist

from . import launch
from .partition import LAYER_AXIS, LayerMesh, make_mesh


def initialize(init_method: str | None = None,
               world_size: int | None = None, rank: int | None = None, *,
               backend: str | None = None, device="cuda",
               local: int | None = None,
               timeout: float = launch.GROUP_TIMEOUT_S) -> dict:
    """Join the process group (a no-op for one process or when the group
    exists).  `local`: the ranks on this host (default: torchrun's
    LOCAL_WORLD_SIZE, else all of them); the backend is chosen from it
    (`launch.choose_backend`).  Returns a topology summary {processes,
    process_index, local_devices, global_devices}: one device per rank.
    A group joined here is destroyed at exit."""
    if world_size is None and "WORLD_SIZE" in os.environ:
        world_size = int(os.environ["WORLD_SIZE"])
        rank = int(os.environ["RANK"])
        init_method = init_method or "env://"
    if world_size and world_size > 1 and not dist.is_initialized():
        launch.init_rank(rank, world_size, device=device, backend=backend,
                         init_method=init_method, local=local,
                         timeout=timeout)
        # left to the interpreter's teardown, the group can abort the
        # process as it exits; JAX's `initialize` also shuts down at exit
        atexit.register(_leave_group)
    procs = dist.get_world_size() if dist.is_initialized() else 1
    dev = torch.device(device)
    local = torch.cuda.device_count() if dev.type == "cuda" else 1
    return {
        "processes": procs,
        "process_index": dist.get_rank() if dist.is_initialized() else 0,
        "local_devices": local,
        "global_devices": procs,
    }


def _leave_group() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def global_layer_mesh(axis_name: str = LAYER_AXIS) -> LayerMesh:
    """The 1-D mesh over every rank of every host, in rank order: consecutive
    bands sit on consecutive ranks, so a launcher that numbers the ranks of
    one host together keeps the halo moves inside hosts but at host
    boundaries."""
    return make_mesh(axis_name=axis_name)
