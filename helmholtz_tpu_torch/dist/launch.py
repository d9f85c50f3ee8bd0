"""Start the ranks of the distributed path: one process per rank.

    run_ranks(fn, world_size, device="cuda", **kw)

runs `fn(device=<this rank's device>, **kw)` on every rank and returns rank
0's result.  When a process group of that size is already initialized
(`torchrun`, or `dist.multihost.initialize`), `fn` runs in place on every
rank.  Otherwise `world_size` processes are spawned (the `spawn` start
method); they meet through a `FileStore` in a fresh temporary directory, so
no TCP port is chosen and parallel launches cannot clash.  `fn` must be a
module-level function (it is pickled by name), and what it returns on rank
0 comes back pickled.

Rank r computes on `cuda:{r % device_count}`, or on the CPU when asked.
The backend follows from the hardware and the request, never from a
failure: NCCL when every rank of a host has a card of its own, gloo
otherwise (and always on the CPU); the ranks of a host are all of them when
spawned here, else torchrun's LOCAL_WORLD_SIZE or the count given.  NCCL refuses two ranks on one card, so ranks that
share a card run under gloo, which stages their rows and sums through host
memory (`dist.comm`).  A failed NCCL initialization raises.

The CUDA kernels are built in the launching process before any rank
starts, so the ranks never race on the build directory.  The process group
gets a timeout (`GROUP_TIMEOUT_S`), the launcher a limit for the whole run
(`RANK_LIMIT_S`): a rank that dies, raises or outlives the limit ends every
rank and raises here.
"""
from __future__ import annotations

import datetime
import os
import pickle
import queue
import shutil
import tempfile
import time
import traceback

import torch
import torch.distributed as dist

from .._device import resolve_device

#: seconds a collective or a point-to-point move may wait for its peers
GROUP_TIMEOUT_S = 300

#: seconds the launcher waits for all ranks of one `run_ranks` call
RANK_LIMIT_S = 1800

_STATE = {"device": None, "local": None}


def rank_device():
    """The device the launcher (or `multihost.initialize`) gave this rank;
    None outside a rank."""
    return _STATE["device"]


def local_world_size(world_size: int, local: int | None = None) -> int:
    """The ranks on this host: `local` when given, else the
    LOCAL_WORLD_SIZE that `torchrun` sets, else `world_size` (every rank
    on this host, as `run_ranks` spawns them)."""
    if local is None:
        local = int(os.environ.get("LOCAL_WORLD_SIZE", world_size))
    return local


def local_ranks(world_size: int) -> int:
    """The ranks on this host of a group of `world_size`, as this rank
    joined it (`init_rank`), else as `local_world_size` finds them."""
    return _STATE["local"] or local_world_size(world_size)


def choose_backend(device, local: int, backend=None) -> str:
    """NCCL when each of the `local` ranks on this host has a card of its
    own, gloo otherwise; an explicit `backend` is checked against that
    rule.  Ranks on other hosts have their own cards and do not count."""
    dev = torch.device(device)
    if dev.type == "cpu":
        if backend not in (None, "gloo"):
            raise ValueError(f"backend {backend!r} on the CPU: only gloo "
                             "runs there")
        return "gloo"
    own_card = torch.cuda.device_count() >= local
    if backend is None:
        return "nccl" if own_card else "gloo"
    if backend == "nccl" and not own_card:
        raise ValueError(
            f"NCCL needs a card per rank: {local} ranks on this host's "
            f"{torch.cuda.device_count()} cards (NCCL refuses two ranks on "
            "one GPU); use gloo")
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"unknown backend {backend!r}")
    return backend


def ranks_per_card(device, local: int):
    """Ranks that share one card, from the `local` ranks on this host
    (None on the CPU)."""
    if torch.device(device).type == "cpu":
        return None
    return -(-local // max(1, torch.cuda.device_count()))


def device_of_rank(device, rank: int) -> torch.device:
    """cuda:{rank % device_count} for the card (raising without one), the
    CPU when asked."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return dev
    count = torch.cuda.device_count()
    if count < 1:
        raise RuntimeError(f"rank {rank}: no CUDA device is visible")
    return torch.device("cuda", rank % count)


def init_rank(rank: int, world_size: int, *, device, backend=None,
              init_method=None, store=None, local: int | None = None,
              timeout: float = GROUP_TIMEOUT_S) -> torch.device:
    """Join the process group as `rank` of `world_size` and take this
    rank's device; `local`: the ranks on this host (`local_world_size`).
    Raises if the device cannot be reached or the group cannot be
    formed."""
    dev = device_of_rank(device, rank)
    local = local_world_size(world_size, local)
    backend = choose_backend(dev, local, backend)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        torch.empty(1, device=dev)          # reach the device now
    dist.init_process_group(
        backend, init_method=init_method, store=store, rank=rank,
        world_size=world_size,
        timeout=datetime.timedelta(seconds=timeout))
    # one collective of every rank first: NCCL leaves a first
    # point-to-point batch that not every rank joins undefined
    dist.barrier()
    _STATE.update(device=dev, local=local)
    return dev


def _child(fn, rank, world_size, backend, device, tmp, timeout, threads,
           results):
    try:
        torch.set_num_threads(threads)
        with open(os.path.join(tmp, "job.pkl"), "rb") as fh:
            kw = pickle.load(fh)
        store_path = os.path.join(tmp, "store")
        store = dist.FileStore(store_path, world_size)
        dev = init_rank(rank, world_size, device=device, backend=backend,
                        store=store, local=world_size, timeout=timeout)
        out = fn(device=dev, **kw)
        results.put((rank, True, out if rank == 0 else None))
    except Exception:
        # the launcher reports it; a rank that exits without a result
        # (SystemExit, a signal) is caught there as a dead rank
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(fn, world_size: int, *, device, backend=None, **kw):
    """Run `fn(device=..., **kw)` on `world_size` ranks; rank 0's result.
    A spawned rank takes one torch thread on the CPU and its share of the
    host's cores on the card."""
    dev = resolve_device(device)
    if dist.is_available() and dist.is_initialized():
        if dist.get_world_size() != world_size:
            raise ValueError(
                f"{world_size} ranks requested inside a process group of "
                f"{dist.get_world_size()}")
        return fn(device=rank_device() or device_of_rank(dev,
                                                         dist.get_rank()),
                  **kw)
    backend = choose_backend(dev, world_size, backend)
    if dev.type == "cuda":
        if torch.cuda.device_count() < 1:
            raise RuntimeError("no CUDA device is visible")
        from ..ops.kernels import build
        build.build()
    threads = (1 if dev.type == "cpu"
               else max(1, (os.cpu_count() or 1) // world_size))
    ctx = torch.multiprocessing.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="helmholtz_ranks_")
    # the arguments go through a file: handed to `Process` they would be
    # written down each child's pipe, and each `start()` would wait for its
    # child to get far enough to read them, one child after the other
    with open(os.path.join(tmp, "job.pkl"), "wb") as fh:
        pickle.dump(kw, fh)
    results = ctx.Queue()
    procs = [ctx.Process(
        target=_child, daemon=True,
        args=(fn, r, world_size, backend, dev.type, tmp, GROUP_TIMEOUT_S,
              threads, results)) for r in range(world_size)]
    try:
        for p in procs:
            p.start()
        got = _collect(procs, results, RANK_LIMIT_S)
    finally:
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join()
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
    return got[0]


def _collect(procs, results, limit: float) -> dict:
    """Every rank's result, raising as soon as one fails, dies or the
    limit passes."""
    got = {}
    deadline = time.monotonic() + limit
    while len(got) < len(procs):
        try:
            rank, ok, payload = results.get(timeout=1.0)
        except queue.Empty:
            if time.monotonic() > deadline:
                _kill(procs)
                raise TimeoutError(
                    f"ranks {sorted(set(range(len(procs))) - set(got))} "
                    f"did not finish within {limit:.0f} s")
            dead = [r for r, p in enumerate(procs)
                    if r not in got and not p.is_alive()]
            if dead:
                time.sleep(1.0)                 # a last result in flight
                if results.empty():
                    _kill(procs)
                    raise RuntimeError(
                        f"rank(s) {dead} exited with code "
                        f"{[procs[r].exitcode for r in dead]} and no result")
            continue
        if not ok:
            _kill(procs)
            raise RuntimeError(f"rank {rank} failed:\n{payload}")
        got[rank] = payload
    return got


def _kill(procs) -> None:
    for p in procs:
        if p.is_alive():
            p.kill()
