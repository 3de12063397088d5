"""Run a function on every rank of a fresh process group: the launcher the
multi-device CLI (`launch.run_palid --devices D`), the examples and the
tests share.

`run_ranks(fn, world, *args, devices=...)` spawns `world` processes with
`torch.multiprocessing` (start method "spawn"), each joining a process
group through a `file://` rendezvous in a temporary directory (no port is
fixed, so several groups can run side by side), and calls
`fn(rank, world, *args)` on each. By default rank r runs on card r
(`rank_devices`); the CPU is asked for with `devices=["cpu"] * world`. A
rank on a CUDA device uses NCCL unless `backend` says otherwise; CPU ranks
use gloo. Each rank's return value is pickled back to the parent, which
returns them in rank order. A rank that raises (or dies) fails the whole
call: the parent terminates the others and raises; a stuck collective
fails its rank after `PG_TIMEOUT_S`; a run past `timeout` seconds (None:
no limit) is terminated and raises TimeoutError.
"""

from __future__ import annotations

import datetime
import os
import pickle
import shutil
import tempfile
import time
from typing import Optional, Sequence

import torch

# how long a rank waits for its peers in a collective or the rendezvous
PG_TIMEOUT_S = 120.0


def rank_devices(device: str, n: int) -> list[str]:
    """The device of each of `n` ranks: a card each on CUDA (NCCL between
    them), or the CPU for all (gloo). More ranks than cards raises a
    ValueError naming the count."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return [str(dev)] * n
    count = torch.cuda.device_count()
    if n > count:
        raise ValueError(f"--devices {n} needs {n} CUDA devices, one a "
                         f"rank; this host has {count}")
    return [f"cuda:{r}" for r in range(n)]


def _rank_main(rank, fn, world, init, backend, devices, threads, out_dir,
               args):
    import torch.distributed as dist
    if threads:
        torch.set_num_threads(threads)
    dev = torch.device(devices[rank])
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    kw = dict(backend=backend, init_method=init, rank=rank,
              world_size=world,
              timeout=datetime.timedelta(seconds=PG_TIMEOUT_S))
    if backend == "nccl":
        kw["device_id"] = dev
    dist.init_process_group(**kw)
    try:
        out = fn(rank, world, *args)
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def run_ranks(fn, world: int, *args, devices: Optional[Sequence] = None,
              backend: Optional[str] = None,
              timeout: Optional[float] = None) -> list:
    """fn(rank, world, *args) on `world` spawned ranks; their results in
    rank order. `devices` names each rank's device (default: card r for
    rank r, `rank_devices("cuda", world)`). On the CPU each rank's torch
    takes the host's cores split over the ranks, but no more threads than
    the caller's own. `fn` and `args` must pickle (a module-level
    function)."""
    import torch.multiprocessing as mp
    devices = [str(d) for d in (devices or rank_devices("cuda", world))]
    if len(devices) != world:
        raise ValueError(f"{len(devices)} devices for {world} ranks")
    on_card = torch.device(devices[0]).type == "cuda"
    backend = backend or ("nccl" if on_card else "gloo")
    threads = None if on_card else max(1, min(
        torch.get_num_threads(), (os.cpu_count() or 1) // world))
    tmp = tempfile.mkdtemp(prefix="ranks_")
    try:
        init = "file://" + os.path.join(tmp, "rendezvous")
        ctx = mp.start_processes(
            _rank_main, args=(fn, world, init, backend, devices, threads,
                              tmp, args),
            nprocs=world, join=False, start_method="spawn")
        deadline = None if timeout is None else time.monotonic() + timeout
        try:
            while not ctx.join(timeout=1.0):
                if deadline is not None and time.monotonic() > deadline:
                    raise TimeoutError(
                        f"{world} ranks of {getattr(fn, '__name__', fn)} "
                        f"ran past {timeout:.0f} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.terminate()
            for p in ctx.processes:
                p.join(10)
                if p.is_alive():
                    p.kill()
        out = []
        for r in range(world):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
