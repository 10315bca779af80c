"""Start the ranks of a mesh as local processes: the single-machine
counterpart of ``torchrun``.

    results = launch(fn, 4, backend="gloo", device="cpu", args=(...))

Each rank is a process started with ``torch.multiprocessing``'s ``spawn``
method, so ``fn`` must live in an importable module (one that does not
import JAX, or every rank pays for it). The rank's default process group is
initialized before ``fn(*args)`` runs, through a ``file://`` store in a
fresh temporary directory, so launches that run at once never contend for
a TCP port; ``fn`` then builds its mesh with ``mesh.make_mesh``. Each
rank's return value comes back pickled.
"""

from __future__ import annotations

import datetime
import os
import pickle
import shutil
import tempfile
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from . import mesh as PM


def _rank_main(rank, fn, args, world, backend, device, out_dir):
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(world))
    if device is not None and torch.device(device).type == "cuda":
        dev = torch.device(device)
        torch.cuda.set_device(dev.index if dev.index is not None else rank)
    store = "file://" + os.path.join(out_dir, "store")
    dist.init_process_group(backend, init_method=store, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=PM.DEFAULT_TIMEOUT_S))
    try:
        result = fn(*args)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as fh:
        pickle.dump(result, fh)


def _stop(processes) -> None:
    for p in processes:
        if p.is_alive():
            p.terminate()
    for p in processes:
        p.join(5)
        if p.is_alive():
            p.kill()
            p.join()


def launch(fn, world_size: int, backend: str = "nccl", device=None, args=(),
           timeout: float = 600.0) -> list:
    """Run ``fn(*args)`` on ``world_size`` local ranks and return their
    return values in rank order.

    ``device``: 'cuda' pins rank r to cuda:r (NCCL's one GPU a rank, the
    default for nccl); 'cuda:0' pins every rank to that card (gloo only);
    'cpu' or None with gloo leaves the ranks on the CPU. Raises before
    starting anything where the backend cannot run that many ranks, and
    raises if a rank fails (the others are stopped) or the ranks have not
    all finished within ``timeout`` seconds."""
    if device is None and backend == "nccl":
        device = "cuda"
    if backend == "nccl" and world_size > 1 and torch.device(device).index is not None:
        raise ValueError("backend 'nccl' needs one GPU a rank: ranks sharing one card "
                         "need backend='gloo'")
    PM.check_backend(backend, world_size, device)
    out_dir = tempfile.mkdtemp(prefix="pc_launch_")
    try:
        ctx = mp.start_processes(_rank_main, nprocs=world_size, join=False, start_method="spawn",
                                 args=(fn, tuple(args), world_size, backend, device, out_dir))
        deadline = time.monotonic() + timeout
        try:
            while not ctx.join(timeout=max(0.1, deadline - time.monotonic())):
                if time.monotonic() >= deadline:
                    raise TimeoutError(f"{world_size} ranks did not finish within {timeout} s")
        finally:
            _stop(ctx.processes)
        results = []
        for r in range(world_size):
            with open(os.path.join(out_dir, f"rank{r}.pkl"), "rb") as fh:
                results.append(pickle.load(fh))
        return results
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
