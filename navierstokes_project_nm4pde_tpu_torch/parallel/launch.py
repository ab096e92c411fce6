"""Local ranks under torch.distributed: one spawned interpreter a rank.

The reference package is single-controller SPMD over a device mesh; the
port runs one process a rank instead.  `launch(fn, n, ...)` spawns n
interpreters on this host, joins them to one process group through a file
store in a temporary directory (no port to pick, nothing to clash with
under parallel test workers), runs `fn(rank, world_size, device, *args)`
on each, and returns each rank's return value.  Rank r computes on
`cuda:(r % device_count)` (or the CPU), so two ranks may share a card.

The backend is chosen by what the ranks hold: NCCL when every rank has a
card of its own (NCCL refuses two ranks on one card), else gloo, which
moves CUDA tensors for all-reduce and broadcast only: the halo exchange
of `parallel/halo.py` then stages its point-to-point slabs through host
memory.  `backend_for` makes the choice; every rank's computation stays
on its device.
"""

from __future__ import annotations

import datetime
import os
import pickle
import sys
import tempfile

import torch

# The last `launch`: each rank's return value ("results") and the
# top-level modules it had imported ("modules": a run's proof that no rank
# imported what the port must not).
last_launch: dict = {"results": [], "modules": []}


def backend_for(device: str, world_size: int) -> str:
    """"nccl" when every rank has a card of its own, else "gloo"."""
    if device == "cuda" and torch.cuda.is_available() and torch.cuda.device_count() >= world_size:
        return "nccl"
    return "gloo"


def rank_device(device: str, rank: int) -> torch.device:
    """The device rank `rank` computes on: cuda:(rank % device_count), or
    the CPU."""
    if device == "cuda":
        return torch.device("cuda", rank % torch.cuda.device_count())
    return torch.device("cpu")


def launch(fn, world_size: int, *args, device: str = "cuda", timeout: float = 900.0) -> list:
    """Run fn(rank, world_size, device, *args) on `world_size` spawned local
    ranks joined in one process group (`fn` and `args` must pickle); a
    collective that waits longer than `timeout` seconds raises on its rank.
    Returns the ranks' return values in rank order; raises if a rank
    raised."""
    import torch.multiprocessing as mp

    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: launch(..., device='cpu') runs the ranks on the CPU")
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(_entry, args=(fn, world_size, device, tmp, timeout, args), nprocs=world_size, join=True)
        results = []
        for r in range(world_size):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                results.append(pickle.load(f))
    last_launch.update(results=[out for out, _ in results], modules=[mods for _, mods in results])
    return last_launch["results"]


def _entry(rank, fn, world_size, device, tmp, timeout, args):
    import torch.distributed as dist

    dev = rank_device(device, rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    else:  # the ranks share the host's cores
        torch.set_num_threads(max(1, torch.get_num_threads() // world_size))
    dist.init_process_group(
        backend_for(device, world_size), init_method=f"file://{os.path.join(tmp, 'store')}",
        rank=rank, world_size=world_size, timeout=datetime.timedelta(seconds=timeout),
    )
    try:
        out = fn(rank, world_size, dev, *args)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    mods = sorted({m.split(".")[0] for m in sys.modules})
    with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump((out, mods), f)
