"""Rank-0 printing (the reference's ConditionalOStream pcout;
ref: include/NavierStokes2D.hpp:154).  Under torch.distributed every rank
runs the same program; only rank 0 prints what the user reads."""

from __future__ import annotations


def is_main_process() -> bool:
    """True on rank 0 of the default process group, or without one."""
    import torch.distributed as dist

    return not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0


def pcout(*args, **kwargs) -> None:
    """print() on the main process only."""
    if is_main_process():
        print(*args, **kwargs)
