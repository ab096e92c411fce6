"""The program's own spans in a traced run.

The port names its phases and layers in a running torch.profiler trace
(`navierstokes_project_nm4pde_tpu_torch/utils/profiling.py span`), as
`PREFIX + name`.  `nsbench/trace.py` keeps only user annotations whose
names start with `nsbench.`, so importing this module sets the program's
prefix to `nsbench.program.`: its spans then reach `Trace.spans` and
`Trace.span_device_s` under `program.<name>`, and need no change to the
trace reading.  The readers that import it are loaded before set-up in a
`--trace 1` run, so every span of the run carries that prefix.

A coupling that follows: the traced breakdown's idle-gap labels name the
innermost span where a gap begins, and that is now often a program span
(`program.krylov.fgmres.iter: cudaMemcpyAsync`): the attribution the
spans are for.  `device_idle_share`, `launches_per_step`, the rooflines
of the benchmark's own spans and `device_ops` read what they read without
them.

A program without these spans (an older commit) leaves `profiling` None:
each reader then returns nothing.
"""

from __future__ import annotations

from nsbench.trace import _union as union

PREFIX = "nsbench.program."

try:
    from navierstokes_project_nm4pde_tpu_torch.utils import profiling
except ImportError:
    profiling = None
if profiling is not None and hasattr(profiling, "sizes") and hasattr(profiling, "PREFIX"):
    profiling.PREFIX = PREFIX
else:
    profiling = None


def intervals(tr, name: str) -> list:
    """The [start, end] host intervals (us) of program span `name`."""
    return list(tr.spans.get(PREFIX + name, ()))


def names(tr) -> list:
    """The program spans in the trace, without the prefix."""
    return sorted(k[len(PREFIX):] for k, v in tr.spans.items() if k.startswith(PREFIX) and v)


def overlap(xs: list, ys: list) -> float:
    """The length of the intersection of two sorted, merged interval lists."""
    i = j = 0
    total = 0.0
    while i < len(xs) and j < len(ys):
        lo, hi = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        if hi > lo:
            total += hi - lo
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_inside(tr, ivs) -> float:
    """Seconds inside the union of host intervals `ivs` (clipped to the
    traced window) in which the device ran nothing."""
    inside = union((max(a, tr.t0), min(b, tr.t1)) for a, b in ivs if min(b, tr.t1) > max(a, tr.t0))
    return (sum(b - a for a, b in inside) - overlap(inside, tr.busy)) / 1e6


def recorded_calls(tr, name: str):
    """The sizes the program recorded for each call of span `name` while
    the profiler ran, or None where there is no such record or its count
    differs from the spans in the trace."""
    if profiling is None:
        return None
    calls = profiling.sizes(name)
    if not calls or len(calls) != len(intervals(tr, name)):
        return None
    return calls
