"""Profiling helpers: torch.profiler trace capture around solver phases.

The counterpart of the reference's `utils/profiling.py` (`trace`,
`annotate`).  `trace(dir)` records the host and the card's kernels of
the enclosed region and writes a Chrome trace (open it in Perfetto or
chrome://tracing) and the kernel table under `dir`; `annotate(name)`
names a region in that timeline."""

from __future__ import annotations

import contextlib
import os


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a torch.profiler trace of the enclosed region into
    `log_dir` (trace.json and kernels.txt)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
    sort = "self_device_time_total" if torch.cuda.is_available() else "self_cpu_time_total"
    with open(os.path.join(log_dir, "kernels.txt"), "w") as f:
        f.write(prof.key_averages().table(sort_by=sort, row_limit=50))


def annotate(name: str):
    """Named region of the trace (a context manager)."""
    from torch.profiler import record_function

    return record_function(name)
