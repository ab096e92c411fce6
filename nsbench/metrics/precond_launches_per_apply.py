"""precond_launches_per_apply (launches/apply): the device kernels launched
inside the program's `precond.apply` spans (`precond/blocks.py
apply_precond`: one application of the block preconditioner, once an outer
FGMRES iteration of the monolithic step, with its F and S~ inner solves)
over the number of those spans, from the traced block's torch.profiler
trace (a kernel counts in the span whose host interval holds the runtime
call that launched it).  Not read where no kernel ran or no such span
opened.  Moves device_ms_per_step: each launch adds its start and its
tail to the device's time, and the host's dispatch of some thousand of
them an application sets the step's pace.  Loading this reader sets the
program's span prefix (`nsbench/program_spans.py`)."""

import bisect
from collections import Counter

from nsbench import program_spans

NAME = "precond.apply"


def read(ctx):
    tr = ctx.trace
    if tr is None or program_spans.profiling is None or tr.kernel_count() == 0:
        return None
    ivs = program_spans.intervals(tr, NAME)
    if not ivs:
        return None
    per_corr = Counter((e.get("args") or {}).get("correlation") for e in tr.kernels)
    per_corr.pop(None, None)
    launches = 0
    for a, b in ivs:
        lo, hi = bisect.bisect_left(tr.rt_ts, a), bisect.bisect_right(tr.rt_ts, b)
        launches += sum(per_corr.get(c, 0) for c in tr.rt_corr[lo:hi])
    return launches / len(ivs)
