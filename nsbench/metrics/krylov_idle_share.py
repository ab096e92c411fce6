"""krylov_idle_share (%): the device's idle time inside the program's
Krylov spans (`solvers/krylov.py`: each FGMRES, CG, recycled-CG and GCR
iteration, and each FGMRES cycle's back substitution and update; the
union of the `nsbench.program.krylov.*` host intervals), as a share of
the traced window (`Trace.busy`, `t0`, `t1`).  The rest of the idle share
lies outside the iterations: the step's other phases and the host reads
between them.  Moves steps_per_s: the host's Python, its reads of each
iteration's residual and its launches leave the device waiting inside
the loop.  Loading this reader sets the program's span prefix
(`nsbench/program_spans.py`)."""

from nsbench import program_spans


def read(ctx):
    tr = ctx.trace
    if tr is None or program_spans.profiling is None or not tr.busy_s() > 0.0:
        return None
    ivs = [iv for n in program_spans.names(tr) if n.startswith("krylov.") for iv in program_spans.intervals(tr, n)]
    if not ivs:
        return None
    return 100.0 * program_spans.idle_inside(tr, ivs) / tr.window_s()
