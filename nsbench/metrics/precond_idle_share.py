"""precond_idle_share (%): the device's idle time inside the program's
`precond.apply` spans (`precond/blocks.py apply_precond`: each application
of the block preconditioner, with its fixed-count F and S~ inner solves;
the union of their host intervals), as a share of the traced window
(`Trace.busy`, `t0`, `t1`).  Moves device_ms_per_step: inside an
application the host launches some thousand kernels and reads nothing
back, so what the device waits there is the host's dispatch, and work
that leaves the device goes with launches the host no longer makes.  Loading this reader sets the
program's span prefix (`nsbench/program_spans.py`)."""

from nsbench import program_spans

NAME = "precond.apply"


def read(ctx):
    tr = ctx.trace
    if tr is None or program_spans.profiling is None or not tr.busy_s() > 0.0:
        return None
    ivs = program_spans.intervals(tr, NAME)
    if not ivs:
        return None
    return 100.0 * program_spans.idle_inside(tr, ivs) / tr.window_s()
