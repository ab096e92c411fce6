"""setup_solver_s (s): the host seconds of the program's own set-up
phases, summed (`utils/profiling.py setup_seconds()`: the node reorder,
the Taylor-Hood space, the operator, the boundary tables, the frozen
Schur and its banded form, the coarse factor, the plans built at first
use in the warm-up steps, and the kernel library's load, with nvcc on a
checkout's first run).  Each phase counts its own time, so a phase nested
in another is counted once.  Read in the --trace 1 run, whose set-up is
the --trace 0 run's; on the card only (the CPU loads no kernel library).
Moves setup_s: the rest of it is imports, the mesh and the warm-up steps'
own work.  Loading this reader sets the program's span prefix
(`nsbench/program_spans.py`)."""

from nsbench import program_spans


def read(ctx):
    if not ctx.on_card or program_spans.profiling is None:
        return None
    phases = program_spans.profiling.setup_seconds()
    return sum(phases.values()) if phases else None
