"""coarse_solve_roofline (%): the two-level pressure preconditioner's
coarse solve (`ops/coarse.py cho_solve_c` / `inv_solve_c`, span
`precond.coarse_solve`, once a preconditioner application) as a share of
its roofline.  The device time is that of the kernels launched inside
the program's span; each call's bytes and operations come from the sizes
it recorded (nc, cols, factors, itemsize, form), by the rule of
`nsbench/roofline.py`: for "chol" each of the two triangular solves
reads the factor's lower triangle once, 2 factors nc (nc + 1) / 2 s
bytes; for "inv" the inverse is read once, factors nc^2 s; both move the
coarse vector in and out, 2 nc cols s, and count 2 nc^2 cols operations.
Not read where the recorded calls and the spans differ in number.  Moves
steps_per_s.  Loading this reader sets the program's span prefix
(`nsbench/program_spans.py`)."""

from nsbench import program_spans
from nsbench.roofline import share_percent

NAME = "precond.coarse_solve"


def cost(z: dict):
    nc, cols, factors, s = z["nc"], z["cols"], z["factors"], z["itemsize"]
    factor = 2 * factors * nc * (nc + 1) // 2 * s if z["form"] == "chol" else factors * nc * nc * s
    return factor + 2 * nc * cols * s, 2 * nc * nc * cols, s


def read(ctx):
    tr = ctx.trace
    calls = None if tr is None else program_spans.recorded_calls(tr, NAME)
    if calls is None:
        return None
    return share_percent([cost(z) for z in calls], tr.span_device_s("program." + NAME))
