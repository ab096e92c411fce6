"""schur_matvec_roofline (%): the frozen pressure Schur operator's banded
matvec (`ops/banded.py banded_matvec`: the window gather and one batched
product, span `schur.banded_matvec`, once a CG iteration and a residual)
as a share of its roofline.  The device time is that of the kernels
launched inside the program's span; each call's bytes and operations come
from the sizes it recorded (blocks, rows, width, n_rows, cols, itemsize),
by the rule of `nsbench/roofline.py`: the band values read once, blocks
rows width s bytes, p in and out once each, 2 n_rows cols s, the tile
index at 4 bytes a tile, 4 blocks width / TILE, against 2 blocks rows
width cols operations.  Not read where the recorded calls and the spans
differ in number.  Moves steps_per_s.  Loading this reader sets the
program's span prefix (`nsbench/program_spans.py`)."""

from nsbench import program_spans
from nsbench.roofline import share_percent

NAME = "schur.banded_matvec"
TILE = 128  # the band's column tile (ops/banded.py)


def cost(z: dict):
    blocks, rows, width, cols, s = z["blocks"], z["rows"], z["width"], z["cols"], z["itemsize"]
    nbytes = blocks * rows * width * s + 2 * z["n_rows"] * cols * s + 4 * blocks * width // TILE
    return nbytes, 2 * blocks * rows * width * cols, s


def read(ctx):
    tr = ctx.trace
    calls = None if tr is None else program_spans.recorded_calls(tr, NAME)
    if calls is None:
        return None
    return share_percent([cost(z) for z in calls], tr.span_device_s("program." + NAME))
