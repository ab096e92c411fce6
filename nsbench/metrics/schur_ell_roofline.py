"""schur_ell_roofline (%): the per-step Schur operator's ELL SpMV
(`ops/schur_ell.py schur_ell_matvec`: a gather of p and a row sum over each
valence bucket's padded block, span `schur.ell_matvec`, once an iteration
of the block preconditioner's fixed CG on S~) as a share of its roofline.
The device time is that of the kernels launched inside the program's span;
each call's bytes and operations come from the sizes it recorded (each
bucket's rows and width, n_p, cols, vcols, itemsize, index_itemsize), by
the rule of `nsbench/roofline.py`: the values read once at their stored
width, slots vcols itemsize bytes (slots the sum of rows x width; vcols 1
for values shared by the columns), the column index read once, slots
index_itemsize, p in and the result out once each, 2 n_p cols itemsize (the
padding mask is not counted), against 2 slots cols operations.  Not read
where the recorded calls and the spans differ in number.  Moves
device_ms_per_step.  Loading this reader sets the program's span prefix
(`nsbench/program_spans.py`)."""

from nsbench import program_spans
from nsbench.roofline import share_percent

NAME = "schur.ell_matvec"


def cost(z: dict):
    slots = sum(r * w for r, w in zip(z["rows"], z["width"]))
    s, cols = z["itemsize"], z["cols"]
    nbytes = slots * z["vcols"] * s + slots * z["index_itemsize"] + 2 * z["n_p"] * cols * s
    return nbytes, 2 * slots * cols, s


def read(ctx):
    tr = ctx.trace
    calls = None if tr is None else program_spans.recorded_calls(tr, NAME)
    if calls is None:
        return None
    return share_percent([cost(z) for z in calls], tr.span_device_s("program." + NAME))
