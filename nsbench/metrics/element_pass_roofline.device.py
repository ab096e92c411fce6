"""element_pass_roofline.device (%): `element_pass_roofline` in a cell
whose step is timed on the device: the benchmark's span around `apply_F`
under this metric's name, each call's cost by the base reader's rule.  In
a single run the folded F_e is [E, nloc, nloc] and u [n, 3] (the block
preconditioner's F solves: kernel D's gather, the element product, kernel
C's reduce).  Moves device_ms_per_step."""

from nsbench.metrics import element_pass_roofline as base
from nsbench.roofline import share_percent

SPAN, cost = base.SPAN, base.cost
NAME = "element_pass_roofline.device"


def read(ctx):
    calls = ctx.calls.get(NAME, [])
    if ctx.trace is None or any(c is None for c in calls):
        return None
    return share_percent(calls, ctx.trace.span_device_s(NAME))
