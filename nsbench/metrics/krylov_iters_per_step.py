"""krylov_iters_per_step (iters/step): the outer Krylov iterations of a
step, the velocity solve's plus the pressure solve's
(`StepDiagnostics.iters_f + iters_s`), averaged over the measured window's
steps.  In a sweep the batched solves run in lockstep until the last member
converges, so a step costs the most of any member in each solve.  Moves
steps_per_s: each iteration is a round of applies and one host sync."""

import numpy as np


def read(ctx):
    if not ctx.diags:
        return None
    per_step = [np.max(d["iters_f"]) + np.max(d["iters_s"]) for d in ctx.diags]
    return float(np.mean(per_step))
