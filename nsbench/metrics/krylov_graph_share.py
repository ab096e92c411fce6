"""krylov_graph_share (%): the share of the window's outer Krylov
iterations that ran as CUDA-graph replays: the pressure CG's replayed
iterations (`StepDiagnostics.graphed_s`, a sweep's lockstep count) over
the velocity and pressure iterations (`iters_f + iters_s`, each a sweep's
lockstep maximum), summed over the measured window's steps.  On the card
only (the CPU captures no graph); a program without `graphed_s` reads
nothing.  Moves steps_per_s: a replayed iteration is a few graph
launches from the host in place of some forty kernel launches."""

import numpy as np


def read(ctx):
    if not ctx.on_card or not ctx.diags or "graphed_s" not in ctx.diags[0]:
        return None
    graphed = sum(int(np.max(d["graphed_s"])) for d in ctx.diags)
    iters = sum(int(np.max(d["iters_f"]) + np.max(d["iters_s"])) for d in ctx.diags)
    return 100.0 * graphed / iters if iters else None
