"""launches_per_step (launches/step): device kernels in the traced window
over its steps (torch.profiler trace).  Moves steps_per_s: each launch
costs the host its dispatch."""


def read(ctx):
    tr = ctx.trace
    if tr is None or tr.kernel_count() == 0 or tr.steps() == 0:
        return None
    return tr.kernel_count() / tr.steps()
