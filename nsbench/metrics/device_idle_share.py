"""device_idle_share (%): the share of the traced window in which no
kernel, copy or memset ran on the device: 1 - (union of the device's
operation intervals) / (the window's wall time), both from the traced
window's torch.profiler trace.  Moves steps_per_s: the host's dispatch and
its syncs leave the device idle."""


def read(ctx):
    tr = ctx.trace
    if tr is None or not tr.busy_s() > 0.0:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s())
