"""host_syncs_per_step (syncs/step): the host's synchronisations with the
device a step, counted by torch's sync debug mode (it warns at each
synchronising CUDA call) over steps of the traced run taken outside the
profiled window (the method of `chip_smoke.py:1603 count_syncs`).  Moves
steps_per_s: the Krylov loop reads a residual on the host each
iteration, and the device waits for the host's next launches after each."""


def read(ctx):
    if not ctx.on_card or not ctx.sync_steps:
        return None
    return ctx.syncs / ctx.sync_steps
