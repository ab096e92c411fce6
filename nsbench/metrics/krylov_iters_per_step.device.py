"""krylov_iters_per_step.device (iters/step): `krylov_iters_per_step` in a
cell whose step is timed on the device.  Moves device_ms_per_step: each
iteration is a round of applies and reductions on the card."""

from nsbench.metrics.krylov_iters_per_step import read  # noqa: F401
