"""launches_per_step.device (launches/step): `launches_per_step` in a cell
whose step is timed on the device.  Moves device_ms_per_step: each kernel
adds its start and its tail to the device's busy time."""

from nsbench.metrics.launches_per_step import read  # noqa: F401
