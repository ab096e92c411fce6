"""host_syncs_per_step.device (syncs/step): `host_syncs_per_step` in a cell
whose step is timed on the device.  Moves device_ms_per_step: each sync
drains the device's queue, and what the host launches after it starts on
an idle device."""

from nsbench.metrics.host_syncs_per_step import read  # noqa: F401
