"""device_idle_share.device (%): `device_idle_share` in a cell whose step
is timed on the device.  Moves device_ms_per_step: where the host sets the
pace, the device idles between its launches, and a step's device time is
what is left."""

from nsbench.metrics.device_idle_share import read  # noqa: F401
