"""krylov_idle_share.device (%): `krylov_idle_share` in a cell whose step
is timed on the device.  Moves device_ms_per_step.  Loading this reader
sets the program's span prefix (`nsbench/program_spans.py`)."""

from nsbench.metrics.krylov_idle_share import read  # noqa: F401
