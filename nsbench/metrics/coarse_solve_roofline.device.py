"""coarse_solve_roofline.device (%): `coarse_solve_roofline` in a cell
whose step is timed on the device.  Moves device_ms_per_step."""

from nsbench.metrics.coarse_solve_roofline import read  # noqa: F401
