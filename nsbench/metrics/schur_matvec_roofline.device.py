"""schur_matvec_roofline.device (%): `schur_matvec_roofline` in a cell
whose step is timed on the device.  Moves device_ms_per_step."""

from nsbench.metrics.schur_matvec_roofline import read  # noqa: F401
