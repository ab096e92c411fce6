"""The benchmark's table of peaks and roofline arithmetic.

Copied from `chip_smoke.py` (`HBM_BYTES_PER_S`, `F32_OPS_PER_S`,
`F64_OPS_PER_S` :199-215, `bound` :819), so that later changes to that
script do not move this yardstick.  Peaks of one NVIDIA H100 SXM at 700 W
(NVIDIA's data sheet): 3.35 TB/s of device memory, 67 TFLOP/s in float32
outside the tensor cores, 67 TFLOP/s in float64 on its tensor cores.  A
card set below 700 W runs slower under load: every run records the card's
`power.limit` beside its shares.

A kernel's least time is the larger of its bytes (each input read once,
each output written once) over the memory rate and its operations over
the operation rate; its roofline share is that least time over the device
time it took.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
OPS_PER_S = {4: 67e12, 8: 67e12}  # by element size: float32, float64


def bound_s(nbytes: float, ops: float, itemsize: int = 4) -> float:
    """The least seconds the card could take to move `nbytes` and do `ops`
    operations."""
    return max(nbytes / HBM_BYTES_PER_S, ops / OPS_PER_S[itemsize])


def share_percent(calls: list, device_s: float) -> float | None:
    """100 x (sum of the calls' bounds) / (their device seconds); None
    where no call ran or no device time was read.  `calls` holds one
    (bytes, ops, itemsize) a call."""
    if not calls or not device_s > 0.0:
        return None
    return 100.0 * sum(bound_s(b, o, s) for b, o, s in calls) / device_s
