"""Strouhal number from a lift time series: a copy of the reference's
`utils/signal.py` (numpy only), held equal to it by
tests/test_torch_port_copies.py."""

from __future__ import annotations

import numpy as np


def strouhal_number(
    lift: np.ndarray,
    dt: float,
    diameter: float = 0.1,
    velocity: float = 1.0,
    skip_fraction: float = 0.5,
) -> float:
    """St = f D / U with f the dominant lift-oscillation frequency.

    The first `skip_fraction` of the series is discarded (startup transient)."""
    x = np.asarray(lift, dtype=np.float64)
    x = x[int(len(x) * skip_fraction):]
    if len(x) < 8:
        return float("nan")
    x = x - x.mean()
    spec = np.abs(np.fft.rfft(x * np.hanning(len(x))))
    freqs = np.fft.rfftfreq(len(x), d=dt)
    k = int(np.argmax(spec[1:])) + 1
    return float(freqs[k] * diameter / velocity)
