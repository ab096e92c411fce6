"""Wall-clock timers that can wait for the card.

The counterpart of the reference's `utils/timers.py Timer`: with
`sync=True`, `start` and `stop` first wait for the work queued on the
current CUDA device (`torch.cuda.synchronize`, when a card is present), so
the interval covers the device work it encloses.
"""

from __future__ import annotations

import time

import torch


def _sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


class Timer:
    def __init__(self, sync: bool = True):
        self.sync = sync
        self._t0 = None
        self.elapsed = 0.0

    def start(self):
        if self.sync:
            _sync()
        self._t0 = time.perf_counter()
        return self

    def stop(self) -> float:
        if self.sync:
            _sync()
        self.elapsed = time.perf_counter() - self._t0
        return self.elapsed

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
