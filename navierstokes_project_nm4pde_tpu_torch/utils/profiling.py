"""Spans of the port's phases and layers on the profiler's clock.

`span(name)` names a region of the program (a set-up phase, a step phase,
a Krylov iteration, a host read, a preconditioner layer) in a
torch.profiler trace, on the same clock as the CUDA kernels launched
inside it, as `PREFIX + name`.  With no profiler running it costs one
check of a flag and returns a shared null context: it never records a
range and never reads a tensor.  While a profiler runs, the sizes a span
is given (plain numbers taken from shapes, never from values) are kept
per name, one dict a call, so that a reader of the trace can set each
call's bytes and operations beside the device time of its kernels.

`setup_phase(name)` is a span that also keeps its host seconds, whether
or not a profiler runs; set-up runs once, so that costs nothing a step.
A phase's seconds are its own: the time of phases nested inside it is
kept under their names, so the values add up to the time in set-up
phases.

While a CUDA graph is captured (`solvers/krylov.py CGGraphs`), `cutting(cut)`
hands each span that is given sizes to `cut`, which ends the graph there and
captures the span's own work as a graph of its own: a replay then runs that
graph inside the span, with the sizes seen at capture.  A span opened with
`cut=False` is never a cut: its work stays in the graph around it, and a
replay does not open it.

The profiler is one per process, and so is what is recorded here;
`reset()` clears it.
"""

from __future__ import annotations

import contextlib
import time

from torch.autograd import profiler as _profiler

PREFIX = "ns."  # the namespace of the port's spans in a trace
ENABLED = True  # False: no span is recorded even while a profiler runs

_NULL = contextlib.nullcontext()
_sizes: dict = {}  # name -> [sizes of each call made while a profiler ran]
_setup: dict = {}  # set-up phase -> its own host seconds
_setup_stack: list = []  # the open set-up phases' nested seconds
_cut = None  # while a CUDA graph is captured: name, sizes -> the span's context (`cutting`)


def span(name: str, *, cut: bool = True, **sizes):
    """A context manager naming the enclosed region `PREFIX + name` in a
    running torch.profiler trace (the shared null context otherwise),
    recording `sizes` under `name` while it runs; with `cut` False, never
    a cut of a graph being captured (`cutting`)."""
    if _cut is not None and sizes and cut:
        return _cut(name, sizes)
    if not (_profiler._is_profiler_enabled and ENABLED):
        return _NULL
    if sizes:
        _sizes.setdefault(name, []).append(sizes)
    return _profiler.record_function(PREFIX + name)


@contextlib.contextmanager
def setup_phase(name: str):
    """`span(name)` that also adds its own host seconds to
    `setup_seconds()[name]`."""
    _setup_stack.append(0.0)
    t0 = time.perf_counter()
    try:
        with span(name):
            yield
    finally:
        total = time.perf_counter() - t0
        nested = _setup_stack.pop()
        _setup[name] = _setup.get(name, 0.0) + total - nested
        if _setup_stack:
            _setup_stack[-1] += total


@contextlib.contextmanager
def cutting(cut):
    """While the block runs, each span given sizes is `cut(name, sizes)`,
    a context manager, in place of the span."""
    global _cut
    prev, _cut = _cut, cut
    try:
        yield
    finally:
        _cut = prev


def sizes(name: str) -> list:
    """The sizes of each call of span `name` made while a profiler ran."""
    return list(_sizes.get(name, ()))


def setup_seconds() -> dict:
    """Each set-up phase that ran -> its own host seconds."""
    return dict(_setup)


def reset() -> None:
    """Forget the recorded sizes and set-up seconds."""
    _sizes.clear()
    _setup.clear()
