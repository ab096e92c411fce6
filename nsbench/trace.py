"""Reading a torch.profiler trace (its Chrome trace export) into what the
per-layer metrics need: the traced window, the device's busy intervals,
the kernels, and the device time of the kernels launched inside each of
the benchmark's host spans (a kernel belongs to the span whose host
interval holds the runtime call that launched it, matched by the
profiler's correlation id).

Times in the export are microseconds on one clock for host and device.
`device_busy_s` reads the device's busy time of a whole profiled window
(`device_ms_per_step`) from the profiler's events without an export.
"""

from __future__ import annotations

import bisect
import contextlib
import json
from collections import defaultdict

import numpy as np

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
RUNTIME_CATS = ("cuda_runtime", "cuda_driver")
RUN_SPAN = "nsbench.run"
STEP_SPAN = "nsbench.step"
PREFIX = "nsbench."


def _union(intervals):
    """Sorted, merged [start, end] intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def device_activity(on: bool):
    """torch.profiler over the device's activity alone (kernels, copies,
    memsets and the runtime calls that launch them) where `on`; else a
    null context."""
    if not on:
        return contextlib.nullcontext()
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CUDA])


def device_busy_s(prof) -> float:
    """Seconds in which a kernel, copy or memset ran on the device over a
    whole profiler session: the union of the intervals of its kineto
    events on the device that are not a span (no Chrome export: a window
    holds some hundred thousand kernels)."""
    from torch.autograd import DeviceType

    ev = [e for e in prof.profiler.kineto_results.events() if e.device_type() == DeviceType.CUDA]
    ev = [e for e in ev if not e.is_user_annotation()]
    if not ev:
        return 0.0
    start = np.fromiter((e.start_ns() for e in ev), np.int64, len(ev))
    end = np.fromiter((e.end_ns() for e in ev), np.int64, len(ev))
    order = np.argsort(start, kind="stable")
    start, reach = start[order], np.maximum.accumulate(end[order])
    first = np.r_[True, start[1:] > reach[:-1]]  # each merged interval's first event
    last = np.r_[first[1:], True]
    return float((reach[last] - start[first]).sum()) / 1e9


class Trace:
    def __init__(self, events: list):
        ev = [e for e in events if e.get("ph") == "X" and "ts" in e]
        spans = [e for e in ev if e.get("cat") == "user_annotation" and str(e.get("name", "")).startswith(PREFIX)]
        runs = [e for e in spans if e["name"] == RUN_SPAN]
        if len(runs) != 1:
            raise ValueError(f"the trace holds {len(runs)} '{RUN_SPAN}' spans, not one")
        run = runs[0]
        self.t0, self.t1 = float(run["ts"]), float(run["ts"]) + float(run["dur"])
        self.host = (run.get("pid"), run.get("tid"))
        self.spans = defaultdict(list)  # name -> [(start, end)] on the run's thread
        for e in spans:
            if (e.get("pid"), e.get("tid")) == self.host:
                self.spans[e["name"]].append((float(e["ts"]), float(e["ts"]) + float(e["dur"])))
        inside = lambda e: self.t0 <= float(e["ts"]) <= self.t1  # noqa: E731
        self.device = [e for e in ev if e.get("cat") in DEVICE_CATS and inside(e)]
        self.kernels = [e for e in self.device if e.get("cat") == "kernel"]
        self.by_corr = defaultdict(float)
        for e in self.kernels:
            c = (e.get("args") or {}).get("correlation")
            if c is not None:
                self.by_corr[c] += float(e["dur"])
        rt = sorted(
            (float(e["ts"]), (e.get("args") or {}).get("correlation"))
            for e in ev if e.get("cat") in RUNTIME_CATS and (e.get("pid"), e.get("tid")) == self.host
        )
        self.rt_ts = [t for t, _ in rt]
        self.rt_corr = [c for _, c in rt]
        self.host_ops = sorted(
            (float(e["ts"]), float(e["ts"]) + float(e["dur"]), str(e.get("name", "")))
            for e in ev if (e.get("pid"), e.get("tid")) == self.host
            and e.get("cat") in ("cpu_op", *RUNTIME_CATS) and inside(e)
        )
        self.busy = _union(
            (max(float(e["ts"]), self.t0), min(float(e["ts"]) + float(e["dur"]), self.t1)) for e in self.device
        )

    @classmethod
    def from_file(cls, path: str) -> "Trace":
        with open(path) as f:
            data = json.load(f)
        return cls(data["traceEvents"] if isinstance(data, dict) else data)

    # ------------------------------------------------------------------
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e6

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy) / 1e6

    def steps(self) -> int:
        return len(self.spans[STEP_SPAN])

    def kernel_count(self) -> int:
        return len(self.kernels)

    def span_device_s(self, name: str) -> float:
        """Device seconds of the kernels launched inside the spans `name`."""
        total = 0.0
        for a, b in self.spans[PREFIX + name]:
            lo, hi = bisect.bisect_left(self.rt_ts, a), bisect.bisect_right(self.rt_ts, b)
            total += sum(self.by_corr.get(c, 0.0) for c in self.rt_corr[lo:hi])
        return total / 1e6

    def top_kernels(self, n: int = 10) -> list:
        tot = defaultdict(float)
        for e in self.kernels:
            tot[str(e.get("name", ""))] += float(e["dur"]) / 1e6
        return sorted(([k, v] for k, v in tot.items()), key=lambda kv: -kv[1])[:n]

    def _label(self, t: float) -> str:
        """The innermost benchmark span and host operation at host time t."""
        rng = "other host"
        best = None
        for name, ivs in self.spans.items():
            for a, b in ivs:
                if a <= t <= b and (best is None or (a, -b) > best):
                    best, rng = (a, -b), name[len(PREFIX):]
        i = bisect.bisect_right(self.host_ops, (t, float("inf"), "")) - 1
        op = None
        for j in range(i, max(i - 400, -1), -1):
            a, b, name = self.host_ops[j]
            if a <= t <= b:
                op = name
                break
        return rng if op is None else f"{rng}: {op}"

    def idle_gaps(self, n: int = 10) -> list:
        """The device's idle time inside the window, summed by what the host
        was doing where each gap began; the n largest."""
        tot = defaultdict(float)
        edges = [self.t0] + [x for iv in self.busy for x in iv] + [self.t1]
        for a, b in zip(edges[::2], edges[1::2]):
            if b > a:
                tot[self._label(a)] += (b - a) / 1e6
        return sorted(([k, v] for k, v in tot.items()), key=lambda kv: -kv[1])[:n]
