"""Where a cell's steps and set-up go, by the program's own spans:

    python3 -m nsbench.phases --workload <cell> --seed <n>

from the root of a checkout, on the card.  Runs the cell's set-up, its
warm-up steps and one profiled block of the traffic's `trace_steps` steps
through the harness's own functions (changing none of them), and prints
one row for each program span (`nsbench/program_spans.py`; each row holds
the spans nested in it):

    calls a step; host ms a step; device ms a step of the kernels launched
    inside; device idle ms a step inside; launches a step; host_read spans
    a step

then the share of the host time inside the benchmark's `nsbench.step`
spans that the top-level `step.*` and `run.*` spans cover, and the
set-up table (`setup_seconds()`: each phase's own host seconds).  On the
card a second profiled block runs under torch's sync debug mode, which
warns at each synchronising CUDA call from the Python line that made it:
its synchronisations a step by source line sit beside the same block's
`host_read` and `host_write` spans a step (the mode does not count
`torch.cuda.synchronize`: neither the benchmark's synchronise after each
step nor the ensemble's `run.sync`).
The per-layer metrics read some of these spans; this table is for the
operator looking for where the time goes.
"""

from __future__ import annotations

import argparse
import bisect
import sys
import time
import warnings
from collections import Counter
from pathlib import Path

T_START = time.perf_counter()

from nsbench import program_spans  # noqa: E402  (sets the program's span prefix before set-up)

STEP_PHASES = ("step.", "run.")
SYNC_SITES = ("host_read", "host_write")
COLUMNS = ("calls", "host_ms", "device_ms", "idle_ms", "launches", "host_reads")


def _inside(starts: list, a: float, b: float) -> int:
    """How many of the sorted `starts` lie in [a, b]."""
    return bisect.bisect_right(starts, b) - bisect.bisect_left(starts, a)


def table(tr) -> dict:
    """Program span -> its COLUMNS, each a step (the trace's `nsbench.step`
    spans count the steps)."""
    steps = max(tr.steps(), 1)
    per_corr = Counter((e.get("args") or {}).get("correlation") for e in tr.kernels)
    reads = sorted(a for a, _ in program_spans.intervals(tr, "host_read"))
    rows = {}
    for name in program_spans.names(tr):
        ivs = program_spans.intervals(tr, name)
        launches = 0
        for a, b in ivs:
            lo, hi = bisect.bisect_left(tr.rt_ts, a), bisect.bisect_right(tr.rt_ts, b)
            launches += sum(per_corr.get(c, 0) for c in tr.rt_corr[lo:hi])
        rows[name] = dict(
            calls=len(ivs) / steps,
            host_ms=sum(b - a for a, b in ivs) / 1e3 / steps,
            device_ms=1e3 * tr.span_device_s("program." + name) / steps,
            idle_ms=1e3 * program_spans.idle_inside(tr, ivs) / steps,
            launches=launches / steps,
            host_reads=sum(_inside(reads, a, b) for a, b in ivs) / steps,
        )
    return rows


def step_coverage(tr) -> float | None:
    """The share of the host time inside the `nsbench.step` spans that the
    top-level `step.*` and `run.*` program spans cover."""
    steps = program_spans.union(tr.spans.get("nsbench.step", ()))
    total = sum(b - a for a, b in steps)
    if not total > 0:
        return None
    top = [iv for n in program_spans.names(tr) if n.startswith(STEP_PHASES) for iv in program_spans.intervals(tr, n)]
    return program_spans.overlap(program_spans.union(top), steps) / total


def sync_block(prog, state, steps: int):
    """A profiled block under torch's sync debug mode: (state, Trace, the
    synchronisations by source line "file:line")."""
    import torch

    from nsbench import harness

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            state, tr = harness.profiled_block(prog, prog.advance, state, steps, harness.Spans({}))
        finally:
            torch.cuda.set_sync_debug_mode("default")
    sites = Counter(
        f"{Path(w.filename).name}:{w.lineno}" for w in caught if "called a synchronizing" in str(w.message)
    )
    return state, tr, sites


def render(rows: dict) -> str:
    head = f"{'span':32s}" + "".join(f"{c:>12s}" for c in COLUMNS)
    lines = [head]
    for name, r in sorted(rows.items(), key=lambda kv: -kv[1]["host_ms"]):
        lines.append(f"{name:32s}" + "".join(f"{r[c]:12.4f}" for c in COLUMNS))
    return "\n".join(lines)


def run(workload: str, seed: int, device=None, root: Path | None = None, bench: dict | None = None) -> dict:
    """The cell's set-up, warm-up and profiled block (and on the card the
    block under the sync debug mode); returns the table, the coverage, the
    sync sites and the set-up phases."""
    from nsbench import harness

    root = harness.ROOT if root is None else root
    bench = harness.load_json(Path("BENCHMARK.json")) if bench is None else bench
    cell = harness.find_cell(bench, workload, root)
    cfg, traffic = cell["config"], cell["traffic"]
    if device is None:
        import torch

        if not torch.cuda.is_available():
            raise harness.NoCard("the phase table is read on the card")
        device = "cuda"
    prog = harness.Program(cfg, traffic, harness.mesh_arrays(cfg), device)
    state, _ = harness.warm_up(prog, prog.advance, prog.initial_state(seed, cfg, traffic), traffic)
    setup_s = time.perf_counter() - T_START
    steps = int(traffic["trace_steps"])
    state, tr = harness.profiled_block(prog, prog.advance, state, steps, harness.Spans({}))
    rows = table(tr)
    spans = {k: rows[k]["calls"] if k in rows else 0.0 for k in SYNC_SITES}
    syncs = None
    if prog.device.type == "cuda":
        state, tr2, lines = sync_block(prog, state, steps)
        rows2 = table(tr2)
        syncs = dict(
            lines={k: v / steps for k, v in lines.most_common()},
            spans={k: rows2[k]["calls"] if k in rows2 else 0.0 for k in SYNC_SITES},
        )
    return dict(
        rows=rows, coverage=step_coverage(tr), sites=spans, syncs=syncs,
        block_ms_per_step=1e3 * sum(b - a for a, b in tr.spans.get("nsbench.step", ())) / 1e6 / max(tr.steps(), 1),
        setup_s=setup_s,
        setup=program_spans.profiling.setup_seconds() if program_spans.profiling is not None else {},
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m nsbench.phases")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    args = ap.parse_args(argv)
    from nsbench import harness

    if program_spans.profiling is None:
        print("nsbench.phases: this program has no spans of its own", file=sys.stderr)
        return 2
    try:
        out = run(args.workload, args.seed)
    except harness.NoCard as e:
        print(f"nsbench.phases: {e}", file=sys.stderr)
        return 3
    print(f"{args.workload}: program spans, each a step (nested spans included), "
          f"traced block {out['block_ms_per_step']:.3f} ms a step")
    print(render(out["rows"]))
    cov = out["coverage"]
    print(f"top-level step.* and run.* spans cover {'n/a' if cov is None else f'{100 * cov:.2f}%'} "
          "of the host time inside nsbench.step")
    print("sync sites a step: " + ", ".join(f"{k} {v:.2f}" for k, v in out["sites"].items())
          + f"; sum {sum(out['sites'].values()):.2f}")
    if out["syncs"] is not None:
        sy = out["syncs"]
        print("a second block under the sync debug mode, spans a step: "
              + ", ".join(f"{k} {v:.2f}" for k, v in sy["spans"].items())
              + f"; synchronisations a step {sum(sy['lines'].values()):.2f}, by line:")
        for line, n in sy["lines"].items():
            print(f"  {line:40s}{n:8.2f}")
    print(f"set-up: {out['setup_s']:.3f} s to the end of warm-up; program phases "
          f"{sum(out['setup'].values()):.3f} s")
    for name, s in sorted(out["setup"].items(), key=lambda kv: -kv[1]):
        print(f"  {name:28s}{s:10.3f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
