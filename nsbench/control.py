"""The readings that a cell's limits are set from, on the chip at the
cell's own size (not part of a benchmark run):

    python -m nsbench.control --workload <cell> --seeds <n> [<n> ...] \\
        [--seconds 2] [--control-seeds <k>]
    python -m nsbench.control --config <name or file.json> \\
        --traffic <name or file.json> --seeds <n> [<n> ...] ...

A cell of BENCHMARK.json (`--workload`), or a configuration and a traffic
mix that no cell names yet (`--config`, `--traffic`: a name under
`configs/` and `traffic/`, or a path to a JSON file; no limits needed).
Either is refused, as a run refuses it, where the check does not cover
the configuration.  One set-up of the program; then for each seed the
seeded initial state, the traffic's warm-up and a short window at the
cell's own load (`--seconds`, and at least `harness.MIN_WINDOW_STEPS`
steps, as a run's window), and its sampled steps judged as a run judges
them (the lower readings).  For the first `--control-seeds` seeds, the
same steps are taken again from the program's pre-step states by the
reference in TF32 put in the program's place (the control: the upper
readings), and by the reference in float64 (a witness that reads near
nought).  One JSON
line a seed on standard output: the numbers, the window's steps, ms a
step, outer Krylov iterations a step and failed steps, and each control
step's solver information (iterations; for the monolithic control also
whether it reached its tolerance) and seconds.
"""

import argparse
import json
import sys
import time

import numpy as np
import torch


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m nsbench.control")
    which = ap.add_mutually_exclusive_group(required=True)
    which.add_argument("--workload")
    which.add_argument("--config", help="a configuration: its name under configs/, or a JSON file")
    ap.add_argument("--traffic", help="a traffic mix: its name under traffic/, or a JSON file")
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if (args.config is None) != (args.traffic is None):
        ap.error("--config and --traffic go together")

    from nsbench import harness

    if args.workload is not None:
        cell = harness.find_cell(harness.load_json(harness.Path("BENCHMARK.json")), args.workload)
        cfg, traffic = cell["config"], cell["traffic"]
    else:
        cfg, traffic = harness.load_named("configs", args.config), harness.load_named("traffic", args.traffic)
        harness.refuse_uncovered(cfg)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("nsbench.control: no card", file=sys.stderr)
        return 3
    t0 = time.perf_counter()
    arrays = harness.mesh_arrays(cfg)
    prog = harness.Program(cfg, traffic, arrays, args.device)
    checker = harness.Checker(cfg, arrays, prog.labels(), args.device)
    print(f"set-up {time.perf_counter() - t0:.1f} s", file=sys.stderr, flush=True)
    for i, seed in enumerate(args.seeds):
        t1 = time.perf_counter()
        state, first = harness.warm_up(prog, prog.advance, prog.initial_state(seed, cfg, traffic), traffic)
        win = harness.Window(
            prog, prog.advance, state, args.seconds, int(traffic["check_steps"]), seed,
            harness.MIN_WINDOW_STEPS,
        )
        samples = harness.host_samples([first] + win.reservoir)
        window = dict(
            steps=len(win.step_s), ms_per_step=1e3 * win.seconds / len(win.step_s),
            iters_per_step=float(np.mean([np.max(d["iters_f"]) + np.max(d["iters_s"]) for d in win.diags])),
            failed=harness.failed_steps(win.diags, cfg["run_config"]["solver"]["maxiter"]),
        )
        del state, first, win
        row = dict(seed=seed, program=checker.numbers(samples, prog.nus), window=window)
        if i < args.control_seeds:
            for precision in ("tf32", "float64"):
                log = []
                row[precision] = checker.control_numbers(samples, prog.nus, precision, log=log)
                row[f"{precision}_steps"] = log
        row["seconds"] = time.perf_counter() - t1
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
