"""The readings that a cell's limits are set from, on the chip at the
cell's own size (not part of a benchmark run):

    python -m nsbench.control --workload <cell> --seeds <n> [<n> ...] \\
        [--seconds 2] [--control-seeds <k>]

One set-up of the program for the cell; then for each seed the seeded
initial state, the traffic's warm-up and a short window at the cell's own
load, and its sampled steps judged as a run judges them (the lower
readings).  For the first `--control-seeds` seeds, the same steps are
taken again from the program's pre-step states by the reference in TF32
put in the program's place (the control: the upper readings), and by the
reference in float64 (a witness that reads near nought).  One JSON line a
seed on standard output.
"""

import argparse
import json
import sys
import time

import torch


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m nsbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from nsbench import harness

    bench = harness.load_json(harness.Path("BENCHMARK.json"))
    cell = harness.find_cell(bench, args.workload)
    cfg, traffic = cell["config"], cell["traffic"]
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
        win = harness.Window(prog, prog.advance, state, args.seconds, int(traffic["check_steps"]), seed)
        samples = harness.host_samples([first] + win.reservoir)
        del state, first, win
        row = dict(seed=seed, program=checker.numbers(samples, prog.nus))
        if i < args.control_seeds:
            row["tf32"] = checker.control_numbers(samples, prog.nus, "tf32")
            row["float64"] = checker.control_numbers(samples, prog.nus, "float64")
        row["seconds"] = time.perf_counter() - t1
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
