"""One run of one benchmark cell:

    python -m nsbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  Prints the run's numbers compared for
`correct`, each beside its limit, as the last lines of standard error, and
one JSON object as the last line of standard output.  Exits 3 without a
result where the cell asks for more cards than the machine has (it never
falls back to the CPU), and 4 where a forbidden module (jax, jaxlib,
flax, the JAX package) was imported.
"""

import time

T_START = time.perf_counter()  # set-up is timed from here

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m nsbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from nsbench import harness

    try:
        result = harness.run(
            args.workload, args.seed, args.seconds, bool(args.trace), T_START,
            log=lambda msg: print(msg, file=sys.stderr, flush=True),
        )
    except harness.NoCard as e:
        print(f"nsbench: {e}", file=sys.stderr)
        return 3
    except harness.Forbidden as e:
        print(f"nsbench: {e}", file=sys.stderr)
        return 4
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
