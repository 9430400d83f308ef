"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout that holds the port.  Set-up, then a window
of ``--seconds`` (closed at the end of the first whole unit past it),
then the check against the plain reference.  The last line of standard
output is one JSON object; the last lines of standard error are the
numbers compared, each beside its limit.  Exits 1, with no result, where
no CUDA device (or fewer than the cell asks for) is present, and where a
JAX module was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from portbench import harness

    try:
        line = harness.run(args.workload, args.seed, args.seconds,
                           bool(args.trace), T_START, root=ROOT)
    except harness.NoChip as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 1
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
