"""The comparison's controls, and the readings its limits come from.

    python3 portbench/control.py --workload <cell> --seeds 1,2,3 \\
        --seconds <s> [--control closure|quarter|none]

runs the cell once per seed in one process, as ``run.py`` does, and
prints each run's numbers compared and the readings beside them.
``--control none`` reads the program as the benchmark runs it (the lower
readings).  The controls, each the program's own path with one of the
configuration's guarantees broken; the reference still holds the run to
the configuration:

* ``closure``: the closure threshold switched off
  (``ConsensusConfig.closure_tau = None``), so that closure adds sampled
  wedges whatever their co-membership, where the configuration adds only
  those at ``closure_tau * n_p`` or more;
* ``quarter``: Louvain with a quarter of the port's sweep budgets, cold
  and warm (``models/louvain.make_louvain``), the step a change that is
  faster by detecting less would take: its members stop short of a
  Louvain partition.

The benchmark's own runs never run this.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def quarter_budget(cfg: dict):
    """Louvain with a quarter of the port's cold and warm sweep budgets."""
    from fastconsensus_tpu_torch.models import louvain as lv

    gamma = cfg.get("gamma", 1.0)
    det = lv.make_louvain(max_sweeps=max(1, lv.cold_sweep_budget() // 4),
                          gamma=gamma)
    det.warm_variant = lv.make_louvain(
        max_sweeps=max(1, lv.warm_sweep_budget() // 4), gamma=gamma)
    return det


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=1.0)
    p.add_argument("--control", choices=("closure", "quarter", "none"),
                   default="closure")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from portbench import harness, port

    if args.control == "closure":
        made = port.consensus_config

        def without_closure_threshold(cfg):
            return dataclasses.replace(made(cfg), closure_tau=None)
        port.consensus_config = without_closure_threshold
    elif args.control == "quarter":
        port.detector = quarter_budget
    t0 = T_START
    for seed in [int(s) for s in args.seeds.split(",")]:
        line = harness.run(args.workload, seed, args.seconds, False, t0,
                           root=ROOT, device=args.device)
        print(json.dumps({"control": args.control, "seed": seed,
                          "correct": line["correct"],
                          "failed": line["failed"],
                          "attempted": line["attempted"],
                          "checks": {k: c["value"] for k, c in
                                     line["checks"].items()},
                          "metrics": {k: m["value"] for k, m in
                                      line["metrics"].items()},
                          "card": line["card"]}), flush=True)
        t0 = time.perf_counter()
    return 0


if __name__ == "__main__":
    sys.exit(main())
