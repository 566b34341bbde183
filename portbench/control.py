"""Read the numbers that decide ``correct`` over many seeds in one process:
the program as the cell runs it, or the cell's control in its place (the
mix's ``control``: the same work a precision lower), to set each limit
between the two readings.

    python3 portbench/control.py --workload <cell> --seeds 1,2,3 \
        --seconds <s> --variant program|control

Each seed is one run of the cell without a trace (set-up, warm-up, a window
of ``--seconds``, the check); a line of JSON a seed goes to standard
output, and the largest reading of each number last.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--variant", choices=("program", "control"),
                    default="program")
    args = ap.parse_args(argv)

    sys.path.insert(0, str(ROOT))
    from portbench.harness import guards, registry, runner

    spec = registry.cell_spec(args.workload)
    import torch

    guards.require_cards(torch, spec["chips"])
    import quimb_torch

    variant = spec["mix"]["control"] if args.variant == "control" else None
    largest, smallest = {}, {}
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        r, step_s = runner.run(spec, seed, args.seconds, False, "cuda",
                               quimb_torch, torch, t0, variant=variant)
        line = {"seed": seed, "variant": args.variant,
                "correct": r["correct"], "attempted": r["attempted"],
                "checks": r["checks"], "metrics": r["metrics"],
                "seconds": time.perf_counter() - t0, "step_s": step_s}
        print(json.dumps(line), flush=True)
        for name, c in r["checks"].items():
            largest[name] = max(largest.get(name, c["value"]), c["value"])
            smallest[name] = min(smallest.get(name, c["value"]), c["value"])
    print(json.dumps({"workload": args.workload, "variant": args.variant,
                      "largest": largest, "smallest": smallest}), flush=True)
    found = guards.forbidden_modules()
    if found:
        print(f"forbidden modules loaded: {found}", file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
