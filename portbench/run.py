"""Run one cell of the benchmark of quimb_torch on a CUDA card and print its
result as the last line of standard output.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cell is looked up in ``BENCHMARK.json`` beside ``portbench/``. With
``--trace 0`` the result holds the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics from a device trace. The numbers that
decide ``correct`` are printed beside their limits as the last lines of
standard error, and last in the result. Without a CUDA card, or with fewer
than the cell asks for, it prints no result and exits with code 2; if JAX
or quimb_tpu is loaded once the window has closed, with code 3; without
quimb_torch beside it, with code 4.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def _power_limit():
    """The card's power limit in watts, as ``nvidia-smi`` reads it."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=30, check=True).stdout
        return float(out.split()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    sys.path.insert(0, str(ROOT))
    # kernel caches stay inside the checkout, at fixed paths: the port
    # builds its library into quimb_torch/_build/ itself, and a Triton or
    # torch extension kernel would find its cache here
    cache = ROOT / ".portbench_cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    from portbench.harness import guards, registry, runner

    spec = registry.cell_spec(args.workload)
    import torch

    try:
        guards.require_cards(torch, spec["chips"])
    except guards.NoCard as err:
        print(f"portbench: {err}", file=sys.stderr)
        return 2
    try:
        import quimb_torch
    except ImportError as err:
        print(f"portbench: the program is missing: {err}", file=sys.stderr)
        return 4

    result, step_s = runner.run(spec, args.seed, args.seconds,
                                bool(args.trace), "cuda", quimb_torch,
                                torch, T_START)
    found = guards.forbidden_modules()
    if found:
        print(f"portbench: forbidden modules loaded: {', '.join(found)}",
              file=sys.stderr)
        return 3
    result["device"]["power_limit_w"] = _power_limit()
    print("step seconds " + " ".join(f"{t:.4f}" for t in step_s),
          file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
