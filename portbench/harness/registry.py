"""The benchmark's registry: everything of one cell is found by the names in
``BENCHMARK.json``.

- a configuration's file is the ``file`` of its entry, and its plain
  reference is ``portbench/reference/<config>.py``;
- a traffic mix is ``portbench/mixes/<traffic>.json``, and the algorithm it
  names is the driver ``portbench/harness/drivers/<algorithm>.py``;
- a metric, end-to-end or per-layer, is read by
  ``portbench/metrics/<metric>.py``, whose ``read(ctx)`` returns a number,
  or None where it finds nothing to read.

So a later change adds a configuration, a mix or a metric by adding files
and entries only.
"""

import importlib
import importlib.util
import json
import re
from pathlib import Path

PKG = Path(__file__).resolve().parent.parent
ROOT = PKG.parent
BENCHMARK = ROOT / "BENCHMARK.json"


def load_module(path, prefix="portbench_file"):
    """Import the Python file ``path`` as a module of its own."""
    path = Path(path)
    if not path.is_file():
        raise FileNotFoundError(f"no file {path}")
    name = f"{prefix}_{re.sub(r'[^0-9A-Za-z_]', '_', path.stem)}"
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_benchmark(path=BENCHMARK):
    return json.loads(Path(path).read_text())


def _entry(entries, name, what):
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"BENCHMARK.json names no {what} {name!r}")


def metrics_of(bench, cell, kind):
    """The names of the ``kind`` ("end_to_end" or "per_layer") metrics that
    ``cell`` reports: those that list it under ``workloads``, and those
    without the key (a per-layer one where the cell reports the metric it
    moves)."""
    e2e = [m["name"] for m in bench["end_to_end"]
           if "workloads" not in m or cell in m["workloads"]]
    if kind == "end_to_end":
        return e2e
    return [m["name"] for m in bench["per_layer"]
            if cell in m.get("workloads", ())
            or ("workloads" not in m and m["moves"] in e2e)]


def cell_spec(name, root=ROOT):
    """Everything one run of cell ``name`` needs: its workload entry, its
    configuration and mix (read from their files) and its metrics."""
    bench = load_benchmark(root / "BENCHMARK.json")
    cell = _entry(bench["workloads"], name, "cell")
    conf = _entry(bench["configs"], cell["config"], "configuration")
    return {
        "cell": name,
        "chips": int(cell["chips"]),
        "config_name": conf["name"],
        "config": json.loads((root / conf["file"]).read_text()),
        "traffic": cell["traffic"],
        "mix": json.loads(mix_path(cell["traffic"], root).read_text()),
        "end_to_end": metrics_of(bench, name, "end_to_end"),
        "per_layer": metrics_of(bench, name, "per_layer"),
        "units": {m["name"]: m["unit"]
                  for m in bench["end_to_end"] + bench["per_layer"]},
    }


def mix_path(traffic, root=ROOT):
    return root / "portbench" / "mixes" / f"{traffic}.json"


def reference(config_name, root=ROOT):
    """The plain reference module of a configuration."""
    return load_module(root / "portbench" / "reference"
                       / f"{config_name}.py", "portbench_reference")


def driver(algorithm):
    """The driver class of a mix's algorithm."""
    return importlib.import_module(
        f"portbench.harness.drivers.{algorithm}").Driver


def metric_reader(name, root=ROOT):
    """The ``read(ctx)`` function of a metric."""
    return load_module(root / "portbench" / "metrics" / f"{name}.py",
                       "portbench_metric").read
