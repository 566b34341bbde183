"""BENCHMARK.json against the benchmark's contract, and the registry that
finds each piece of a cell by its name."""

import json
import re
import shutil

import pytest

from portbench.harness import registry

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
BENCH = registry.load_benchmark()


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_keys_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert len(json.dumps(BENCH)) <= 64 * 1024
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= len(BENCH["command"]) <= 32
    assert all(_line(w) and not w.startswith("/") and ".." not in w
               for w in BENCH["command"])
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    # a full check of 24 cells fits into 43200 s
    assert 338 * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_configs():
    names = [c["name"] for c in BENCH["configs"]]
    assert len(set(names)) == len(names) and 1 <= len(names) <= 24
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"])
        assert _line(c["why"]) and len(c["reduced"]) <= 16
        assert c["file"].startswith("portbench/")
        assert (registry.ROOT / c["file"]).is_file()
        assert (registry.PKG / "reference" / f"{c['name']}.py").is_file()
        assert c["name"] in used


def test_cells_report_setup_another_end_to_end_and_a_layer():
    cells = BENCH["workloads"]
    assert 1 <= len(cells) <= 24
    assert len({w["name"] for w in cells}) == len(cells)
    assert len({(w["config"], w["traffic"]) for w in cells}) == len(cells)
    assert sum(w["chips"] == 4 for w in cells) <= max(1, len(cells) // 4)
    for w in cells:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and _line(w["why"])
        assert registry.mix_path(w["traffic"]).is_file()
        e2e = registry.metrics_of(BENCH, w["name"], "end_to_end")
        assert "setup_s" in e2e and len(e2e) >= 2
        assert registry.metrics_of(BENCH, w["name"], "per_layer")


def test_metrics():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    layer = BENCH["per_layer"]
    assert 1 <= len(e2e) <= 16 and 1 <= len(layer) <= 128
    names = [m["name"] for m in BENCH["end_to_end"] + layer]
    assert len(set(names)) == len(names)
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in {"host_clock", "device_trace"}
        assert 0.01 <= m["bound"] <= 0.25
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in layer:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert _line(m["layer"]) and m["moves"] in e2e
        for c in m.get("workloads", ()):
            assert m["name"] in registry.metrics_of(BENCH, c, "per_layer")
            assert m["moves"] in registry.metrics_of(BENCH, c, "end_to_end")
    for m in BENCH["end_to_end"] + layer:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in {"lower", "higher"} and m["source"] in SOURCES
        assert set(m.get("workloads", cells)) <= cells
        assert (registry.PKG / "metrics" / f"{m['name']}.py").is_file()


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_resolves(cell):
    spec = registry.cell_spec(cell)
    assert registry.driver(spec["mix"]["algorithm"])
    assert registry.reference(spec["config_name"])
    for name in spec["end_to_end"] + spec["per_layer"]:
        assert callable(registry.metric_reader(name))


def test_the_registry_finds_added_files_by_name(tmp_path):
    """A configuration, a mix and a metric added as files and entries only
    are found by their names."""
    root = tmp_path
    shutil.copytree(registry.PKG, root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    src = registry.PKG / "configs" / "heis-chain-L128-chi256.json"
    cfg = json.loads(src.read_text())
    cfg.update(L=64, program={**cfg["program"], "args": [64]})
    (root / "portbench/configs/heis-chain-L64-chi128.json").write_text(
        json.dumps(cfg))
    shutil.copy(registry.PKG / "reference" / "heis-chain-L128-chi256.py",
                root / "portbench/reference/heis-chain-L64-chi128.py")
    mix = json.loads(registry.mix_path("dmrg2-f64").read_text())
    mix["sweeps_per_episode"] = 4
    (root / "portbench/mixes/dmrg2-f64-short.json").write_text(
        json.dumps(mix))
    (root / "portbench/metrics/sweeps_seen.py").write_text(
        "def read(ctx):\n    return ctx.steps\n")
    bench["configs"].append({"name": "heis-chain-L64-chi128", "source": "x",
                             "file": "portbench/configs/"
                                     "heis-chain-L64-chi128.json",
                             "reduced": ["L"], "why": "x"})
    bench["workloads"].append({"name": "dmrg2-heis64-f64",
                               "config": "heis-chain-L64-chi128",
                               "traffic": "dmrg2-f64-short", "chips": 1,
                               "why": "x"})
    bench["per_layer"].append({"name": "sweeps_seen", "unit": "count",
                               "better": "higher", "source": "program_span",
                               "layer": "sweep driver",
                               "moves": "dmrg_sweep_s"})
    for m in bench["end_to_end"]:
        if "workloads" in m and "dmrg2-heis128-f64" in m["workloads"]:
            m["workloads"].append("dmrg2-heis64-f64")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    spec = registry.cell_spec("dmrg2-heis64-f64", root=root)
    assert spec["config"]["L"] == 64
    assert spec["mix"]["sweeps_per_episode"] == 4
    assert "sweeps_seen" in spec["per_layer"]
    assert "sandwich_roofline" not in spec["per_layer"]
    assert spec["end_to_end"] == ["setup_s", "dmrg_sweep_s"]
    read = registry.metric_reader("sweeps_seen", root=root)
    assert read(type("Ctx", (), {"steps": 7})) == 7
    ref = registry.reference("heis-chain-L64-chi128", root=root)
    assert len(ref.mpo(spec["config"])) == 64
    # a metric without "workloads" reaches every cell reporting what it moves
    for cell in ("dmrg2-heis128-f64", "dmrg2-heis128-c128"):
        assert "sweeps_seen" in registry.metrics_of(bench, cell, "per_layer")
    assert "sweeps_seen" not in registry.metrics_of(bench, "ed-heis4x6-sz0",
                                                    "per_layer")
