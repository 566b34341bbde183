"""Whole runs at small sizes on the CPU, past the look for a card: a sound run
is correct and prints the result line's schema; the control of each cell,
and each fault a cell can have planted underneath the timed path, come out
not correct. The float32 cell's control (TF32) exists only on a card.

The faults a cell of this benchmark can have: a step that returns its
state unchanged, and an answer altered where it is produced. No step here
has a batch to halve, and every cell runs on one card, with no exchange
between cards to leave out.
"""

import json
import time

import pytest
import torch

import quimb_torch
from portbench.harness import registry, runner
from quimb_torch.tensor.tn1d import dmrg

CELLS = ["dmrg2-heis128-f64", "ed-heis4x6-sz0", "dmrg2-heis128-c128",
         "dmrg2-heis128-f32"]
DMRG_CELLS = [c for c in CELLS if c.startswith("dmrg2")]
#: long enough for a whole episode of six sweeps at the small size
SECONDS = 0.8


def _run(spec, seed=2**33 + 5, trace=False, variant=None, device="cpu"):
    return runner.run(spec, seed, SECONDS, trace, device, quimb_torch,
                      torch, time.perf_counter(), variant=variant)[0]


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct_and_has_the_result_schema(cell, small):
    spec = small(cell)
    r = _run(spec)
    assert list(r) == ["correct", "attempted", "failed", "metrics", "device",
                       "checks"]
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] > 0
    assert set(r["metrics"]) == set(spec["end_to_end"])
    for name, m in r["metrics"].items():
        assert set(m) == {"value", "unit"} and m["value"] > 0
        assert m["unit"] == spec["units"][name]
    assert set(r["device"]) == {"platform", "kind", "count",
                                "memory_peak_bytes"}
    for c in r["checks"].values():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"]
    json.loads(json.dumps(r))


def test_a_traced_run_keeps_the_schema(small):
    r = _run(small("ed-heis4x6-sz0"), trace=True)
    assert list(r)[-1] == "checks" and r["correct"] is True
    assert {"busy_s", "window_s"} <= set(r["device"])
    assert set(r["metrics"]) <= set(small("ed-heis4x6-sz0")["per_layer"])
    # the counting wrapper sees every matvec of the window's solves
    assert r["metrics"]["ed_matvecs_per_solve"]["value"] >= 20


def test_spans_put_on_mid_episode_reach_the_running_engine(small):
    """A traced run puts its spans on after the first steps of the window,
    inside an episode: the engine that episode already built has its
    sandwich matvecs wrapped too."""
    from portbench.harness.spans import Spans

    spec = small("dmrg2-heis128-f64")
    drv = registry.driver(spec["mix"]["algorithm"])(
        quimb_torch, spec["config"], spec["mix"], 3, "cpu")
    drv.setup()
    drv.step()
    assert drv.current is not None
    sp = Spans()
    drv.instrument(sp)
    try:
        drv.step()
    finally:
        sp.restore()
    assert sp.counts["local_solve"] == sp.counts["split"] > 0
    # a span around each matvec of each local solve
    assert sp.counts["sandwich"] >= 2 * sp.counts["local_solve"]


def test_solves_close_only_after_whole_passes_over_the_pool(small):
    """Every seed does the same set of solves, in its own order."""
    spec = small("ed-heis4x6-sz0")
    drv = registry.driver(spec["mix"]["algorithm"])(
        quimb_torch, spec["config"], spec["mix"], 2**33 + 1, "cpu")
    pool = int(spec["mix"]["start_pool"])
    assert sorted(drv.order) == list(range(pool))
    for n, whole in [(0, True), (1, False), (pool - 1, False), (pool, True),
                     (pool + 1, False), (2 * pool, True)]:
        drv.energies = [0.0] * n
        assert drv.at_boundary() is whole


@pytest.mark.parametrize("cell", CELLS)
def test_one_seed_gives_the_same_inputs(cell, small):
    """The inputs of a run (random states, start vectors) follow from its
    seed and their own number alone."""
    spec = small(cell)

    def inputs(seed):
        drv = registry.driver(spec["mix"]["algorithm"])(
            quimb_torch, spec["config"], spec["mix"], seed, "cpu")
        x = drv.make_input("solve" if cell.startswith("ed") else "episode",
                           3)
        return [t.data for t in x] if hasattr(x, "tensors") else [x]

    a, b, c = inputs(2**40 + 1), inputs(2**40 + 1), inputs(2**40 + 2)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not all(torch.equal(x, y) for x, y in zip(a, c))


@pytest.mark.parametrize("cell", ["dmrg2-heis128-f64", "dmrg2-heis128-c128",
                                  "ed-heis4x6-sz0"])
def test_the_control_is_not_correct(cell, small):
    """The control a precision lower: the program in float32 for float64
    (and for the 4x6 solves); for complex128 the plain product of the
    sandwich in complex64 in the program's place (the program's own
    complex64 sweep fails on the card, its split's eigh not converging)."""
    spec = small(cell)
    r = _run(spec, variant=spec["mix"]["control"])
    assert r["correct"] is False


@pytest.mark.cuda
def test_the_float32_control_is_not_correct_on_a_card(small, card):
    """TF32 products in place of the float32 path: the plain einsum of the
    sandwich and every float32 matmul of the sweep."""
    spec = small("dmrg2-heis128-f32")
    assert _run(spec, device=card)["correct"] is True
    r = _run(spec, variant=spec["mix"]["control"], device=card)
    assert r["correct"] is False


def _unchanged_sweep(orig):
    def sweep(self, *args, **kwargs):
        before = list(self._A)
        energy = orig(self, *args, **kwargs)
        self._A = before
        return energy
    return sweep


def _altered_sweep(orig):
    def sweep(self, *args, **kwargs):
        energy = orig(self, *args, **kwargs)
        return energy + 1e-3 * abs(energy)
    return sweep


@pytest.mark.parametrize("cell", DMRG_CELLS)
@pytest.mark.parametrize("fault", [_unchanged_sweep, _altered_sweep])
def test_a_dmrg_fault_is_not_correct(cell, fault, small, monkeypatch):
    monkeypatch.setattr(dmrg.DMRG, "sweep", fault(dmrg.DMRG.sweep))
    assert _run(small(cell))["correct"] is False


def _unchanged_solve(orig):
    def groundenergy(op, v0, **kwargs):
        return torch.vdot(v0, op @ v0).real / torch.vdot(v0, v0).real
    return groundenergy


def _altered_solve(orig):
    def groundenergy(op, **kwargs):
        return orig(op, **kwargs) * (1 + 1e-7)
    return groundenergy


@pytest.mark.parametrize("fault", [_unchanged_solve, _altered_solve])
def test_a_solve_fault_is_not_correct(fault, small, monkeypatch):
    monkeypatch.setattr(quimb_torch, "groundenergy",
                        fault(quimb_torch.groundenergy))
    assert _run(small("ed-heis4x6-sz0"))["correct"] is False
