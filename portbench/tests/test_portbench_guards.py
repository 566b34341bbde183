"""The guards: no card, no result; no JAX or quimb_tpu in the process."""

import subprocess
import sys
import types

import pytest

from portbench.harness import guards, registry


@pytest.mark.parametrize("modules, found", [
    ({"quimb_torch": 1, "quimb_torch.ops.decomp": 1, "torch": 1}, []),
    ({"quimb_torch": 1, "quimb_tpu": 1}, ["quimb_tpu"]),
    ({"quimb_tpu.tensor.tn1d": 1}, ["quimb_tpu.tensor.tn1d"]),
    ({"jax": 1, "jax.numpy": 1}, ["jax", "jax.numpy"]),
    ({"jaxlib.xla_client": 1, "flax": 1}, ["flax", "jaxlib.xla_client"]),
    ({"jaxtyping": 1, "quimb_tpu_extra": 1, "myjax": 1}, []),
])
def test_forbidden_modules_compare_whole_top_level_names(modules, found):
    assert guards.forbidden_modules(modules) == found


def test_this_test_process_loads_neither():
    assert guards.forbidden_modules() == []


def _fake_torch(available, count):
    cuda = types.SimpleNamespace(is_available=lambda: available,
                                 device_count=lambda: count)
    return types.SimpleNamespace(cuda=cuda)


@pytest.mark.parametrize("available, count, chips", [
    (False, 0, 1), (True, 1, 4), (True, 0, 1)])
def test_require_cards_refuses_too_few(available, count, chips):
    with pytest.raises(guards.NoCard):
        guards.require_cards(_fake_torch(available, count), chips)


def test_require_cards_takes_enough():
    guards.require_cards(_fake_torch(True, 4), 4)


def test_run_without_a_card_prints_no_result():
    """On a machine without a card the command exits non-zero, says so,
    and prints nothing on standard output."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    p = subprocess.run(
        [sys.executable, str(registry.PKG / "run.py"), "--workload",
         "dmrg2-heis128-f64", "--seed", "0", "--seconds", "10",
         "--trace", "0"], capture_output=True, text=True, timeout=120,
        cwd=registry.ROOT)
    assert p.returncode != 0
    assert p.stdout == ""
    assert "no CUDA card" in p.stderr
