"""Fixtures of the benchmark's tests: the cells at sizes a CPU test can hold,
and the look for a card (tests marked ``cuda`` skip without one)."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from portbench.harness import registry  # noqa: E402

#: the small chain: every bond is exact at chi=64, so DMRG2 reaches the
#: exact ground energy, which a dense eigensolve gives
SMALL_L, SMALL_CHI = 12, 64


def small_spec(cell):
    """The spec of ``cell`` with its configuration cut to a small size: the
    chain to L=12 at chi=64 (``E_REF`` its exact ground energy), the torus
    to 4 x 4 (sector of 8 set bits, D=12,870)."""
    spec = registry.cell_spec(cell)
    c = dict(spec["config"])
    if "L" in c:
        c.update(L=SMALL_L, max_bond=SMALL_CHI,
                 program={**c["program"], "args": [SMALL_L]})
        ref = registry.reference(spec["config_name"])
        c["E_REF"] = float(torch.linalg.eigvalsh(
            ref.dense_hamiltonian(c))[0])
    else:
        c.update(lattice={**c["lattice"], "args": [4, 4]}, sector=8,
                 D=12870)
    spec["config"] = c
    return spec


@pytest.fixture
def small():
    torch.set_num_threads(2)
    return small_spec


@pytest.fixture
def card():
    """Skip unless a CUDA card is present."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
