"""The plain references at small sizes, and their independence of the
program."""

import ast
import math

import pytest
import torch

from portbench.harness import registry

CHAIN = "heis-chain-L128-chi256"
TORUS = "heis-torus-4x6-sz0"
FORBIDDEN_IMPORTS = {"quimb_torch", "quimb_tpu", "jax", "jaxlib", "flax",
                     "portbench"}


def _chain(L, bz=0.0):
    cfg = dict(registry.cell_spec("dmrg2-heis128-f64")["config"])
    cfg.update(L=L, bz=bz)
    return cfg


@pytest.mark.parametrize("bz", [0.0, 0.3])
def test_chain_mpo_equals_the_dense_hamiltonian(bz):
    ref = registry.reference(CHAIN)
    cfg = _chain(6, bz)
    Hd = ref.dense_hamiltonian(cfg)
    Hm = ref.mpo_to_dense(ref.mpo(cfg))
    assert torch.allclose(Hd, Hm, rtol=0, atol=1e-14)
    assert torch.allclose(Hd, Hd.T)


def test_chain_ground_energy_of_six_sites():
    ref = registry.reference(CHAIN)
    e = torch.linalg.eigvalsh(ref.dense_hamiltonian(_chain(6)))[0]
    assert float(e) == pytest.approx(-2.4935771338879276, abs=1e-12)


@pytest.mark.parametrize("dtype", [torch.float64, torch.complex128])
def test_chain_energy_of_a_random_mps_equals_the_dense_expectation(dtype):
    ref = registry.reference(CHAIN)
    L, chi = 7, 3
    cfg = _chain(L)
    gen = torch.Generator().manual_seed(5)
    dims = [min(chi, 2**i, 2 ** (L - i)) for i in range(L + 1)]
    arrays = [torch.randn((dims[i], 2, dims[i + 1]), generator=gen,
                          dtype=dtype) for i in range(L)]
    psi = arrays[0]
    for a in arrays[1:]:
        psi = torch.tensordot(psi, a, dims=([psi.ndim - 1], [0]))
    psi = psi.reshape(-1)
    H = ref.dense_hamiltonian(cfg).to(dtype)
    want = (torch.vdot(psi, H @ psi) / torch.vdot(psi, psi)).real
    assert ref.energy(arrays, cfg) == pytest.approx(float(want), rel=1e-13)


def test_torus_4x4_ground_energy():
    ref = registry.reference(TORUS)
    cfg = dict(registry.cell_spec("ed-heis4x6-sz0")["config"])
    cfg.update(lattice={**cfg["lattice"], "args": [4, 4]}, sector=8)
    assert len(ref.edges(cfg)) == 32
    _, D = ref.sector_matrix(cfg)
    assert D == math.comb(16, 8)
    assert ref.ground_energy(cfg) == pytest.approx(-11.228483208428864,
                                                   abs=1e-12)


def test_torus_4x6_sizes():
    ref = registry.reference(TORUS)
    cfg = registry.cell_spec("ed-heis4x6-sz0")["config"]
    assert len(ref.edges(cfg)) == 48
    assert math.comb(24, 12) == cfg["D"] == 2_704_156


@pytest.mark.parametrize("name", [CHAIN, TORUS])
def test_references_import_nothing_of_the_program(name):
    path = registry.PKG / "reference" / f"{name}.py"
    tree = ast.parse(path.read_text())
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            tops.add((node.module or "").split(".")[0] if not node.level
                     else ".")
    assert not tops & (FORBIDDEN_IMPORTS | {"."})
