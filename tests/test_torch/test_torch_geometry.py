"""quimb_torch's lattice edge generators (``tensor/geometry.py``) against
quimb_tpu's: the same edge lists, exactly, for every lattice, open and
cyclic, and the random graphs under one seed."""

import pytest

import quimb_torch.tensor as ttn
import quimb_tpu.tensor as jtn
from quimb_torch.tensor import geometry

LATTICES = [
    ("edges_1d_chain", (7,)),
    ("edges_2d_square", (3, 4)),
    ("edges_2d_hexagonal", (3, 3)),
    ("edges_2d_triangular", (3, 4)),
    ("edges_2d_triangular_rectangular", (3, 3)),
    ("edges_2d_kagome", (3, 2)),
    ("edges_3d_cubic", (2, 3, 2)),
    ("edges_3d_diamond", (2, 2, 2)),
    ("edges_3d_diamond_cubic", (2, 2, 2)),
    ("edges_3d_pyrochlore", (2, 2, 2)),
]


@pytest.mark.parametrize("cyclic", [False, True])
@pytest.mark.parametrize("name,dims", LATTICES)
def test_lattice_edges_match(name, dims, cyclic):
    got = getattr(ttn, name)(*dims, cyclic=cyclic)
    assert got == getattr(jtn, name)(*dims, cyclic=cyclic)
    assert getattr(geometry, name) is getattr(ttn, name)
    assert len(got) == len(set(got)) > 0


@pytest.mark.parametrize("name,dims", [
    (n, d) for n, d in LATTICES if n != "edges_1d_chain"])
def test_cells_and_mixed_cyclic_match(name, dims):
    """A subset of cells, and periodic along the first axis only."""
    cells = [tuple(0 for _ in dims), tuple(1 for _ in dims)]
    cyclic = (True,) + (False,) * (len(dims) - 1)
    got = getattr(ttn, name)(*dims, cyclic=cyclic, cells=cells)
    assert got == getattr(jtn, name)(*dims, cyclic=cyclic, cells=cells)


@pytest.mark.parametrize("seed", [0, 7])
def test_random_graphs_match(seed):
    assert ttn.edges_rand_reg(12, 3, seed=seed) == \
        jtn.edges_rand_reg(12, 3, seed=seed)
    assert ttn.edges_tree_rand(15, max_degree=3, seed=seed) == \
        jtn.edges_tree_rand(15, max_degree=3, seed=seed)
    degrees = {}
    for a, b in ttn.edges_rand_reg(12, 3, seed=seed):
        degrees[a] = degrees.get(a, 0) + 1
        degrees[b] = degrees.get(b, 0) + 1
    assert set(degrees.values()) == {3}
