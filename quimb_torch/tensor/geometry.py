"""Lattice edge generators: chain, square, hexagonal, triangular, kagome,
cubic, diamond, pyrochlore, random trees and random regular graphs.

A copy of quimb_tpu's ``tensor/geometry.py`` (reference
``quimb/tensor/geometry.py``:19-542). It is numpy only and runs on the
host: the arbitrary-geometry builders take its edge lists.
"""

import itertools

import numpy as np


def _maybe_wrap(coo, dims, cyclic):
    out = []
    for x, d, c in zip(coo, dims, cyclic):
        if x < 0 or x >= d:
            if not c:
                return None
            x = x % d
        out.append(x)
    return tuple(out)


def _parse_cyclic(cyclic, ndim):
    if isinstance(cyclic, bool):
        return (cyclic,) * ndim
    return tuple(cyclic)


def edges_1d_chain(L, cyclic=False):
    """Edges of a 1D chain."""
    edges = [(i, i + 1) for i in range(L - 1)]
    if cyclic and L > 2:
        edges.append((L - 1, 0))
    return edges


def edges_2d_square(Lx, Ly, cyclic=False, cells=None):
    """Edges of a 2D square lattice, sites (i, j)."""
    cyclic = _parse_cyclic(cyclic, 2)
    if cells is None:
        cells = itertools.product(range(Lx), range(Ly))
    edges = []
    for (i, j) in cells:
        for di, dj in ((0, 1), (1, 0)):
            other = _maybe_wrap((i + di, j + dj), (Lx, Ly), cyclic)
            if other is not None and other != (i, j):
                edges.append(((i, j), other))
    return sorted(set(map(lambda e: tuple(sorted(e)), edges)))


def edges_2d_hexagonal(Lx, Ly, cyclic=False, cells=None):
    """Edges of a 2D hexagonal (honeycomb) lattice; sites (i, j, s)
    with s in 'AB'."""
    cyclic = _parse_cyclic(cyclic, 2)
    if cells is None:
        cells = itertools.product(range(Lx), range(Ly))
    edges = set()
    for (i, j) in cells:
        a = (i, j, "A")
        # A connects to B in same cell, and B of neighbors
        for (di, dj) in ((0, 0), (0, -1), (-1, 0)):
            w = _maybe_wrap((i + di, j + dj), (Lx, Ly), cyclic)
            if w is not None:
                edges.add(tuple(sorted((a, (w[0], w[1], "B")))))
    return sorted(edges)


def edges_2d_triangular(Lx, Ly, cyclic=False, cells=None):
    """Edges of a 2D triangular lattice."""
    cyclic = _parse_cyclic(cyclic, 2)
    if cells is None:
        cells = itertools.product(range(Lx), range(Ly))
    edges = set()
    for (i, j) in cells:
        for di, dj in ((0, 1), (1, 0), (1, -1)):
            w = _maybe_wrap((i + di, j + dj), (Lx, Ly), cyclic)
            if w is not None and w != (i, j):
                edges.add(tuple(sorted(((i, j), w))))
    return sorted(edges)


def edges_2d_kagome(Lx, Ly, cyclic=False, cells=None):
    """Edges of a 2D kagome lattice; sites (i, j, s), s in 'ABC'."""
    cyclic = _parse_cyclic(cyclic, 2)
    if cells is None:
        cells = itertools.product(range(Lx), range(Ly))
    edges = set()
    for (i, j) in cells:
        A, B, C = ((i, j, s) for s in "ABC")
        # in-cell triangle
        edges.add(tuple(sorted((A, B))))
        edges.add(tuple(sorted((B, C))))
        edges.add(tuple(sorted((A, C))))
        # inter-cell
        w = _maybe_wrap((i, j + 1), (Lx, Ly), cyclic)
        if w is not None:
            edges.add(tuple(sorted((B, (w[0], w[1], "A")))))
        w = _maybe_wrap((i + 1, j), (Lx, Ly), cyclic)
        if w is not None:
            edges.add(tuple(sorted((C, (w[0], w[1], "A")))))
        w = _maybe_wrap((i + 1, j - 1), (Lx, Ly), cyclic)
        if w is not None:
            edges.add(tuple(sorted((C, (w[0], w[1], "B")))))
    return sorted(edges)


def edges_3d_cubic(Lx, Ly, Lz, cyclic=False, cells=None):
    """Edges of a 3D cubic lattice."""
    cyclic = _parse_cyclic(cyclic, 3)
    if cells is None:
        cells = itertools.product(range(Lx), range(Ly), range(Lz))
    edges = set()
    for (i, j, k) in cells:
        for d in ((0, 0, 1), (0, 1, 0), (1, 0, 0)):
            w = _maybe_wrap(
                (i + d[0], j + d[1], k + d[2]), (Lx, Ly, Lz), cyclic
            )
            if w is not None and w != (i, j, k):
                edges.add(tuple(sorted(((i, j, k), w))))
    return sorted(edges)


def edges_3d_diamond(Lx, Ly, Lz, cyclic=False, cells=None):
    """Edges of a 3D diamond lattice; sites (i, j, k, s), s in 'AB'."""
    cyclic = _parse_cyclic(cyclic, 3)
    if cells is None:
        cells = itertools.product(range(Lx), range(Ly), range(Lz))
    edges = set()
    for (i, j, k) in cells:
        a = (i, j, k, "A")
        for d in ((0, 0, 0), (0, 0, -1), (0, -1, 0), (-1, 0, 0)):
            w = _maybe_wrap(
                (i + d[0], j + d[1], k + d[2]), (Lx, Ly, Lz), cyclic
            )
            if w is not None:
                edges.add(tuple(sorted((a, (*w, "B")))))
    return sorted(edges)


def edges_3d_pyrochlore(Lx, Ly, Lz, cyclic=False, cells=None):
    """Edges of a 3D pyrochlore lattice; sites (i, j, k, s),
    s in 'ABCD' (corner-sharing tetrahedra)."""
    cyclic = _parse_cyclic(cyclic, 3)
    if cells is None:
        cells = itertools.product(range(Lx), range(Ly), range(Lz))
    edges = set()
    for (i, j, k) in cells:
        A, B, C, D = ((i, j, k, s) for s in "ABCD")
        for pair in itertools.combinations((A, B, C, D), 2):
            edges.add(tuple(sorted(pair)))
        # inter-tetrahedra bonds
        for (s, d, s2) in (
            ("B", (0, 0, 1), "A"), ("C", (0, 1, 0), "A"),
            ("D", (1, 0, 0), "A"),
            ("C", (0, 1, -1), "B"), ("D", (1, 0, -1), "B"),
            ("D", (1, -1, 0), "C"),
        ):
            w = _maybe_wrap(
                (i + d[0], j + d[1], k + d[2]), (Lx, Ly, Lz), cyclic
            )
            if w is not None:
                edges.add(
                    tuple(sorted(((i, j, k, s), (*w, s2))))
                )
    return sorted(edges)


def edges_tree_rand(n, max_degree=None, seed=None):
    """Random tree edges on n nodes."""
    rng = np.random.default_rng(seed)
    edges = []
    degree = {0: 0}
    for i in range(1, n):
        choices = [
            u for u in degree
            if max_degree is None or degree[u] < max_degree
        ]
        u = int(rng.choice(choices))
        edges.append((u, i))
        degree[u] += 1
        degree[i] = 1
    return edges


def edges_rand_reg(n, k, seed=None):
    """Random k-regular graph edges (simple pairing model with
    retries)."""
    rng = np.random.default_rng(seed)
    for _ in range(1000):
        stubs = np.repeat(np.arange(n), k)
        rng.shuffle(stubs)
        pairs = stubs.reshape(-1, 2)
        edges = set()
        ok = True
        for a, b in pairs:
            a, b = int(a), int(b)
            if a == b or (min(a, b), max(a, b)) in edges:
                ok = False
                break
            edges.add((min(a, b), max(a, b)))
        if ok:
            return sorted(edges)
    raise RuntimeError("failed to generate random regular graph")


def edges_2d_triangular_rectangular(Lx, Ly, cyclic=False, cells=None):
    """Edges of a 2D triangular lattice tiled rectangularly; two sites
    per cell, labelled (i, j, s) for s in 'AB' (reference
    ``edges_2d_triangular_rectangular`` geometry.py:168)."""
    cyclic = _parse_cyclic(cyclic, 2)
    if cells is None:
        cells = itertools.product(range(Lx), range(Ly))
    edges = set()
    for i, j in cells:
        A = (i, j, "A")
        B = (i, j, "B")
        for src, (di, dj), lbl in [
            (A, (0, 0), "B"),
            (A, (0, -1), "B"),
            (A, (0, 1), "A"),
            (B, (1, 0), "A"),
            (B, (0, 1), "B"),
            (B, (1, 1), "A"),
        ]:
            w = _maybe_wrap((i + di, j + dj), (Lx, Ly), cyclic)
            if w is not None:
                dst = (*w, lbl)
                if dst != src:
                    edges.add(tuple(sorted((src, dst))))
    return sorted(edges)


def edges_3d_diamond_cubic(Lx, Ly, Lz, cyclic=False, cells=None):
    """Edges of a 3D diamond lattice tiled cubically; eight sites per
    cell, labelled (i, j, k, s) for s in 'ABCDEFGH' (reference
    ``edges_3d_diamond_cubic`` geometry.py:448)."""
    cyclic = _parse_cyclic(cyclic, 3)
    if cells is None:
        cells = itertools.product(range(Lx), range(Ly), range(Lz))
    neighbor_spec = {
        "A": [((0, 0, 0), "E")],
        "B": [((0, 0, 0), "E"), ((0, 0, 0), "F")],
        "C": [((0, 0, 0), "E"), ((0, 0, 0), "G")],
        "D": [((0, 0, 0), "E"), ((0, 0, 0), "H")],
        "F": [((0, 1, 0), "C"), ((1, 0, 0), "D")],
        "G": [((1, 0, 1), "A"), ((0, 0, 1), "B"), ((1, 0, 0), "D")],
        "H": [((0, 1, 1), "A"), ((0, 0, 1), "B"), ((0, 1, 0), "C")],
    }
    edges = set()
    for i, j, k in cells:
        for s, nbrs in neighbor_spec.items():
            src = (i, j, k, s)
            for (di, dj, dk), lbl in nbrs:
                w = _maybe_wrap(
                    (i + di, j + dj, k + dk), (Lx, Ly, Lz), cyclic
                )
                if w is not None:
                    edges.add(tuple(sorted((src, (*w, lbl)))))
    return sorted(edges)


__all__ = [
    "edges_1d_chain", "edges_2d_square", "edges_2d_hexagonal",
    "edges_2d_triangular", "edges_2d_kagome", "edges_3d_cubic",
    "edges_3d_diamond", "edges_3d_pyrochlore", "edges_tree_rand",
    "edges_rand_reg", "edges_2d_triangular_rectangular",
    "edges_3d_diamond_cubic",
]
