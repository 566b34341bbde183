"""Tensor network visualization (reference ``quimb/tensor/drawing.py``,
1721 LoC: layouts, edge weights = bond dims, node colors by tags, 2D/3D,
matplotlib + plotly backends, isometry arrows, hyper-edge nodes).

Port of quimb_tpu's ``tensor/drawing.py``: host code, no device work; a
tensor's entries are copied to the host to be drawn. The layout engines
are implemented natively (vectorized numpy force layout, Laplacian
spectral), with networkx used opportunistically when installed.
matplotlib and plotly are imported only inside the functions that draw.
"""

import collections
import colorsys
import hashlib
import itertools
import math

import numpy as np

from ..ops.backend import to_host


# --------------------------------------------------------------------------
# graph extraction
# --------------------------------------------------------------------------


def _build_graph(tn, show_inds=None):
    """Extract a drawable graph from ``tn``.

    Returns ``(nodes, edges, hyper_nodes)`` where nodes are tids plus
    pseudo-nodes: ``__outer__{ix}`` for dangling indices and
    ``__hyper__{ix}`` for indices shared by three or more tensors
    (drawn as a small junction dot, reference drawing.py multi-edge
    handling)."""
    nodes = list(tn.tensor_map)
    edges = []
    hyper_nodes = []
    outer_nodes = []
    for ix, tids in tn.ind_map.items():
        tids = tuple(tids)
        d = tn.ind_size(ix)
        n_occ = sum(tn.tensor_map[t].inds.count(ix) for t in tids)
        if len(tids) == 1 and n_occ == 1:
            node = f"__outer__{ix}"
            outer_nodes.append(node)
            edges.append((tids[0], node, d, ix))
        elif len(tids) > 2 or n_occ > 2:
            # hyper index: star junction
            node = f"__hyper__{ix}"
            hyper_nodes.append(node)
            for t in tids:
                edges.append((t, node, d, ix))
        else:
            if len(tids) == 2:
                edges.append((tids[0], tids[1], d, ix))
            else:
                # trace index (both ends on one tensor): self loop,
                # drawn as a stub pair
                node = f"__outer__{ix}"
                outer_nodes.append(node)
                edges.append((tids[0], node, d, ix))
    return nodes, edges, hyper_nodes, outer_nodes


# --------------------------------------------------------------------------
# layouts
# --------------------------------------------------------------------------


def _spring_layout(all_nodes, edges, dim=2, seed=42, iterations=200,
                   k=None, fix=None):
    """Vectorized Fruchterman-Reingold force layout (the native
    replacement for networkx's ``spring_layout``). Edge weights pull
    fat bonds closer (reference ``use_spring_weight``)."""
    n = len(all_nodes)
    idx = {node: i for i, node in enumerate(all_nodes)}
    rng = np.random.default_rng(seed)
    P = rng.standard_normal((n, dim))
    fixed_idx = []
    if fix:
        for node, xy in fix.items():
            if node in idx:
                P[idx[node], : len(xy)] = np.asarray(xy, float)
                fixed_idx.append(idx[node])
    if k is None:
        k = 1.0 / math.sqrt(max(n, 1))
    E = np.array(
        [(idx[a], idx[b]) for (a, b, _, _) in edges], dtype=int
    ).reshape(-1, 2)
    W = np.array(
        [1.0 + math.log2(d) for (_, _, d, _) in edges]
    ).reshape(-1, 1)
    t = 0.1
    dt = t / max(iterations, 1)
    for _ in range(iterations):
        diff = P[:, None, :] - P[None, :, :]
        dist = np.sqrt((diff**2).sum(-1)) + 1e-9
        # repulsion k^2 / d
        F = (diff / dist[..., None]) * (k * k / dist)[..., None]
        F = F.sum(axis=1)
        if len(E):
            d_e = P[E[:, 0]] - P[E[:, 1]]
            dist_e = np.sqrt((d_e**2).sum(-1, keepdims=True)) + 1e-9
            # attraction d^2 / k, weighted
            fa = d_e * (dist_e / k) * W
            np.add.at(F, E[:, 0], -fa)
            np.add.at(F, E[:, 1], fa)
        norm = np.sqrt((F**2).sum(-1, keepdims=True)) + 1e-9
        P += F / norm * np.minimum(norm, t)
        if fixed_idx:
            for node, xy in fix.items():
                if node in idx:
                    P[idx[node], : len(xy)] = np.asarray(xy, float)
        t -= dt
    return {node: P[idx[node]] for node in all_nodes}


def _spectral_layout(all_nodes, edges, dim=2):
    """Laplacian-eigenvector layout (native ``spectral_layout``)."""
    n = len(all_nodes)
    idx = {node: i for i, node in enumerate(all_nodes)}
    A = np.zeros((n, n))
    for (a, b, d, _) in edges:
        w = 1.0 + math.log2(d)
        A[idx[a], idx[b]] += w
        A[idx[b], idx[a]] += w
    D = np.diag(A.sum(1))
    L = D - A
    vals, vecs = np.linalg.eigh(L)
    # skip the trivial constant mode(s)
    order = np.argsort(vals)
    cols = []
    for j in order:
        if vals[j] > 1e-9:
            cols.append(j)
        if len(cols) == dim:
            break
    while len(cols) < dim:
        cols.append(order[min(len(cols) + 1, n - 1)])
    P = vecs[:, cols]
    return {node: P[idx[node]] for node in all_nodes}


def _circular_layout(all_nodes, dim=2):
    n = len(all_nodes)
    pos = {}
    for i, node in enumerate(all_nodes):
        th = 2 * math.pi * i / max(n, 1)
        p = [math.cos(th), math.sin(th)] + [0.0] * (dim - 2)
        pos[node] = np.asarray(p[:dim])
    return pos


def _random_layout(all_nodes, dim=2, seed=42):
    rng = np.random.default_rng(seed)
    return {node: rng.uniform(-1, 1, dim) for node in all_nodes}


def layout_positions(tn, layout="spring", fix=None, seed=42,
                     iterations=200, k=None, dim=2,
                     initial_layout=None):
    """Compute ``dim``-dimensional positions for each node of ``tn``
    (reference ``get_positions``). Layouts: ``'spring'`` (default,
    optionally seeded by ``initial_layout``), ``'spectral'``,
    ``'circular'``, ``'random'``, ``'kamada_kawai'`` (networkx if
    installed, else spectral)."""
    nodes, edges, hyper, outer = _build_graph(tn)
    all_nodes = list(dict.fromkeys(
        itertools.chain(nodes, hyper, outer)
    ))
    if tn.num_tensors == 1 and fix is None:
        # single tensor: arrange its dangling indices around it in a
        # circle (2D) or phyllotaxis sphere (3D) — reference
        # ``layout_single_tensor`` drawing.py:1267
        return layout_single_tensor(tn, dim=dim)
    if layout == "circular":
        return _circular_layout(all_nodes, dim)
    if layout == "random":
        return _random_layout(all_nodes, dim, seed)
    if layout == "spectral":
        return _spectral_layout(all_nodes, edges, dim)
    if layout == "kamada_kawai":
        try:
            import networkx as nx

            G = nx.Graph()
            G.add_nodes_from(all_nodes)
            for (a, b, d, ix) in edges:
                G.add_edge(a, b, weight=1.0 + math.log2(d))
            return nx.kamada_kawai_layout(G, dim=dim)
        except ImportError:
            return _spectral_layout(all_nodes, edges, dim)
    # spring, possibly seeded from a cheaper global layout
    init = fix
    if initial_layout in ("spectral", "circular") and not fix:
        init = (
            _spectral_layout(all_nodes, edges, dim)
            if initial_layout == "spectral"
            else _circular_layout(all_nodes, dim)
        )
        return _spring_layout(
            all_nodes, edges, dim=dim, seed=seed,
            iterations=iterations, k=k, fix=init,
        )
    return _spring_layout(
        all_nodes, edges, dim=dim, seed=seed, iterations=iterations,
        k=k, fix=fix,
    )


def phyllotaxis_points(n):
    """``n`` roughly equispaced points on the unit sphere (Kogan's
    phyllotaxis construction — reference ``phyllotaxis_points``
    drawing.py:1240)."""
    if n == 1:
        return [(1.0, 0.0, 0.0)]
    x = 0.1 + 1.2 * n
    pts = []
    start = -1.0 + 1.0 / (n - 1.0)
    increment = (2.0 - 2.0 / (n - 1.0)) / (n - 1.0)
    for j in range(n):
        s = start + j * increment
        lat = (
            math.pi / 2.0 * math.copysign(1, s)
            * (1.0 - math.sqrt(1.0 - abs(s)))
        )
        lon = s * x
        pts.append((
            math.cos(lon) * math.cos(lat),
            math.sin(lon) * math.cos(lat),
            math.sin(lat),
        ))
    return pts


def layout_single_tensor(tn, dim=2):
    """Layout the indices of a single-tensor network around it in a
    circle (2D) or phyllotaxis sphere (3D) — reference
    ``layout_single_tensor`` drawing.py:1267."""
    ((tid, t),) = tn.tensor_map.items()
    pos = {tid: (0.0,) * dim}
    names = [f"__outer__{ix}" for ix in t.inds]
    if dim == 2:
        angles = np.linspace(0, 2 * np.pi, max(t.ndim, 1),
                             endpoint=False)
        for name, angle in zip(names, angles):
            pos[name] = (-math.cos(angle), math.sin(angle))
    else:
        for name, coo in zip(names, phyllotaxis_points(t.ndim)):
            pos[name] = coo
    return pos


def massage_pos(pos, nangles=360, flatten=False):
    """Rotate a 2D position dict to minimize its vertical span
    (reference ``_massage_pos`` drawing.py:1220)."""
    xy = np.array([v[:2] for v in pos.values()], dtype=float)
    best = None
    for theta in np.linspace(0, 2 * np.pi, nangles, endpoint=False):
        c, s = math.cos(theta), math.sin(theta)
        ys = s * xy[:, 0] + c * xy[:, 1]
        span = ys.max() - ys.min() if len(ys) else 0.0
        if best is None or span < best[0]:
            best = (span, theta)
    _, theta = best
    c, s = math.cos(theta), math.sin(theta)
    rxy = np.empty_like(xy)
    rxy[:, 0] = c * xy[:, 0] - s * xy[:, 1]
    rxy[:, 1] = s * xy[:, 0] + c * xy[:, 1]
    if flatten:
        rxy[:, 1] /= 2
    return {k: tuple(v) for k, v in zip(pos, rxy)}


# --------------------------------------------------------------------------
# colors
# --------------------------------------------------------------------------


def hash_to_color(s, hue_range=(0.0, 1.0), sat=0.55, val=0.85):
    """Deterministic tag -> RGB color by hashing (reference
    ``auto_color_html``-style auto coloring)."""
    h = int.from_bytes(
        hashlib.sha1(str(s).encode()).digest()[:4], "big"
    ) / 2**32
    lo, hi = hue_range
    return colorsys.hsv_to_rgb(lo + h * (hi - lo), sat, val)


def get_colors(color, custom_colors=None):
    """Resolve the ``color`` spec into an ordered {tag: rgb} map
    (reference ``get_colors`` drawing.py)."""
    if color is None:
        return {}
    if isinstance(color, str):
        color = (color,)
    color = tuple(color)
    if custom_colors is not None:
        return dict(zip(color, custom_colors))
    if len(color) <= 10:
        import matplotlib.pyplot as plt

        cmap = plt.get_cmap("tab10")
        return {tag: cmap(i % 10) for i, tag in enumerate(color)}
    return {tag: hash_to_color(tag) for tag in color}


# --------------------------------------------------------------------------
# main drawing entrypoint
# --------------------------------------------------------------------------


def draw_tn(
    tn,
    color=None,
    *,
    show_inds=None,
    show_tags=None,
    output_inds=None,
    highlight_inds=(),
    highlight_tids=(),
    highlight_inds_color=(1.0, 0.2, 0.2),
    highlight_tids_color=None,
    custom_colors=None,
    legend=True,
    dim=2,
    layout="spring",
    initial_layout=None,
    fix=None,
    pos=None,
    k=None,
    iterations=200,
    seed=42,
    node_color=None,
    node_scale=1.0,
    node_size=None,
    node_alpha=1.0,
    node_shape="o",
    node_outline_darkness=0.4,
    node_hatch="",
    edge_scale=1.0,
    edge_alpha=0.8,
    edge_color="0.5",
    multi_edge_spread=0.1,
    arrow_isometries=True,
    font_size=6,
    font_size_inner=6,
    label_color="0.3",
    isdark=None,
    figsize=(6, 6),
    margin=None,
    xlims=None,
    ylims=None,
    ax=None,
    title=None,
    backend="matplotlib",
    get=None,
    return_fig=False,
    **kwargs,
):
    """Draw a tensor network (reference ``draw`` drawing.py).

    Parameters mirror the reference: ``color`` selects tags to color
    nodes by (with auto palette or ``custom_colors``); ``dim=3`` gives
    a 3D matplotlib axes; ``backend='plotly'`` uses plotly if
    installed; ``highlight_inds``/``highlight_tids`` emphasize parts;
    ``IsoTensor`` tensors get arrows from their ``left_inds``
    (``arrow_isometries``); ``get`` may be ``'pos'`` to return the
    layout only, ``'fig'`` or ``'ax'``.
    """
    nodes, edges, hyper_nodes, outer_nodes = _build_graph(tn)
    if pos is None:
        pos = layout_positions(
            tn, layout=layout, fix=fix, seed=seed, iterations=iterations,
            k=k, dim=dim, initial_layout=initial_layout,
        )
    if get == "pos":
        return pos

    if highlight_tids_color is None:
        highlight_tids_color = highlight_inds_color
    if isdark:
        # dark-background styling (reference ``isdark``): light
        # neutrals for edges/labels
        if edge_color == "0.5":
            edge_color = "0.75"
        if label_color == "0.3":
            label_color = "0.85"

    if backend == "plotly":
        return _draw_plotly(
            tn, nodes, edges, hyper_nodes, outer_nodes, pos,
            color=color, custom_colors=custom_colors, dim=dim,
        )

    import matplotlib.pyplot as plt
    from matplotlib.lines import Line2D

    created = ax is None
    if created:
        fig = plt.figure(figsize=figsize)
        if dim == 3:
            ax = fig.add_subplot(111, projection="3d")
        else:
            ax = fig.add_subplot(111)
    else:
        fig = ax.figure
    if dim == 2:
        ax.set_aspect("equal")
    ax.axis("off")

    highlight_inds = set(highlight_inds)
    highlight_tids = set(highlight_tids)
    if show_inds is None:
        show_inds = tn.num_tensors <= 20 and "outer"

    def _p(node):
        p = pos[node]
        return tuple(p[:dim]) + (0.0,) * max(0, dim - len(p))

    # -- edges: group by endpoint pair so multibonds render as
    # separate offset curves rather than overdrawn lines (reference
    # multi-edge handling, drawing.py:736-772 ``multi_edge_spread``)
    pair_groups = {}
    for e in edges:
        a, b = e[0], e[1]
        pair_groups.setdefault(frozenset((a, b)), []).append(e)

    for group in pair_groups.values():
        multiplicity = len(group)
        if multiplicity > 1:
            offs = np.linspace(
                -multiplicity * multi_edge_spread / 2,
                +multiplicity * multi_edge_spread / 2,
                multiplicity,
            )
        else:
            offs = [0.0]
        for off, (a, b, d, ix) in zip(offs, group):
            pa, pb = _p(a), _p(b)
            lw = edge_scale * (0.8 + math.log2(d) / 2)
            if ix in highlight_inds:
                c, z = highlight_inds_color, 1.5
            else:
                c, z = edge_color, 1
            if dim == 3:
                ax.plot(*zip(pa, pb), "-", color=c, lw=lw,
                        alpha=edge_alpha)
            elif off == 0.0:
                ax.plot([pa[0], pb[0]], [pa[1], pb[1]], "-", color=c,
                        lw=lw, alpha=edge_alpha, zorder=z)
            else:
                # quadratic bezier bowed perpendicular to the chord
                mx, my = (pa[0] + pb[0]) / 2, (pa[1] + pb[1]) / 2
                dx, dy = pb[0] - pa[0], pb[1] - pa[1]
                nrm = math.hypot(dx, dy) or 1.0
                cx = mx - off * dy / nrm * 4
                cy = my + off * dx / nrm * 4
                ts = np.linspace(0.0, 1.0, 20)
                xs = ((1 - ts) ** 2 * pa[0] + 2 * (1 - ts) * ts * cx
                      + ts**2 * pb[0])
                ys = ((1 - ts) ** 2 * pa[1] + 2 * (1 - ts) * ts * cy
                      + ts**2 * pb[1])
                ax.plot(xs, ys, "-", color=c, lw=lw, alpha=edge_alpha,
                        zorder=z)
            label_it = (
                show_inds == "all"
                or (show_inds in ("outer", True)
                    and (str(b).startswith("__outer__")))
                or ix in highlight_inds
            )
            if label_it:
                mid = [(x + y) / 2 for x, y in zip(pa, pb)]
                if show_inds == "bond-size":
                    ix = str(d)
                if dim == 3:
                    ax.text(*mid, ix, fontsize=font_size_inner,
                            color=label_color)
                else:
                    ax.text(mid[0], mid[1], ix, fontsize=font_size_inner,
                            color=label_color, zorder=4)

    # -- isometry arrows
    if arrow_isometries:
        for tid in nodes:
            t = tn.tensor_map[tid]
            left_inds = getattr(t, "left_inds", None)
            if not left_inds:
                continue
            for (a, b, d, ix) in edges:
                if a == tid and ix in left_inds:
                    pa, pb = _p(a), _p(b)
                elif b == tid and ix in left_inds:
                    pa, pb = _p(b), _p(a)
                else:
                    continue
                mid = [0.5 * (x + y) for x, y in zip(pa, pb)]
                dxy = [0.12 * (y - x) for x, y in zip(pa, pb)]
                if dim == 3:
                    ax.quiver(*mid, *dxy, color="0.2",
                              arrow_length_ratio=0.6)
                else:
                    ax.annotate(
                        "", xy=(mid[0] + dxy[0], mid[1] + dxy[1]),
                        xytext=(mid[0], mid[1]),
                        arrowprops={"arrowstyle": "->", "color": "0.2"},
                    )

    # -- nodes
    tag_colors = get_colors(color, custom_colors)
    P, cs, ss, outl = [], [], [], []
    default_c = node_color if node_color is not None else (0.6, 0.6, 0.6)
    for tid in nodes:
        t = tn.tensor_map[tid]
        c = default_c
        for tag, col in tag_colors.items():
            if tag in t.tags:
                c = col[:3] if len(col) > 3 else col
                break
        if tid in highlight_tids:
            c = highlight_tids_color
        P.append(_p(tid))
        cs.append(c)
        ss.append(node_scale * (node_size or (120 + 60 * t.ndim)))
        outl.append(tuple(x * node_outline_darkness for x in c))
    P = np.asarray(P)
    if len(P):
        scatter_opts = dict(c=cs, s=ss, edgecolors=outl,
                            alpha=node_alpha, marker=node_shape)
        if node_hatch:
            scatter_opts["hatch"] = node_hatch
        if dim == 3:
            ax.scatter(P[:, 0], P[:, 1], P[:, 2], depthshade=True,
                       **scatter_opts)
        else:
            ax.scatter(P[:, 0], P[:, 1], zorder=2, **scatter_opts)
    # hyper junction dots
    for node in hyper_nodes:
        p = _p(node)
        if dim == 3:
            ax.scatter([p[0]], [p[1]], [p[2]], c="0.2", s=12)
        else:
            ax.scatter([p[0]], [p[1]], c="0.2", s=12, zorder=2)

    if show_tags is None:
        show_tags = tn.num_tensors <= 20
    if show_tags:
        for tid in nodes:
            t = tn.tensor_map[tid]
            p = _p(tid)
            txt = ",".join(map(str, list(t.tags)[:2]))
            if dim == 3:
                ax.text(*p, txt, fontsize=font_size, ha="center",
                        va="center", color=label_color)
            else:
                ax.text(p[0], p[1], txt, fontsize=font_size, ha="center",
                        va="center", zorder=3, color=label_color)

    if legend and tag_colors:
        handles = [
            Line2D([0], [0], marker="o", linestyle="", label=str(tag),
                   markerfacecolor=col, markersize=8)
            for tag, col in tag_colors.items()
        ]
        ax.legend(handles=handles, loc="upper right", fontsize=8)
    if title:
        ax.set_title(title)
    if dim == 2:
        if xlims is not None:
            ax.set_xlim(*xlims)
        if ylims is not None:
            ax.set_ylim(*ylims)
        if margin is not None and len(P):
            ax.set_xlim(P[:, 0].min() - margin, P[:, 0].max() + margin)
            ax.set_ylim(P[:, 1].min() - margin, P[:, 1].max() + margin)
    if get == "fig" or return_fig:
        return fig
    if get == "ax":
        return ax
    if created:
        plt.show()
    return ax


def _draw_plotly(tn, nodes, edges, hyper_nodes, outer_nodes, pos,
                 color=None, custom_colors=None, dim=2):
    """Plotly backend (reference drawing.py plotly path) — gated on
    plotly being installed."""
    try:
        import plotly.graph_objects as go
    except ImportError as e:
        raise ImportError(
            "plotly is not installed — use backend='matplotlib'"
        ) from e

    tag_colors = get_colors(color, custom_colors)

    def _p(node):
        p = pos[node]
        return tuple(p[:max(dim, 2)])

    edge_x, edge_y, edge_z = [], [], []
    for (a, b, d, ix) in edges:
        pa, pb = _p(a), _p(b)
        edge_x += [pa[0], pb[0], None]
        edge_y += [pa[1], pb[1], None]
        if dim == 3:
            edge_z += [pa[2], pb[2], None]
    node_x, node_y, node_z, node_c, node_t = [], [], [], [], []
    for tid in nodes:
        p = _p(tid)
        node_x.append(p[0])
        node_y.append(p[1])
        if dim == 3:
            node_z.append(p[2])
        t = tn.tensor_map[tid]
        c = "#999999"
        for tag, col in tag_colors.items():
            if tag in t.tags:
                c = "rgb({},{},{})".format(
                    *(int(255 * x) for x in col[:3])
                )
                break
        node_c.append(c)
        node_t.append(",".join(map(str, t.tags)))
    if dim == 3:
        traces = [
            go.Scatter3d(x=edge_x, y=edge_y, z=edge_z, mode="lines",
                         line={"color": "#888888"},
                         hoverinfo="none"),
            go.Scatter3d(x=node_x, y=node_y, z=node_z, mode="markers",
                         marker={"color": node_c, "size": 6},
                         text=node_t, hoverinfo="text"),
        ]
    else:
        traces = [
            go.Scatter(x=edge_x, y=edge_y, mode="lines",
                       line={"color": "#888888"}, hoverinfo="none"),
            go.Scatter(x=node_x, y=node_y, mode="markers",
                       marker={"color": node_c, "size": 10},
                       text=node_t, hoverinfo="text"),
        ]
    fig = go.Figure(data=traces)
    fig.update_layout(showlegend=False)
    return fig


# --------------------------------------------------------------------------
# array-entry visualization (reference visualize_tensor, used by
# Tensor.visualize)
# --------------------------------------------------------------------------


def visualize_tensor(t, max_projections=None, ax=None, figsize=(5, 5),
                     size_map=True, size_pow=0.5, scale=1.0,
                     return_fig=False):
    """Visualize all entries of a tensor as a 2D scatter: position by
    (fused row, fused col) bit-interleaving, marker size by magnitude,
    hue by complex phase (reference ``visualize_tensor``
    drawing.py)."""
    import matplotlib.pyplot as plt

    data = to_host(getattr(t, "data", t))
    # fuse axes alternately into rows/cols for a square-ish scatter
    shape = data.shape or (1,)
    row_axes = shape[0::2]
    col_axes = shape[1::2]
    nrow = int(np.prod(row_axes)) if row_axes else 1
    ncol = int(np.prod(col_axes)) if col_axes else 1
    perm = list(range(0, len(shape), 2)) + list(range(1, len(shape), 2))
    mat = np.transpose(data, perm).reshape(nrow, ncol) \
        if len(shape) > 1 else data.reshape(1, -1)

    created = ax is None
    if created:
        fig, ax = plt.subplots(figsize=figsize)
    else:
        fig = ax.figure
    ax.set_aspect("equal")
    ax.invert_yaxis()
    ax.axis("off")

    mags = np.abs(mat)
    mmax = mags.max() if mags.size else 1.0
    if mmax == 0:
        mmax = 1.0
    rr, cc = np.nonzero(mags > 1e-12 * mmax)
    sizes = scale * 200 * (mags[rr, cc] / mmax) ** size_pow \
        if size_map else scale * 50
    if np.iscomplexobj(mat):
        phases = np.angle(mat[rr, cc]) / (2 * np.pi) % 1.0
        colors = [colorsys.hsv_to_rgb(p, 0.8, 0.85) for p in phases]
    else:
        colors = [
            (0.8, 0.25, 0.2) if v < 0 else (0.2, 0.4, 0.75)
            for v in mat[rr, cc].real
        ]
    ax.scatter(cc, rr, s=sizes, c=colors, marker="o")
    ax.set_xlim(-1, ncol)
    ax.set_ylim(nrow, -1)
    if return_fig:
        return fig
    if created:
        plt.close(fig)
    return ax


def choose_squarest_grid(n):
    """(rows, cols) of the most square grid holding ``n`` panels
    (reference ``choose_squarest_grid`` drawing.py:1633)."""
    m = max(1, int(round(math.sqrt(n))))
    k = math.ceil(n / m)
    return m, k


def visualize_tensors(tn, mode="network", r=None, r_scale=1.0,
                      figsize=None, return_fig=False,
                      **visualize_opts):
    """Visualize the entries of every tensor in the network (reference
    ``visualize_tensors`` drawing.py:1644).

    Parameters
    ----------
    mode : {'network', 'grid', 'row', 'col'}
        'network' places each tensor's entry-scatter at the position
        the graph layout gives it; the others tile the scatters.
    r : float, optional
        Panel radius for ``mode='network'`` (fraction of the figure).
    """
    import matplotlib.pyplot as plt

    n = tn.num_tensors
    if figsize is None:
        s = 2 * max(1.0, n**0.4)
        figsize = (s, s)
    fig = plt.figure(figsize=figsize)

    if mode == "network":
        if r is None:
            r = 1.0 / max(1.0, n**0.5)
        r *= r_scale
        pos = layout_positions(tn)
        pts = np.asarray([
            pos[tid][:2] for tid in tn.tensor_map if tid in pos
        ])
        lo = pts.min(axis=0) if len(pts) else np.zeros(2)
        span = (pts.max(axis=0) - lo) if len(pts) else np.ones(2)
        span[span == 0] = 1.0
        for tid, t in tn.tensor_map.items():
            if tid not in pos:
                continue
            x, y = (np.asarray(pos[tid][:2]) - lo) / span
            # map into [0, 1-r] so panels stay inside the figure
            ax = fig.add_axes((
                x * (1 - r), y * (1 - r), r, r
            ))
            visualize_tensor(t, ax=ax, **visualize_opts)
    else:
        if mode == "grid":
            nr, nc = choose_squarest_grid(n)
        elif mode == "row":
            nr, nc = 1, n
        elif mode == "col":
            nr, nc = n, 1
        else:
            raise ValueError(f"unknown mode {mode!r}")
        for i, t in enumerate(tn.tensor_map.values()):
            ax = fig.add_subplot(nr, nc, i + 1)
            visualize_tensor(t, ax=ax, **visualize_opts)

    if return_fig:
        return fig
    plt.close(fig)
    return fig


__all__ = [
    "choose_squarest_grid",
    "draw_tn",
    "get_colors",
    "hash_to_color",
    "layout_positions",
    "visualize_tensor",
    "visualize_tensors",
]
