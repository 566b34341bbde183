"""quimb_torch's drawing code (``tensor/drawing.py``, ``schematic.py``,
``utils_plot.py``) against quimb_tpu's, on matplotlib's Agg backend: the
layouts of every kind (2D and 3D, fixed nodes, the one-tensor circle),
the colour helpers and the schematic's colour and projection helpers equal
to quimb_tpu's at 1e-12; the artists that ``draw_tn``,
``visualize_tensor(s)`` and the schematic primitives add, counted against
quimb_tpu's on the same networks; and the plotly route, which raises the
same ``ImportError`` in both packages (plotly is not installed)."""

import matplotlib

matplotlib.use("Agg")

import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import quimb_tpu.schematic as jsch  # noqa: E402
import quimb_tpu.tensor as jtn  # noqa: E402
import quimb_tpu.tensor.drawing as jdr  # noqa: E402
import quimb_tpu.utils_plot as jplot  # noqa: E402
import quimb_torch.schematic as tsch  # noqa: E402
import quimb_torch.tensor.drawing as tdr  # noqa: E402
import quimb_torch.utils_plot as tplot  # noqa: E402
from quimb_torch import convert  # noqa: E402

CPU = "cpu"
TOL = 1e-12


@pytest.fixture(autouse=True)
def _close_figures():
    yield
    plt.close("all")


def _mps_pair(L=6, D=3, seed=0, cplx=False):
    rng = np.random.default_rng(seed)
    arrays = []
    for i in range(L):
        sh = [D] * ((i > 0) + (i < L - 1)) + [2]
        a = rng.standard_normal(sh)
        arrays.append(a + 1j * rng.standard_normal(sh) if cplx else a)
    j = jtn.MatrixProductState(arrays, shape="lrp")
    return j, convert.from_tpu_mps(j, device=CPU)


def _hyper_pair():
    rng = np.random.default_rng(3)
    arrs = [rng.standard_normal((2, 2)) for _ in range(3)]
    inds = [("h", "a"), ("h", "b"), ("h", "c")]
    j = jtn.TensorNetwork([jtn.Tensor(a, inds=i, tags=(f"T{k}",))
                           for k, (a, i) in enumerate(zip(arrs, inds))])
    t = convert.from_tpu_tensor_network(j, device=CPU)
    return j, t


def _aligned(pos, tn):
    """The positions in one order: the tensors in ``tn``'s order, then
    every other node (index names) sorted."""
    tids = list(tn.tensor_map)
    rest = sorted((k for k in pos if k not in tn.tensor_map), key=str)
    return np.array([np.asarray(pos[k], dtype=float) for k in tids + rest])


LAYOUTS = [("spring", 2, None), ("spring", 3, None), ("spectral", 2, None),
           ("circular", 2, None), ("random", 2, None),
           ("kamada_kawai", 2, None), ("spring", 2, "spectral"),
           ("spring", 2, "circular")]


@pytest.mark.parametrize("layout,dim,init", LAYOUTS)
def test_layout_positions_match(layout, dim, init):
    j, t = _mps_pair()
    pj = jdr.layout_positions(j, layout=layout, dim=dim, initial_layout=init,
                              seed=5)
    pt = tdr.layout_positions(t, layout=layout, dim=dim, initial_layout=init,
                              seed=5)
    assert len(pt) == len(pj) == 12
    np.testing.assert_allclose(_aligned(pt, t), _aligned(pj, j), atol=TOL)


def test_fixed_single_tensor_and_hyper_layouts_match():
    j, t = _mps_pair()
    tid_j, tid_t = next(iter(j.tensor_map)), next(iter(t.tensor_map))
    pj = jdr.layout_positions(j, fix={tid_j: (0.0, 0.0)})
    pt = tdr.layout_positions(t, fix={tid_t: (0.0, 0.0)})
    np.testing.assert_allclose(_aligned(pt, t), _aligned(pj, j), atol=TOL)
    assert np.allclose(pt[tid_t], 0.0, atol=1e-8)
    one_j = jtn.TensorNetwork([j.tensors[2]])
    one_t = convert.from_tpu_tensor_network(one_j, device=CPU)
    for dim in (2, 3):
        a = tdr.layout_positions(one_t, dim=dim)
        b = jdr.layout_positions(one_j, dim=dim)
        np.testing.assert_allclose(_aligned(a, one_t), _aligned(b, one_j),
                                   atol=TOL)
    hj, ht = _hyper_pair()
    np.testing.assert_allclose(_aligned(tdr.layout_positions(ht), ht),
                               _aligned(jdr.layout_positions(hj), hj),
                               atol=TOL)
    np.testing.assert_allclose(tdr.phyllotaxis_points(9),
                               jdr.phyllotaxis_points(9), atol=TOL)
    pos = {k: np.asarray(v, float) for k, v in
           jdr.layout_positions(j).items()}
    a = tdr.massage_pos(dict(pos), nangles=36)
    b = jdr.massage_pos(dict(pos), nangles=36)
    np.testing.assert_allclose(np.array([a[k] for k in sorted(a, key=str)]),
                               np.array([b[k] for k in sorted(b, key=str)]),
                               atol=TOL)


def test_colour_helpers_match():
    for s in ("I0", "KET", "a longer tag", ""):
        np.testing.assert_allclose(tdr.hash_to_color(s),
                                   jdr.hash_to_color(s), atol=TOL)
        np.testing.assert_allclose(tsch.hash_to_color(s),
                                   jsch.hash_to_color(s), atol=TOL)
        assert tsch.hash_to_nvalues(s, 5) == jsch.hash_to_nvalues(s, 5)
    for tags, custom in ((("A", "B"), None), (tuple(f"T{i}" for i in
                                                    range(20)), None),
                         (("A",), [(1, 0, 0)])):
        a, b = tdr.get_colors(tags, custom), jdr.get_colors(tags, custom)
        assert list(a) == list(b)
        np.testing.assert_allclose(np.array(list(a.values()), float),
                                   np.array(list(b.values()), float),
                                   atol=TOL)
    for x in (0.0, 0.3, 1.7):
        np.testing.assert_allclose(tsch.get_color(x, vmax=2.0),
                                   jsch.get_color(x, vmax=2.0), atol=TOL)
    np.testing.assert_allclose(tsch.auto_colors(7), jsch.auto_colors(7),
                               atol=TOL)
    for fn, arg in ((lambda m, c: m.darken_color(c), (0.6, 0.6, 0.9)),
                    (lambda m, c: m.average_color([c, (0, 0, 1)]),
                     (1, 0, 0)),
                    (lambda m, c: m.mod_sat(c, mod=0.5), (0.2, 0.4, 0.9,
                                                          0.7))):
        np.testing.assert_allclose(fn(tsch, arg), fn(jsch, arg), atol=TOL)
    # a random perturbation (numpy's global generator) in both
    assert np.allclose(tsch.jitter_color((0.5, 0.5, 0.5), 0.01), 0.5,
                       atol=0.05)
    for seed in (1, 0):
        tsch.set_coloring_seed(seed)
        jsch.set_coloring_seed(seed)
        assert tsch.hash_to_color("tag") == jsch.hash_to_color("tag")


def test_projection_helpers_match():
    for xyz in ((1.0, 2.0, 3.0), (-0.5, 0.25, 0.0)):
        for fn in ("orthographic_project", "axonometric_project",
                   "coo_to_zorder"):
            np.testing.assert_allclose(getattr(tsch, fn)(*xyz),
                                       getattr(jsch, fn)(*xyz), atol=TOL)
    for n in range(1, 30):
        assert tdr.choose_squarest_grid(n) == jdr.choose_squarest_grid(n)


def _counts(ax):
    return (len(ax.lines), len(ax.collections), len(ax.patches),
            sorted(x.get_text() for x in ax.texts))


@pytest.mark.parametrize("opts", [
    {}, {"dim": 3}, {"show_inds": "all", "highlight_inds": ("k0",)},
    {"color": ["I0", "I1", "I2"], "legend": True, "title": "mps"},
    {"isdark": True, "margin": 0.2, "node_hatch": "//"}])
def test_draw_tn_artist_counts_match(opts):
    j, t = _mps_pair()
    ft = tdr.draw_tn(t, get="fig", **opts)
    fj = jdr.draw_tn(j, get="fig", **opts)
    assert [_counts(a) for a in ft.axes] == [_counts(a) for a in fj.axes]
    assert ft.axes[0].lines or ft.axes[0].collections
    pos_t = tdr.draw_tn(t, get="pos")
    assert _aligned(pos_t, t).shape == (12, 2)
    assert tdr.draw_tn(t, get="ax") is not None


def test_draw_hyper_and_isometries_match():
    hj, ht = _hyper_pair()
    a, b = tdr.draw_tn(ht, get="fig"), jdr.draw_tn(hj, get="fig")
    assert _counts(a.axes[0]) == _counts(b.axes[0])
    # isometric tensors draw an arrow from their left indices
    j, t = _mps_pair(L=4)
    tc = t.copy()
    tc.left_canonize()
    jc = j.copy()
    jc.left_canonize()
    a, b = tc.draw(get="fig"), jc.draw(get="fig")
    assert _counts(a.axes[0]) == _counts(b.axes[0])


@pytest.mark.parametrize("cplx", [False, True])
def test_visualize_tensor_scatters_match(cplx):
    j, t = _mps_pair(L=4, cplx=cplx)
    at = tdr.visualize_tensor(t.tensors[1])
    aj = jdr.visualize_tensor(j.tensors[1])
    (ct,), (cj,) = at.collections, aj.collections
    np.testing.assert_allclose(ct.get_offsets(), cj.get_offsets(), atol=TOL)
    np.testing.assert_allclose(ct.get_sizes(), cj.get_sizes(), rtol=TOL)
    np.testing.assert_allclose(ct.get_facecolors(), cj.get_facecolors(),
                               atol=TOL)


@pytest.mark.parametrize("mode", ["network", "grid", "row", "col"])
def test_visualize_tensors_match(mode):
    j, t = _mps_pair()
    ft = tdr.visualize_tensors(t, mode=mode, return_fig=True)
    fj = jdr.visualize_tensors(j, mode=mode, return_fig=True)
    assert len(ft.axes) == len(fj.axes) == 6
    np.testing.assert_allclose(
        np.array([a.get_position().bounds for a in ft.axes]),
        np.array([a.get_position().bounds for a in fj.axes]), atol=TOL)
    assert [len(a.collections) for a in ft.axes] == \
        [len(a.collections) for a in fj.axes]
    with pytest.raises(ValueError):
        tdr.visualize_tensors(t, mode="diagonal")


def test_plotly_route_raises_the_same_import_error():
    j, t = _mps_pair(L=3)
    errs = []
    for fn, tn in ((tdr.draw_tn, t), (jdr.draw_tn, j),
                   (lambda tn, **kw: tn.draw_interactive(), t)):
        with pytest.raises(ImportError) as info:
            fn(tn, backend="plotly")
        errs.append(str(info.value))
    assert errs[0] == errs[1] == errs[2]


def _schematic(sch):
    d = sch.Drawing(presets={"site": {"color": "#cc6644"}})
    d.circle((0, 0), label="A")
    d.circle((0, 1), preset="site")
    d.square((1, 0))
    d.ellipse((2, 0), width=0.6, height=0.3)
    d.rectangle((3, -0.5), (4, 0.5), radius=0.1)
    d.shape([(5, 0), (5.5, 0.5), (6, 0)])
    d.line((0, 1), (1, 1))
    d.line_offset((1, 1), (2, 1), offset=0.3)
    d.curve([(2, 1), (2.5, 1.4), (3, 1)])
    d.curve_arc((4, 1), radius=0.3)
    d.arrow((5, 1), (6, 1))
    d.marker((6.5, 1))
    d.dot((7, 1))
    d.text((3, 2), "hello")
    d.label_ax(0.05, 0.95, "corner")
    d.patch_around([(0, 3), (1, 3), (0.5, 3.8)])
    d.cube((0, 0, 0), fill=True)
    d.wedge((0, 0), 0, 120)
    d.regular_polygon((1, 0), n=6)
    d.star((2, 0))
    d.cross((3, 0))
    d.zigzag((0, 1), (2, 1))
    d.arrowhead((0, 2), (1, 2))
    d.bezier((0, 3), (0.4, 3.6), (0.8, 2.4), (1.2, 3))
    d.cup((2, 3), (3, 3), depth=0.4)
    d.patch([(0, 4), (1, 4), (0.5, 4.8)])
    d.patch_around_circles((3, 4), 0.3, (4.5, 4), 0.4)
    d.text_between((0, 5), (2, 5.5), "bond")
    d.text_toward((0, 6), (2, 6), "near-a", frac=0.2)
    d.grid((0, 0), (2, 2))
    d.grid3d()
    return d


def test_schematic_primitives_match():
    dt, dj = _schematic(tsch), _schematic(jsch)
    assert _counts(dt.ax) == _counts(dj.ax)
    np.testing.assert_allclose(
        np.concatenate([ln.get_xydata().ravel() for ln in dt.ax.lines]),
        np.concatenate([ln.get_xydata().ravel() for ln in dj.ax.lines]),
        atol=TOL)
    assert dt._coo((1.0, 2.0, 3.0)) == pytest.approx(
        dj._coo((1.0, 2.0, 3.0)), abs=TOL)
    assert dt.translate(dx=1, dy=2, dz=3)((0, 0, 0)) == (1, 2, 3)


def test_plot_helpers_match():
    data = {"a": [3.0, 2.0, 1.5, 1.2, 1.1], "b": [1.0, 0.5, 0.25, 0.1, 0.05]}
    (ft, at), (fj, aj) = (tplot.plot_multi_series_zoom(data),
                          jplot.plot_multi_series_zoom(data))
    assert [list(ln.get_ydata()) for ln in at.lines] == \
        [list(ln.get_ydata()) for ln in aj.lines]
    assert len(ft.axes) == len(fj.axes)
    assert len(at.child_axes) == len(aj.child_axes) == 1
    ft2, at2 = tplot.plot([1.0, 0.5, 0.2])
    assert list(at2.lines[0].get_ydata()) == [1.0, 0.5, 0.2]
    assert tplot.NEUTRAL_STYLE == jplot.NEUTRAL_STYLE
    import quimb_torch

    assert quimb_torch.plot is tplot.plot
    assert torch.is_tensor(torch.zeros(1))
