"""Schematic drawing toolkit (reference ``quimb/schematic.py``,
2599 LoC): an incremental matplotlib helper for hand-drawing tensor
diagrams in 2D or pseudo-3D, used by docs and
``Tensor.draw``-style illustrations.

Supports: circles/ellipses/dots, squares/rectangles/cubes, polygons,
lines/offset (curved) lines/arrows/arcs, text with rotation, markers,
hulls around groups of points (``patch_around``), deterministic
hash-based coloring, and a configurable axonometric 3D->2D
projection (reference ``axonometric_project`` schematic.py).

A copy of quimb_tpu's ``schematic.py``: host code, matplotlib imported
only inside the functions that draw."""

import colorsys
import functools
import hashlib
import math

import numpy as np

# module-level seed mixed into hash-based coloring so whole diagrams
# can be re-rolled deterministically (reference ``set_coloring_seed``)
_COLORING_SEED = 0


def set_coloring_seed(seed):
    """Set the global seed mixed into :func:`hash_to_color` /
    :func:`hash_to_nvalues` (reference ``set_coloring_seed``
    schematic.py:2337)."""
    global _COLORING_SEED
    _COLORING_SEED = int(seed)


def hash_to_nvalues(s, nval, seed=None):
    """Deterministically hash string ``s`` to ``nval`` floats in
    [0, 1) (reference ``hash_to_nvalues`` schematic.py:2349)."""
    if seed is None:
        seed = _COLORING_SEED
    digest = hashlib.sha256(f"{s}+{seed}".encode()).digest()
    # 4 bytes per value, cycling through the digest
    out = []
    for i in range(nval):
        chunk = digest[(4 * i) % 28:(4 * i) % 28 + 4]
        out.append(int.from_bytes(chunk, "big") / 2**32)
    return tuple(out)


def hash_to_color(s, hue_range=(0.0, 1.0), sat=0.5, val=0.85):
    """Deterministic string -> RGB color (reference
    ``hash_to_color`` schematic.py)."""
    (h,) = hash_to_nvalues(s, 1)
    lo, hi = hue_range
    return colorsys.hsv_to_rgb(lo + h * (hi - lo), sat, val)


def get_color(x, cmap="viridis", vmin=0.0, vmax=1.0, alpha=None):
    """Map scalar ``x`` through a named colormap with explicit value
    range (reference ``get_color`` schematic.py:2162)."""
    import matplotlib as mpl

    t = 0.5 if vmax == vmin else (x - vmin) / (vmax - vmin)
    t = min(max(float(t), 0.0), 1.0)
    r, g, b, a = mpl.colormaps[cmap](t)
    if alpha is not None:
        a = alpha
    return (r, g, b, a)


def mod_sat(c, mod=None, alpha=None):
    """Scale the saturation of color ``c`` by ``mod`` (reference
    ``mod_sat`` schematic.py:2222)."""
    import matplotlib.colors as mcolors

    r, g, b, a = mcolors.to_rgba(c)
    h, s, v = colorsys.rgb_to_hsv(r, g, b)
    if mod is not None:
        s = min(max(s * mod, 0.0), 1.0)
    rgb = colorsys.hsv_to_rgb(h, s, v)
    return (*rgb, a if alpha is None else alpha)


def auto_colors(nc, alpha=None):
    """``nc`` visually-distinct colors: evenly spaced hues with
    alternating lightness so neighbors differ in two channels
    (reference ``auto_colors`` schematic.py:2238)."""
    out = []
    for i in range(nc):
        h = i / max(nc, 1)
        v = 0.85 if i % 2 == 0 else 0.65
        rgb = colorsys.hsv_to_rgb(h, 0.55, v)
        out.append(rgb if alpha is None else (*rgb, alpha))
    return out


def darken_color(color, factor=2 / 3):
    """Darken ``color`` by multiplying its value channel (reference
    ``darken_color`` schematic.py:2295)."""
    import matplotlib.colors as mcolors

    r, g, b = mcolors.to_rgb(color)
    return tuple(factor * np.array((r, g, b)))


def average_color(colors):
    """RMS-average a sequence of colors — perceptually better than a
    plain mean (reference ``average_color`` schematic.py:2301)."""
    import matplotlib.colors as mcolors

    rgbs = np.array([mcolors.to_rgb(c) for c in colors])
    return tuple(np.sqrt((rgbs**2).mean(axis=0)))


def jitter_color(color, factor=0.05):
    """Randomly perturb hue/saturation/value of ``color`` by up to
    ``factor`` (reference ``jitter_color`` schematic.py:2319)."""
    import matplotlib.colors as mcolors

    r, g, b = mcolors.to_rgb(color)
    h, s, v = colorsys.rgb_to_hsv(r, g, b)
    dh, ds, dv = (np.random.uniform(-factor, factor) for _ in range(3))
    return colorsys.hsv_to_rgb(
        (h + dh) % 1.0,
        min(max(s + ds, 0.0), 1.0),
        min(max(v + dv, 0.0), 1.0),
    )


def orthographic_project(x, y, z, elev=30.0, azim=-60.0):
    """Project 3D -> 2D with an orthographic camera at elevation/
    azimuth angles in degrees (reference ``orthographic_project``
    schematic.py:2072)."""
    e, a = math.radians(elev), math.radians(azim)
    # rotate about z by azim, then about x by elev; drop depth
    x1 = x * math.cos(a) - y * math.sin(a)
    y1 = x * math.sin(a) + y * math.cos(a)
    return (x1, y1 * math.sin(e) + z * math.cos(e))


def coo_to_zorder(x, y, z, a=50, b=12):
    """Depth key for axonometric drawing: larger = closer to the
    viewer (reference ``coo_to_zorder`` schematic.py:2055)."""
    ar, br = math.radians(a), math.radians(b)
    return -(x * math.cos(ar) + y * math.cos(br)) + 1e-3 * z


def axonometric_project(x, y, z, a=50, b=12):
    """Project 3D -> 2D with an axonometric projection at angles
    ``a`` (degrees, x-axis recede) and ``b`` (y-axis recede)
    (reference ``axonometric_project`` schematic.py)."""
    ar, br = math.radians(a), math.radians(b)
    return (
        x * math.cos(ar) - y * math.cos(br),
        z + x * math.sin(ar) + y * math.sin(br),
    )


class Drawing:
    """An incremental matplotlib figure for diagrams
    (reference ``Drawing`` schematic.py). 3-tuples given as
    coordinates are axonometrically projected with the drawing's
    ``(a, b)`` angle presets."""

    def __init__(self, background=None, drawcolor="#333333",
                 figsize=(6, 6), ax=None, a=50, b=12, presets=None,
                 **kwargs):
        import matplotlib.pyplot as plt

        if ax is None:
            self.fig, self.ax = plt.subplots(figsize=figsize)
        else:
            self.fig, self.ax = ax.figure, ax
        self.ax.set_aspect("equal")
        self.ax.axis("off")
        if background:
            self.fig.patch.set_facecolor(background)
        self.drawcolor = drawcolor
        self.proj_a = a
        self.proj_b = b
        self.presets = dict(presets or {})

    def _parse_preset(self, preset, kwargs):
        """Merge a named style preset (or sequence of them, later ones
        winning) under explicit kwargs (reference preset handling,
        schematic.py): explicit arguments always take precedence."""
        if preset is None:
            return kwargs
        if isinstance(preset, str):
            preset = (preset,)
        merged = {}
        for p in preset:
            merged.update(self.presets[p])
        merged.update(kwargs)
        return merged

    def _coo(self, coo):
        """Project 2D or pseudo-3D coordinates into the plane."""
        coo = tuple(coo)
        if len(coo) == 2:
            return coo
        x, y, z = coo
        return axonometric_project(x, y, z, self.proj_a, self.proj_b)

    def circle(self, coo, radius=0.25, color=None, label=None,
               **kwargs):
        import matplotlib.patches as mpatches

        xy = self._coo(coo)
        c = mpatches.Circle(
            xy, radius, facecolor=color or "#eeeeee",
            edgecolor=self.drawcolor, zorder=3, **kwargs,
        )
        self.ax.add_patch(c)
        if label:
            self.text(coo, label)
        self._autoscale(xy, radius)
        return c

    def dot(self, coo, radius=0.05, color=None, **kwargs):
        return self.circle(coo, radius=radius,
                           color=color or self.drawcolor, **kwargs)

    def square(self, coo, size=0.4, color=None, label=None, **kwargs):
        import matplotlib.patches as mpatches

        x, y = self._coo(coo)
        s = mpatches.Rectangle(
            (x - size / 2, y - size / 2), size, size,
            facecolor=color or "#eeeeee", edgecolor=self.drawcolor,
            zorder=3, **kwargs,
        )
        self.ax.add_patch(s)
        if label:
            self.text(coo, label)
        self._autoscale((x, y), size)
        return s

    def line(self, cooa, coob, color=None, linewidth=1.5, zorder=1,
             **kwargs):
        xa, ya = self._coo(cooa)
        xb, yb = self._coo(coob)
        (ln,) = self.ax.plot(
            [xa, xb], [ya, yb], color=color or self.drawcolor,
            lw=linewidth, zorder=zorder, **kwargs,
        )
        self._autoscale((xa, ya), 0)
        self._autoscale((xb, yb), 0)
        return ln

    def curve(self, coos, color=None, linewidth=1.5, zorder=1,
              **kwargs):
        pts = np.array([self._coo(c) for c in coos])
        (ln,) = self.ax.plot(
            pts[:, 0], pts[:, 1], color=color or self.drawcolor,
            lw=linewidth, zorder=zorder, **kwargs,
        )
        for p in pts:
            self._autoscale(tuple(p), 0)
        return ln

    def arrow(self, cooa, coob, color=None, **kwargs):
        xa, ya = self._coo(cooa)
        xb, yb = self._coo(coob)
        self.ax.annotate(
            "", xy=(xb, yb), xytext=(xa, ya),
            arrowprops={"arrowstyle": "->",
                        "color": color or self.drawcolor},
        )

    def text(self, coo, text, fontsize=10, color=None, **kwargs):
        x, y = self._coo(coo)
        self.ax.text(
            x, y, text, ha="center", va="center", fontsize=fontsize,
            color=color or self.drawcolor, zorder=4, **kwargs,
        )

    def ellipse(self, coo, width=0.5, height=0.3, angle=0.0,
                color=None, label=None, **kwargs):
        """An ellipse patch (reference schematic ellipse shapes)."""
        import matplotlib.patches as mpatches

        xy = self._coo(coo)
        e = mpatches.Ellipse(
            xy, width, height, angle=angle,
            facecolor=color or "#eeeeee", edgecolor=self.drawcolor,
            zorder=3, **kwargs,
        )
        self.ax.add_patch(e)
        if label:
            self.text(coo, label)
        self._autoscale(xy, max(width, height) / 2)
        return e

    def rectangle(self, cooa, coob, color=None, label=None,
                  radius=0.0, **kwargs):
        """A (possibly rounded) rectangle spanning opposite corners
        ``cooa`` -> ``coob`` (reference ``rectangle``
        schematic.py)."""
        import matplotlib.patches as mpatches

        xa, ya = self._coo(cooa)
        xb, yb = self._coo(coob)
        x0, y0 = min(xa, xb), min(ya, yb)
        w, h = abs(xb - xa), abs(yb - ya)
        if radius > 0:
            r = mpatches.FancyBboxPatch(
                (x0, y0), w, h,
                boxstyle=f"round,pad=0,rounding_size={radius}",
                facecolor=color or "#eeeeee",
                edgecolor=self.drawcolor, zorder=2.5, **kwargs,
            )
        else:
            r = mpatches.Rectangle(
                (x0, y0), w, h, facecolor=color or "#eeeeee",
                edgecolor=self.drawcolor, zorder=2.5, **kwargs,
            )
        self.ax.add_patch(r)
        if label:
            self.text(((x0 + w / 2), (y0 + h / 2)), label)
        self._autoscale((x0, y0), 0)
        self._autoscale((x0 + w, y0 + h), 0)
        return r

    def shape(self, coos, color=None, closed=True, zorder=2.5,
              edgecolor=None, **kwargs):
        """An arbitrary filled polygon through ``coos`` (reference
        ``shape`` schematic.py)."""
        import matplotlib.patches as mpatches

        pts = np.array([self._coo(c) for c in coos])
        p = mpatches.Polygon(
            pts, closed=closed, facecolor=color or "#eeeeee",
            edgecolor=(self.drawcolor if edgecolor is None
                       else edgecolor),
            zorder=zorder, **kwargs,
        )
        self.ax.add_patch(p)
        for pt in pts:
            self._autoscale(tuple(pt), 0)
        return p

    polygon = shape

    def line_offset(self, cooa, coob, offset=0.2, color=None,
                    linewidth=1.5, zorder=1, **kwargs):
        """A quadratic-bezier curved line from ``cooa`` to ``coob``
        bowed sideways by ``offset`` (reference ``line_offset``
        schematic.py) — used for parallel multi-bonds."""
        xa, ya = self._coo(cooa)
        xb, yb = self._coo(coob)
        mx, my = (xa + xb) / 2, (ya + yb) / 2
        dx, dy = xb - xa, yb - ya
        nrm = math.hypot(dx, dy) or 1.0
        cx, cy = mx - offset * dy / nrm, my + offset * dx / nrm
        ts = np.linspace(0, 1, 30)
        xs = (1 - ts) ** 2 * xa + 2 * (1 - ts) * ts * cx + ts**2 * xb
        ys = (1 - ts) ** 2 * ya + 2 * (1 - ts) * ts * cy + ts**2 * yb
        (ln,) = self.ax.plot(
            xs, ys, color=color or self.drawcolor, lw=linewidth,
            zorder=zorder, **kwargs,
        )
        self._autoscale((xa, ya), 0)
        self._autoscale((xb, yb), 0)
        return ln

    def curve_arc(self, coo, radius=0.5, theta1=0.0, theta2=90.0,
                  color=None, linewidth=1.5, **kwargs):
        """A circular arc centred at ``coo`` (reference arc
        primitives)."""
        import matplotlib.patches as mpatches

        xy = self._coo(coo)
        arc = mpatches.Arc(
            xy, 2 * radius, 2 * radius, theta1=theta1, theta2=theta2,
            edgecolor=color or self.drawcolor, lw=linewidth,
            zorder=1, **kwargs,
        )
        self.ax.add_patch(arc)
        self._autoscale(xy, radius)
        return arc

    def marker(self, coo, marker="x", color=None, size=60, **kwargs):
        """A single matplotlib marker at ``coo``."""
        x, y = self._coo(coo)
        out = self.ax.scatter(
            [x], [y], marker=marker, c=[color or self.drawcolor],
            s=size, zorder=3.5, **kwargs,
        )
        self._autoscale((x, y), 0.1)
        return out

    def patch_around(self, coos, radius=0.3, color=None, alpha=0.25,
                     **kwargs):
        """A soft convex-hull blob around a set of points (reference
        ``patch_around`` schematic.py — highlights a cluster/region
        of a diagram)."""
        import matplotlib.patches as mpatches

        pts = np.array([self._coo(c) for c in coos], dtype=float)
        center = pts.mean(axis=0)
        # expand each point radially then take the convex hull by angle
        expanded = []
        for p in pts:
            d = p - center
            nrm = np.hypot(*d) or 1.0
            for th in np.linspace(0, 2 * np.pi, 12, endpoint=False):
                expanded.append(
                    p + radius * np.array([np.cos(th), np.sin(th)])
                )
        expanded = np.array(expanded)
        # gift-wrap by angle around the centroid (adequate for blobs)
        c2 = expanded.mean(axis=0)
        angs = np.arctan2(expanded[:, 1] - c2[1],
                          expanded[:, 0] - c2[0])
        rads = np.hypot(expanded[:, 0] - c2[0], expanded[:, 1] - c2[1])
        nbins = 40
        hull = []
        for k in range(nbins):
            m = (angs >= -np.pi + 2 * np.pi * k / nbins) & (
                angs < -np.pi + 2 * np.pi * (k + 1) / nbins
            )
            if m.any():
                j = np.argmax(np.where(m, rads, -np.inf))
                hull.append(expanded[j])
        p = mpatches.Polygon(
            np.array(hull), closed=True,
            facecolor=color or "#8899dd", edgecolor="none",
            alpha=alpha, zorder=0.5, **kwargs,
        )
        self.ax.add_patch(p)
        for pt in pts:
            self._autoscale(tuple(pt), radius)
        return p

    def label_ax(self, x, y, text, fontsize=12, **kwargs):
        """Text in axes-fraction coordinates (reference
        ``label_ax``)."""
        return self.ax.text(
            x, y, text, transform=self.ax.transAxes,
            fontsize=fontsize, color=self.drawcolor, **kwargs,
        )

    def cube(self, coo, size=0.5, color="#dddddd", fill=True,
             **kwargs):
        """A pseudo-3D cube at 3D coordinate ``coo``: filled visible
        faces (top, front, right) shaded by orientation when
        ``fill``, else a wireframe (reference cube schematic)."""
        x, y, z = coo
        h = size / 2
        c000 = (x - h, y - h, z - h)
        c100 = (x + h, y - h, z - h)
        c110 = (x + h, y + h, z - h)
        c010 = (x - h, y + h, z - h)
        c001 = (x - h, y - h, z + h)
        c101 = (x + h, y - h, z + h)
        c111 = (x + h, y + h, z + h)
        c011 = (x - h, y + h, z + h)
        if fill:
            import matplotlib.colors as mcolors

            base = np.array(mcolors.to_rgb(color))
            # top, front, right with decreasing brightness
            for face, shade in (
                ((c001, c101, c111, c011), 1.0),
                ((c000, c100, c101, c001), 0.8),
                ((c100, c110, c111, c101), 0.65),
            ):
                self.shape(face, color=tuple(base * shade), **kwargs)
        else:
            for (p, q) in [
                (c000, c100), (c100, c110), (c110, c010), (c010, c000),
                (c001, c101), (c101, c111), (c111, c011), (c011, c001),
                (c000, c001), (c100, c101), (c110, c111), (c010, c011),
            ]:
                self.line(p, q, color=color, **kwargs)

    def text_between(self, cooa, coob, text, offset=0.12, **kwargs):
        """Text at the midpoint of ``cooa -> coob``, rotated along the
        segment and nudged perpendicular by ``offset`` (reference
        ``text_between`` schematic.py:440)."""
        xa, ya = self._coo(cooa)
        xb, yb = self._coo(coob)
        dx, dy = xb - xa, yb - ya
        nrm = math.hypot(dx, dy) or 1.0
        mx = (xa + xb) / 2 - offset * dy / nrm
        my = (ya + yb) / 2 + offset * dx / nrm
        ang = math.degrees(math.atan2(dy, dx))
        # keep text upright
        if ang > 90:
            ang -= 180
        elif ang < -90:
            ang += 180
        kwargs.setdefault("rotation", ang)
        return self.text((mx, my), text, **kwargs)

    def text_toward(self, cooa, coob, text, frac=0.35, **kwargs):
        """Text placed ``frac`` of the way from ``cooa`` to ``coob``
        (reference label-along-line usage)."""
        xa, ya = self._coo(cooa)
        xb, yb = self._coo(coob)
        return self.text(
            (xa + frac * (xb - xa), ya + frac * (yb - ya)),
            text, **kwargs,
        )

    def label_fig(self, x, y, text, fontsize=12, **kwargs):
        """Text in figure-fraction coordinates (reference
        ``label_fig`` schematic.py:517)."""
        return self.fig.text(
            x, y, text, fontsize=fontsize, color=self.drawcolor,
            **kwargs,
        )

    def wedge(self, coo, theta1=0.0, theta2=90.0, radius=0.4,
              color=None, **kwargs):
        """A filled circular wedge (reference ``wedge``
        schematic.py:598)."""
        import matplotlib.patches as mpatches

        xy = self._coo(coo)
        w = mpatches.Wedge(
            xy, radius, theta1, theta2,
            facecolor=color or "#eeeeee", edgecolor=self.drawcolor,
            zorder=3, **kwargs,
        )
        self.ax.add_patch(w)
        self._autoscale(xy, radius)
        return w

    def regular_polygon(self, coo, n=6, radius=0.3, orientation=0.0,
                        color=None, label=None, **kwargs):
        """A regular ``n``-gon (reference ``regular_polygon``
        schematic.py:650)."""
        x, y = self._coo(coo)
        pts = [
            (
                x + radius * math.cos(orientation + 2 * math.pi * k / n),
                y + radius * math.sin(orientation + 2 * math.pi * k / n),
            )
            for k in range(n)
        ]
        p = self.shape(pts, color=color, **kwargs)
        if label:
            self.text((x, y), label)
        return p

    def star(self, coo, n=5, radius=0.3, inner=0.45, orientation=None,
             color=None, **kwargs):
        """An ``n``-pointed star: alternating outer/inner vertices
        (reference ``star`` schematic.py:680)."""
        x, y = self._coo(coo)
        if orientation is None:
            orientation = math.pi / 2
        pts = []
        for k in range(2 * n):
            r = radius if k % 2 == 0 else radius * inner
            th = orientation + math.pi * k / n
            pts.append((x + r * math.cos(th), y + r * math.sin(th)))
        return self.shape(pts, color=color, **kwargs)

    def cross(self, coo, size=0.15, color=None, linewidth=2.0,
              **kwargs):
        """An x-shaped cross marker drawn as two lines (reference
        ``cross`` schematic.py:699)."""
        x, y = self._coo(coo)
        h = size / 2
        self.line((x - h, y - h), (x + h, y + h), color=color,
                  linewidth=linewidth, zorder=3.5, **kwargs)
        return self.line((x - h, y + h), (x + h, y - h), color=color,
                         linewidth=linewidth, zorder=3.5, **kwargs)

    def zigzag(self, cooa, coob, nzag=6, amplitude=0.1, color=None,
               **kwargs):
        """A zigzag line from ``cooa`` to ``coob`` — e.g. a classical
        wire or a 'broken' bond (reference ``zigzag``
        schematic.py:1013)."""
        xa, ya = self._coo(cooa)
        xb, yb = self._coo(coob)
        dx, dy = xb - xa, yb - ya
        nrm = math.hypot(dx, dy) or 1.0
        px, py = -dy / nrm, dx / nrm
        pts = [(xa, ya)]
        for k in range(1, 2 * nzag):
            t = k / (2 * nzag)
            s = amplitude * (1 if k % 2 else -1)
            pts.append((xa + t * dx + s * px, ya + t * dy + s * py))
        pts.append((xb, yb))
        return self.curve(pts, color=color, **kwargs)

    def arrowhead(self, cooa, coob, t=0.5, width=0.08, length=0.12,
                  color=None, reverse=False, **kwargs):
        """A small triangular arrowhead placed on the ``cooa->coob``
        segment at parameter ``t`` — for marking directed/isometric
        bonds without drawing a full arrow (reference ``arrowhead``
        schematic.py:1090)."""
        xa, ya = self._coo(cooa)
        xb, yb = self._coo(coob)
        dx, dy = xb - xa, yb - ya
        nrm = math.hypot(dx, dy) or 1.0
        ux, uy = dx / nrm, dy / nrm
        if reverse:
            ux, uy = -ux, -uy
        px, py = -uy, ux
        tipx, tipy = xa + t * dx, ya + t * dy
        pts = [
            (tipx, tipy),
            (tipx - length * ux + width * px,
             tipy - length * uy + width * py),
            (tipx - length * ux - width * px,
             tipy - length * uy - width * py),
        ]
        return self.shape(pts, color=color or self.drawcolor,
                          zorder=3.5, **kwargs)

    def bezier(self, cooa, coo_ctrl_a, coo_ctrl_b, coob, color=None,
               linewidth=1.5, zorder=1, n=50, **kwargs):
        """A cubic bezier curve with explicit control points
        (reference ``bezier`` schematic.py:1452)."""
        pa = np.array(self._coo(cooa))
        ca = np.array(self._coo(coo_ctrl_a))
        cb = np.array(self._coo(coo_ctrl_b))
        pb = np.array(self._coo(coob))
        ts = np.linspace(0.0, 1.0, n)[:, None]
        pts = ((1 - ts) ** 3 * pa + 3 * (1 - ts) ** 2 * ts * ca
               + 3 * (1 - ts) * ts**2 * cb + ts**3 * pb)
        (ln,) = self.ax.plot(
            pts[:, 0], pts[:, 1], color=color or self.drawcolor,
            lw=linewidth, zorder=zorder, **kwargs,
        )
        self._autoscale(tuple(pts[0]), 0)
        self._autoscale(tuple(pts[-1]), 0)
        return ln

    def cup(self, cooa, coob, depth=0.5, color=None, **kwargs):
        """A U-shaped bezier connecting two coordinates — e.g. a
        contracted index pair drawn below a row of tensors (reference
        ``cup`` schematic.py:1516)."""
        xa, ya = self._coo(cooa)
        xb, yb = self._coo(coob)
        dx, dy = xb - xa, yb - ya
        nrm = math.hypot(dx, dy) or 1.0
        px, py = dy / nrm, -dx / nrm  # right-hand normal = "down"
        return self.bezier(
            (xa, ya),
            (xa + depth * px, ya + depth * py),
            (xb + depth * px, yb + depth * py),
            (xb, yb),
            color=color, **kwargs,
        )

    def patch(self, coos, color=None, alpha=0.25, smoothing=0.5,
              **kwargs):
        """A smooth closed blob through ``coos``: the polygon's edges
        are replaced by quadratic beziers through edge midpoints
        (reference ``patch`` schematic.py:1328)."""
        import matplotlib.patches as mpatches
        import matplotlib.path as mpath

        pts = [np.array(self._coo(c)) for c in coos]
        n = len(pts)
        mids = [(pts[i] + pts[(i + 1) % n]) / 2 for i in range(n)]
        verts = [mids[-1]]
        codes = [mpath.Path.MOVETO]
        for i in range(n):
            ctrl = pts[i] * smoothing + (
                (mids[i - 1] + mids[i]) / 2
            ) * (1 - smoothing)
            verts.extend([ctrl, mids[i]])
            codes.extend([mpath.Path.CURVE3, mpath.Path.CURVE3])
        p = mpatches.PathPatch(
            mpath.Path(verts, codes),
            facecolor=color or "#8899dd", edgecolor="none",
            alpha=alpha, zorder=0.5, **kwargs,
        )
        self.ax.add_patch(p)
        for pt in pts:
            self._autoscale(tuple(pt), 0.1)
        return p

    def patch_around_circles(self, cooa, ra, coob, rb, color=None,
                             alpha=0.25, padding=0.1, **kwargs):
        """A stadium-shaped hull around two circles (reference
        ``patch_around_circles`` schematic.py:1579)."""
        xa, ya = self._coo(cooa)
        xb, yb = self._coo(coob)
        ra, rb = ra + padding, rb + padding
        dx, dy = xb - xa, yb - ya
        ang = math.atan2(dy, dx)
        pts = []
        # around circle a: angles facing away from b
        for k in range(19):
            th = ang + math.pi / 2 + math.pi * k / 18
            pts.append((xa + ra * math.cos(th), ya + ra * math.sin(th)))
        # around circle b: the opposite sweep
        for k in range(19):
            th = ang - math.pi / 2 + math.pi * k / 18
            pts.append((xb + rb * math.cos(th), yb + rb * math.sin(th)))
        return self.shape(
            pts, color=color or "#8899dd", alpha=alpha,
            edgecolor="none", zorder=0.5, **kwargs,
        )

    def translate(self, dx=0, dy=0, dz=0):
        """Return a helper that shifts 2D/3D coordinates before
        drawing (reference ``translate`` schematic.py:286)."""

        def shift(coo):
            if len(coo) == 2:
                return (coo[0] + dx, coo[1] + dy)
            return (coo[0] + dx, coo[1] + dy, coo[2] + dz)

        return shift

    def savefig(self, fname, dpi=300, bbox_inches="tight"):
        """Save the drawing (reference ``savefig``
        schematic.py:1959)."""
        self.fig.savefig(fname, dpi=dpi, bbox_inches=bbox_inches)

    def _autoscale(self, xy, pad):
        self.ax.update_datalim(
            [(xy[0] - pad, xy[1] - pad), (xy[0] + pad, xy[1] + pad)]
        )
        self.ax.autoscale_view()

    def grid(self, cooa, coob, nx=4, ny=4, color=None, linewidth=1.0,
             **kwargs):
        """A 2D grid of lines spanning the rectangle ``cooa``–``coob``
        (reference ``grid`` schematic.py:1659)."""
        xa, ya = self._coo(cooa)
        xb, yb = self._coo(coob)
        out = []
        for i in range(nx + 1):
            x = xa + (xb - xa) * i / nx
            out.append(self.line((x, ya), (x, yb), color=color,
                                 linewidth=linewidth, **kwargs))
        for j in range(ny + 1):
            y = ya + (yb - ya) * j / ny
            out.append(self.line((xa, y), (xb, y), color=color,
                                 linewidth=linewidth, **kwargs))
        return out

    def grid3d(self, coo0=(0, 0, 0), size=1.0, n=2, color=None,
               linewidth=1.0, **kwargs):
        """A pseudo-3D cubic wireframe grid: n+1 lines per axis pair,
        axonometrically projected (reference ``grid3d``
        schematic.py:1746)."""
        x0, y0, z0 = coo0
        s = size
        out = []
        rng = [x0 + s * i / n for i in range(n + 1)]
        for u in rng:
            for v in rng:
                out.append(self.line((u, v, z0), (u, v, z0 + s),
                                     color=color,
                                     linewidth=linewidth, **kwargs))
                out.append(self.line((u, y0, v), (u, y0 + s, v),
                                     color=color,
                                     linewidth=linewidth, **kwargs))
                out.append(self.line((x0, u, v), (x0 + s, u, v),
                                     color=color,
                                     linewidth=linewidth, **kwargs))
        return out


def _add_preset_support(cls):
    """Give every public drawing method a ``preset=`` keyword that
    merges named style dicts (``Drawing(presets={...})``) under the
    explicit kwargs — the reference's preset system (schematic.py)."""
    skip = {"savefig", "translate"}
    for name, fn in list(vars(cls).items()):
        if (name.startswith("_") or not callable(fn) or name in skip):
            continue

        def _make(fn):
            @functools.wraps(fn)
            def wrapper(self, *args, preset=None, **kwargs):
                return fn(self, *args,
                          **self._parse_preset(preset, kwargs))

            return wrapper

        setattr(cls, name, _make(fn))
    return cls


_add_preset_support(Drawing)


__all__ = [
    "Drawing",
    "auto_colors",
    "average_color",
    "axonometric_project",
    "coo_to_zorder",
    "darken_color",
    "get_color",
    "hash_to_color",
    "hash_to_nvalues",
    "jitter_color",
    "mod_sat",
    "orthographic_project",
    "set_coloring_seed",
]
