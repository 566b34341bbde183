"""Neutral-style matplotlib helpers (reference ``quimb/utils_plot.py``:
``plot_multi_series_zoom``)."""

from .utils import default_to_neutral_style

# the neutral matplotlib style dict (reference quimb/utils_plot.py:5)
NEUTRAL_STYLE = {
    "axes.edgecolor": (0.5, 0.5, 0.5),
    "axes.facecolor": (0, 0, 0, 0),
    "axes.grid": True,
    "axes.labelcolor": (0.5, 0.5, 0.5),
    "axes.spines.right": False,
    "axes.spines.top": False,
    "figure.facecolor": (0, 0, 0, 0),
    "grid.alpha": 0.1,
    "grid.color": (0.5, 0.5, 0.5),
    "legend.frameon": False,
    "text.color": (0.5, 0.5, 0.5),
    "xtick.color": (0.5, 0.5, 0.5),
    "xtick.minor.visible": True,
    "ytick.color": (0.5, 0.5, 0.5),
    "ytick.minor.visible": True,
}


@default_to_neutral_style
def plot_multi_series_zoom(
    data, zoom="auto", zoom_max=100, figsize=(8, 5), **kwargs
):
    """Plot possibly multiple series with an inset zoom of the tail
    (used e.g. for optimization/convergence histories)."""
    import matplotlib.pyplot as plt

    if isinstance(data, dict):
        series = data
    elif isinstance(data, (list, tuple)) and data and not hasattr(
        data[0], "__len__"
    ):
        series = {"series": data}
    else:
        series = {f"s{i}": s for i, s in enumerate(data)}

    fig, ax = plt.subplots(figsize=figsize)
    for label, ys in series.items():
        ax.plot(ys, label=label, **kwargs)
    n = max(len(ys) for ys in series.values())
    if zoom is not None:
        if zoom == "auto":
            zoom = min(zoom_max, n // 2) or 1
        axins = ax.inset_axes([0.5, 0.5, 0.45, 0.45])
        for label, ys in series.items():
            axins.plot(range(len(ys) - zoom, len(ys)), ys[-zoom:])
    if len(series) > 1:
        ax.legend()
    return fig, ax


def plot(*args, **kwargs):
    """Generic neutral-style plot helper (alias of
    ``plot_multi_series_zoom`` — the reference's top-level ``plot``
    export)."""
    return plot_multi_series_zoom(*args, **kwargs)


__all__ = ["plot_multi_series_zoom", "NEUTRAL_STYLE",
           "default_to_neutral_style", "plot"]
