"""Verbatim copy of `pyqg_generative_tpu/utils/plot.py` (numpy only), kept
here so that the PyTorch port never imports the JAX package.

Presentation helpers (reference tools/plot_helpers.py).

matplotlib-based; cmocean is not available here so a diverging balance-like
colormap is substituted."""
from __future__ import annotations

import numpy as np

__all__ = ["default_rcParams", "imshow", "create_animation", "set_letters",
           "latex_float", "outliers"]


def outliers(x: np.ndarray, k: int = 2, iters: int = 50, seed: int = 0):
    """1-D k-means outlier flagging (reference plot_helpers.py `outliers`):
    cluster the values into k groups and mark members of the smallest-count
    cluster as outliers. Returns a boolean mask."""
    x = np.asarray(x, dtype=float).ravel()
    rng = np.random.default_rng(seed)
    centers = rng.choice(x, size=k, replace=False)
    for _ in range(iters):
        d = np.abs(x[:, None] - centers[None, :])
        assign = d.argmin(axis=1)
        new = np.array([x[assign == j].mean() if (assign == j).any()
                        else centers[j] for j in range(k)])
        if np.allclose(new, centers):
            break
        centers = new
    counts = np.bincount(assign, minlength=k)
    return assign == counts.argmin()


def default_rcParams(kw: dict | None = None):
    import matplotlib
    matplotlib.rcParams.update({
        "font.size": 11, "axes.titlesize": 11, "axes.labelsize": 11,
        "legend.fontsize": 10, "xtick.labelsize": 9, "ytick.labelsize": 9,
        "figure.dpi": 120, "savefig.bbox": "tight",
        **(kw or {})})


def latex_float(f: float) -> str:
    """1.5e-07 -> '1.5 x 10^{-7}' latex string
    (reference plot_helpers.py latex_float)."""
    s = f"{f:.1e}"
    base, exp = s.split("e")
    return rf"${base} \times 10^{{{int(exp)}}}$"


def imshow(arr, ax=None, percentile: float = 99.0, cmap: str = "RdBu_r",
           normalize_rms: bool = True, colorbar: bool = True, **kw):
    """Percentile-clipped, RMS-normalized symmetric field plot
    (reference plot_helpers.py imshow semantics)."""
    import matplotlib.pyplot as plt
    arr = np.asarray(arr)
    if normalize_rms:
        rms = np.sqrt((arr ** 2).mean()) or 1.0
        arr = arr / rms
    vmax = np.percentile(np.abs(arr), percentile)
    if ax is None:
        _, ax = plt.subplots()
    im = ax.imshow(arr, origin="lower", cmap=cmap, vmin=-vmax, vmax=vmax,
                   **kw)
    if colorbar:
        plt.colorbar(im, ax=ax)
    ax.set_xticks([])
    ax.set_yticks([])
    return im


def set_letters(axes, x: float = 0.02, y: float = 0.93, fontsize: int = 11):
    """Label a list of axes (a), (b), ... (reference plot_helpers.py)."""
    import string
    for letter, ax in zip(string.ascii_lowercase, np.ravel(axes)):
        ax.text(x, y, f"({letter})", transform=ax.transAxes,
                fontsize=fontsize, weight="bold")


def create_animation(frames, path: str = "animation.gif", fps: int = 10,
                     **imshow_kw):
    """Render a (time, ny, nx) stack to a GIF (reference plot_helpers.py
    create_animation, matplotlib writer instead of PNG->PIL)."""
    import matplotlib.pyplot as plt
    from matplotlib import animation

    frames = np.asarray(frames)
    fig, ax = plt.subplots()
    im = imshow(frames[0], ax=ax, colorbar=False, **imshow_kw)

    def update(i):
        im.set_data(frames[i])
        return (im,)

    anim = animation.FuncAnimation(fig, update, frames=len(frames),
                                   blit=True)
    anim.save(path, writer=animation.PillowWriter(fps=fps))
    plt.close(fig)
    return path
