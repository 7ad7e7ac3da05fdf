"""Matplotlib visualization helpers (copy of lightglue_tpu/utils/viz.py):
capability parity with the reference's viz2d.py
(lightglue_pytorch_with_plugin/viz2d.py: plot_images, plot_keypoints,
plot_matches, red-green confidence colormap), written around numpy arrays;
pass tensors as ``t.cpu().numpy()``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


def cm_RdGn(x) -> np.ndarray:
    """Confidence ramp red (0) -> yellow (0.5) -> green (1).

    Matches the reference's rendering (viz2d.py:14-18): both channels
    saturate at the midpoint, so mid confidences read yellow — a plain
    red/green lerp would render them muddy brown and the saved match
    images would not look like the reference's."""
    t = 2.0 * np.clip(np.asarray(x, np.float32), 0, 1)[..., None]
    r = np.clip(2.0 - t, 0, 1)
    g = np.clip(t, 0, 1)
    return np.concatenate([r, g, np.zeros_like(r)], axis=-1)


def cm_BlRdGn(x) -> np.ndarray:
    """Diverging RGBA ramp blue (-1) -> red (0) -> green (+1), saturating
    like cm_RdGn on each side (reference viz2d.py:22-29: positives pass
    through yellow, negatives through magenta-ish red/blue mixes)."""
    x = np.asarray(x, np.float32)
    tp = 2.0 * np.clip(x, 0, 1)[..., None]
    up = tp * np.array([0.0, 1.0, 0.0, 1.0], np.float32) + (
        2.0 - tp
    ) * np.array([1.0, 0.0, 0.0, 1.0], np.float32)
    tn = 2.0 * np.clip(-x, 0, 1)[..., None]
    down = tn * np.array([0.0, 0.1, 1.0, 1.0], np.float32) + (
        2.0 - tn
    ) * np.array([1.0, 0.0, 0.0, 1.0], np.float32)
    return np.clip(np.where(x[..., None] < 0, down, up), 0, 1)


def cm_prune(x, n_layers: int = 9) -> np.ndarray:
    """Colormap for keypoint pruning state (viz2d.py:31-35 analog):
    tokens surviving to the last observed layer show blue, earlier-pruned
    tokens shade red (pruned at layer 1) to green (pruned late)."""
    x = np.asarray(x, np.float32)
    latest = x.max() if x.size else 1.0
    normed = np.where(x == latest, -1.0, (x - 1) / max(n_layers, 1))
    return cm_BlRdGn(normed)


def add_text(
    ax,
    text: str,
    pos=(0.01, 0.99),
    fs: float = 15,
    color="w",
    lcolor="k",
    lwidth: float = 2,
):
    """Outlined annotation in axes coordinates (viz2d.py:100-108 analog:
    white text with a black stroke so it reads on any image)."""
    import matplotlib.patheffects as path_effects

    t = ax.text(
        *pos, text, fontsize=fs, ha="left", va="top",
        color=color, transform=ax.transAxes,
    )
    if lcolor is not None:
        t.set_path_effects(
            [
                path_effects.Stroke(linewidth=lwidth, foreground=lcolor),
                path_effects.Normal(),
            ]
        )
    return t


def plot_pruning(axes, kpts_list, prune_layers, n_layers: int = 9, ps=6.0):
    """Visualize adaptive width pruning: scatter keypoints colored by the
    layer each was pruned at (see models.lightglue.forward_adaptive) —
    surviving keypoints blue, early-pruned red, late-pruned green.

    ``prune_layers``: per-image arrays of the 1-based layer index at which
    each keypoint was dropped (use the exit layer for survivors).
    """
    for ax, kpts, layers in zip(axes, kpts_list, prune_layers):
        kpts = np.asarray(kpts)
        colors = cm_prune(np.asarray(layers, np.float32), n_layers)
        ax.scatter(kpts[:, 0], kpts[:, 1], c=colors, s=ps, linewidths=0)


def plot_images(
    images: Sequence[np.ndarray],
    titles: Optional[Sequence[str]] = None,
    dpi: int = 100,
):
    """Side-by-side image grid; returns (fig, axes)."""
    import matplotlib.pyplot as plt

    n = len(images)
    ratios = [im.shape[1] / im.shape[0] for im in images]
    fig, axes = plt.subplots(
        1, n, figsize=(sum(ratios) * 4.5, 4.5), dpi=dpi,
        gridspec_kw={"width_ratios": ratios},
    )
    if n == 1:
        axes = [axes]
    for ax, im in zip(axes, images):
        if im.ndim == 3 and im.shape[-1] == 1:
            im = im[..., 0]
        ax.imshow(im, cmap="gray" if im.ndim == 2 else None)
        ax.set_axis_off()
    if titles:
        for ax, t in zip(axes, titles):
            ax.set_title(t)
    fig.tight_layout(pad=0.5)
    return fig, axes


def plot_keypoints(axes, kpts_list, colors="lime", ps: float = 4.0):
    """Scatter keypoints onto existing axes."""
    if isinstance(colors, str):
        colors = [colors] * len(kpts_list)
    for ax, kpts, c in zip(axes, kpts_list, colors):
        kpts = np.asarray(kpts)
        ax.scatter(kpts[:, 0], kpts[:, 1], c=c, s=ps, linewidths=0)


def plot_matches(
    axes,
    kpts0: np.ndarray,
    kpts1: np.ndarray,
    color=None,
    scores: Optional[np.ndarray] = None,
    lw: float = 0.6,
):
    """Draw match lines between the first two axes (viz2d.py analog)."""
    import matplotlib.patches as mpl_patches

    ax0, ax1 = axes[0], axes[1]
    fig = ax0.figure
    kpts0 = np.asarray(kpts0)
    kpts1 = np.asarray(kpts1)
    if color is None:
        color = cm_RdGn(scores) if scores is not None else [(0.1, 0.8, 0.2)] * len(kpts0)
    for (x0, y0), (x1, y1), c in zip(kpts0, kpts1, color):
        patch = mpl_patches.ConnectionPatch(
            xyA=(x0, y0), coordsA=ax0.transData,
            xyB=(x1, y1), coordsB=ax1.transData,
            color=tuple(np.asarray(c).tolist()), linewidth=lw,
        )
        fig.add_artist(patch)


def save_plot(fig, path: str) -> None:
    fig.savefig(path, bbox_inches="tight", pad_inches=0)
    import matplotlib.pyplot as plt

    plt.close(fig)
