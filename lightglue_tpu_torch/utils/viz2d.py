"""2D visualization helpers (counterpart of lightglue_tpu/utils/viz2d.py;
reference lightglue/viz2d.py).

Matplotlib-based: plot image pairs, keypoints, match lines, pruning-depth
colormaps. Every function takes numpy arrays or torch tensors on any
device (copied to the host): images HWC float [0, 1] or HW grayscale.
Only this module imports matplotlib; nothing else of the package imports
this module.
"""

from __future__ import annotations

from typing import List, Optional, Union

import numpy as np
import torch

import matplotlib
import matplotlib.patheffects as path_effects
import matplotlib.pyplot as plt


def _host(x) -> np.ndarray:
    """``x`` as a numpy array; a tensor is copied to the host."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def cm_ranking(sc: np.ndarray, ths=(512, 1024, 2048, 4096)):
    """Rank-based color binning: top-ranked scores red, then yellow/lime/
    cyan/blue past each threshold. (No reference analogue — convenience for
    inspecting detector score orderings.)"""
    ls = _host(sc).shape[0]
    colors = ["red", "yellow", "lime", "cyan", "blue"]
    out = ["gray"] * ls
    for i in range(ls):
        for c, th in zip(colors[: len(ths) + 1], (0,) + tuple(ths)):
            if i >= th:
                out[i] = c
    out = out[::-1]
    return out


def _ramp(t: np.ndarray) -> np.ndarray:
    """Saturating channel ramp: 0 below t=0, linear, 1 above t=0.5."""
    return np.clip(2.0 * t, 0.0, 1.0)


def cm_RdGn(x) -> np.ndarray:
    """Map [0, 1] -> red..yellow..green.

    Same endpoints/midpoint as the reference colormap (viz2d.py:15-19),
    expressed as per-channel saturating ramps: green saturates over the
    lower half of the range, red fades out over the upper half.
    """
    t = np.clip(_host(x).astype(np.float64), 0.0, 1.0)
    return np.stack([_ramp(1.0 - t), _ramp(t), np.zeros_like(t)], axis=-1)


def cm_BlRdGn(x_) -> np.ndarray:
    """Map [-1, 1] -> blue..red..green, RGBA.

    Positive half is ``cm_RdGn``; the negative half fades red into blue
    with a faint green tint (endpoints as reference viz2d.py:22-30).
    """
    t = _host(x_).astype(np.float64)
    tp = np.clip(t, 0.0, 1.0)  # red -> green
    tn = -np.clip(t, -1.0, 0.0)  # red -> blue
    pos = np.stack([_ramp(1.0 - tp), _ramp(tp), np.zeros_like(tp)], axis=-1)
    neg = np.stack([_ramp(1.0 - tn), 0.2 * tn, _ramp(tn)], axis=-1)
    rgb = np.where(t[..., None] < 0, neg, pos)
    return np.concatenate([rgb, np.ones_like(rgb[..., :1])], axis=-1)


def cm_prune(x_) -> np.ndarray:
    """Colors pruning-depth diagnostics (reference viz2d.py cm_prune):
    points pruned early are red, survivors green."""
    x_ = _host(x_).astype(np.float64)
    max_i = max(x_.max(), 1)
    norm_x = np.where(x_ == max_i, -1, (x_ - 1) / 9)
    return cm_BlRdGn(norm_x)


def cm_grad2d(xy) -> np.ndarray:
    """Bilinear 2-D colormap over the unit square (reference viz2d.py:42-53):
    corners are yellow (0,0), green (1,0), red (0,1), blue (1,1)."""
    corners = np.array(
        [
            [1.0, 1.0, 0.0],  # (0,0) yellow
            [0.0, 1.0, 0.0],  # (1,0) green
            [1.0, 0.0, 0.0],  # (0,1) red
            [0.0, 0.0, 1.0],  # (1,1) blue
        ]
    )
    xy = np.clip(_host(xy).astype(np.float64), 0.0, 1.0)
    x, y = xy[..., 0:1], xy[..., 1:2]
    weights = np.concatenate(
        [(1 - x) * (1 - y), x * (1 - y), (1 - x) * y, x * y], axis=-1
    )
    return np.clip(weights @ corners, 0.0, 1.0)


def plot_images(
    imgs: List[np.ndarray],
    titles: Optional[List[str]] = None,
    cmaps: Union[str, List[str]] = "gray",
    dpi: int = 100,
    pad: float = 0.5,
    adaptive: bool = True,
):
    """Plot images side by side (reference viz2d.py:50-79)."""
    imgs = [_host(i) for i in imgs]
    n = len(imgs)
    if not isinstance(cmaps, (list, tuple)):
        cmaps = [cmaps] * n
    ratios = [i.shape[1] / i.shape[0] for i in imgs] if adaptive else [4 / 3] * n
    figsize = [sum(ratios) * 4.5, 4.5]
    fig, axs = plt.subplots(
        1, n, figsize=figsize, dpi=dpi, gridspec_kw={"width_ratios": ratios}
    )
    if n == 1:
        axs = [axs]
    for i, (img, ax) in enumerate(zip(imgs, axs)):
        ax.imshow(img, cmap=plt.get_cmap(cmaps[i]))
        ax.set_axis_off()
        if titles:
            ax.set_title(titles[i])
    fig.tight_layout(pad=pad)
    return fig, axs


def plot_keypoints(kpts, colors="lime", ps: float = 4, axes=None, a: float = 1.0):
    """Plot keypoints onto existing axes (reference viz2d.py:100-116)."""
    if not isinstance(colors, list):
        colors = [colors] * len(kpts)
    if not isinstance(a, list):
        a = [a] * len(kpts)
    if axes is None:
        axes = plt.gcf().axes
    for ax, k, c, alpha in zip(axes, kpts, colors, a):
        k = _host(k)
        ax.scatter(k[:, 0], k[:, 1], c=c, s=ps, linewidths=0, alpha=alpha)


def plot_matches(
    kpts0, kpts1, color=None, lw: float = 1.5, ps: float = 4,
    a: float = 1.0, labels=None, axes=None,
):
    """Plot matches as connection lines between two axes (reference
    viz2d.py:119-166)."""
    fig = plt.gcf()
    if axes is None:
        ax0, ax1 = fig.axes[0], fig.axes[1]
    else:
        ax0, ax1 = axes
    kpts0 = _host(kpts0)
    kpts1 = _host(kpts1)
    assert len(kpts0) == len(kpts1)
    if color is None:
        # Default: 2-D gradient by keypoint position in image 0, so nearby
        # matches share a hue (reference viz2d.py:140-144).
        if len(kpts0):
            lo = kpts0.min(axis=0, keepdims=True)
            span = np.ptp(kpts0, axis=0, keepdims=True)
            color = cm_grad2d(
                (kpts0 - lo) / np.where(span == 0, 1.0, span)
            ).tolist()
        else:
            color = []
    elif len(color) > 0 and not isinstance(color[0], (tuple, list)):
        color = [color] * len(kpts0)
    if lw > 0:
        per_line_labels = [None] * len(kpts0) if labels is None else labels
        for p0, p1, c, lab in zip(kpts0, kpts1, color, per_line_labels):
            patch = matplotlib.patches.ConnectionPatch(
                tuple(p0), tuple(p1),
                coordsA=ax0.transData, coordsB=ax1.transData,
                axesA=ax0, axesB=ax1,
            )
            patch.set(
                color=c, linewidth=lw, alpha=a, zorder=1, clip_on=True,
                label=lab, picker=5.0,
            )
            patch.set_annotation_clip(True)
            fig.add_artist(patch)
    # Freeze the transforms so the endpoint scatter below cannot rescale the
    # axes after the lines were placed (reference viz2d.py:168-170).
    ax0.autoscale(enable=False)
    ax1.autoscale(enable=False)
    if ps > 0:
        ax0.scatter(kpts0[:, 0], kpts0[:, 1], c=color, s=ps)
        ax1.scatter(kpts1[:, 0], kpts1[:, 1], c=color, s=ps)


def add_text(
    idx: int, text: str, pos=(0.01, 0.99), fs: int = 15, color="w",
    lcolor="k", lwidth: int = 2, ha: str = "left", va: str = "top",
):
    """Overlay text on a subplot (reference viz2d.py:169-189)."""
    ax = plt.gcf().axes[idx]
    t = ax.text(
        *pos, text, fontsize=fs, ha=ha, va=va, color=color,
        transform=ax.transAxes,
    )
    if lcolor is not None:
        t.set_path_effects(
            [
                path_effects.Stroke(linewidth=lwidth, foreground=lcolor),
                path_effects.Normal(),
            ]
        )
    return t


def save_plot(path: str, **kw):
    """Save the current figure without borders (reference viz2d.py:192-194)."""
    plt.savefig(path, bbox_inches="tight", pad_inches=0, **kw)
