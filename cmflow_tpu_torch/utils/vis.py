"""BEV visualization (utils/vis_util.py + utils/vis_ops.py equivalents).

Counterpart of ``cmflow_tpu/utils/vis.py``.  Host-side numpy and
matplotlib (imported when a figure is drawn): flow-colorwheel scatter of the
predicted scene flow and moving/static segmentation scatter, on the radar's
bird's-eye-view grid (range rings every 10 m, bearing spokes every 5 deg).
"""

from __future__ import annotations

import os
import numpy as np

# Middlebury flow color wheel segment lengths (Baker et al., ICCV'07) —
# same palette the reference uses (utils/vis_ops.py:3-50).
_SEGMENTS = (("RY", 15), ("YG", 6), ("GC", 4), ("CB", 11), ("BM", 13),
             ("MR", 6))


def make_colorwheel() -> np.ndarray:
    """[55, 3] RGB color wheel."""
    ncols = sum(n for _, n in _SEGMENTS)
    wheel = np.zeros((ncols, 3))
    col = 0
    ramps = {
        "RY": (0, None, 1), "YG": (0, 0, None), "GC": (1, None, 2),
        "CB": (1, 1, None), "BM": (2, None, 0), "MR": (2, 2, None),
    }
    for name, n in _SEGMENTS:
        full, down, up = ramps[name]
        ramp = np.floor(255 * np.arange(n) / n)
        wheel[col:col + n, full] = 255
        if down is not None:
            wheel[col:col + n, down] = 255 - ramp
        if up is not None:
            wheel[col:col + n, up] = ramp
        col += n
    return wheel


def flow_xy_to_colors(u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Map normalized 2-D flow vectors to wheel colors ([N, 3] uint8),
    matching utils/vis_ops.py:54-91 (radius saturates toward white)."""
    wheel = make_colorwheel()
    ncols = wheel.shape[0]
    rad = np.sqrt(u**2 + v**2)
    a = np.arctan2(-v, -u) / np.pi
    fk = (a + 1) / 2 * (ncols - 1)
    k0 = np.floor(fk).astype(np.int32)
    k1 = (k0 + 1) % ncols
    f = fk - k0
    colors = np.zeros((u.shape[0], 3), np.uint8)
    for i in range(3):
        col0 = wheel[k0, i] / 255.0
        col1 = wheel[k1, i] / 255.0
        col = (1 - f) * col0 + f * col1
        in_range = rad <= 1
        col[in_range] = 1 - rad[in_range] * (1 - col[in_range])
        col[~in_range] *= 0.75
        colors[:, i] = np.floor(255 * col)
    return colors


def flow_to_image(flow: np.ndarray) -> np.ndarray:
    """Dense optical-flow field -> RGB uint8 image (RAFT
    core/utils/flow_viz.py equivalent; used by the preprocessing opt_vis
    dumps).  ``flow``: [H, W, 2]."""
    u, v = flow[..., 0], flow[..., 1]
    rad = np.sqrt(u**2 + v**2)
    scale = np.max(rad) + 1e-5
    colors = flow_xy_to_colors((u / scale).flatten(), (v / scale).flatten())
    return colors.reshape(*flow.shape[:2], 3)


def _bev_canvas(ax):
    """Range rings + bearing spokes on a dark BEV background."""
    for r in (10, 20, 30, 40, 50):
        ylim = 10 if r == 10 else 12.5
        yy = np.linspace(-ylim, ylim, 500)
        ax.plot(np.sqrt(np.maximum(r**2 - yy**2, 0)), yy, lw=0.5, color="white")
        ax.text(r - 0.55, -0.3, str(r), fontsize=12, color="white")
    xx = np.linspace(0, 60, 500)
    for deg in (0, 5, -5, 10, -10, 15, -15):
        ax.plot(xx, xx * np.tan(deg * np.pi / 180), lw=0.5, color="white")
    ax.set_xlim([0, 60])
    ax.set_ylim([-15, 15])
    ax.set_box_aspect(0.5)
    ax.patch.set_facecolor(np.array([80, 80, 80]) / 255)
    for side in ("top", "right", "bottom", "left"):
        ax.spines[side].set_visible(False)
    ax.set_xticks([])
    ax.set_yticks([])


def plot_flow_bev(pc1: np.ndarray, pred_f: np.ndarray, out_path: str) -> None:
    """Flow-colorwheel BEV scatter (visulize_result_2D_pre equivalent).

    Args:
      pc1: ``[N, 3]``; pred_f: ``[N, 3]``.
    """
    import matplotlib

    matplotlib.use("Agg")
    from matplotlib import pyplot as plt

    x_flow, y_flow = pred_f[:, 0].copy(), pred_f[:, 1].copy()
    rad_max = np.max(np.sqrt(x_flow**2 + y_flow**2))
    x_flow /= rad_max + 1e-5
    y_flow /= rad_max + 1e-5

    fig = plt.figure(figsize=(10, 6))
    ax = plt.gca()
    colors = flow_xy_to_colors(x_flow, -y_flow)
    ax.scatter(pc1[:, 0], pc1[:, 1], c=colors / 255, marker="o", s=6)
    _bev_canvas(ax)
    fig.tight_layout()
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    fig.savefig(out_path, dpi=200)
    plt.close(fig)


def plot_seg_bev(pc1: np.ndarray, seg_mask: np.ndarray,
                 out_path: str) -> None:
    """Moving(red)/static(blue) BEV scatter (visulize_result_2D_seg_pre
    equivalent).  ``seg_mask``: 1 = static."""
    import matplotlib

    matplotlib.use("Agg")
    from matplotlib import pyplot as plt

    fig = plt.figure(figsize=(10, 6))
    ax = plt.gca()
    mov = seg_mask == 0
    ax.scatter(pc1[mov, 0], pc1[mov, 1], s=6,
               c=np.array([[255, 99, 71]]) / 255)
    ax.scatter(pc1[~mov, 0], pc1[~mov, 1], s=6,
               c=np.array([[65, 105, 225]]) / 255)
    _bev_canvas(ax)
    fig.tight_layout()
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    fig.savefig(out_path, dpi=200)
    plt.close(fig)
