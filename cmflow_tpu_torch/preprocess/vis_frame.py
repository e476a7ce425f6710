"""Raw VoD frame visualization — devkit ``Visualization2D``/``Visualization3D``
equivalents (preprocess/utils/vod/visualization/vis_2d.py:9-162,
vis_3d.py:9-253, helpers.py:10-206).

Counterpart of ``cmflow_tpu/preprocess/vis_frame.py``.  Host-side numpy and
matplotlib (imported when a figure is drawn), reading frames through
:mod:`cmflow_tpu_torch.preprocess.vod_io`:

* :class:`FrameVisualizer2D` — camera image with radar/lidar point clouds
  projected and colored by depth, plus 3-D label boxes drawn as projected
  wireframes (the devkit's image-overlay plots).
* :class:`FrameVisualizer3D` — 3-D scene plot: point clouds, label-box
  wireframes, sensor-origin axes, and radar radial-velocity vectors.
  The devkit renders these interactively with k3d inside Jupyter
  (vis_3d.py:11); this port draws the same content with matplotlib's 3-D
  axes to a PNG — a deliberate deviation: k3d is notebook-only, while the
  plotted content is preserved 1:1.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from cmflow_tpu_torch.preprocess.vod_io import (
    FrameTransforms,
    VodFrame,
    homogeneous_transformation,
    project_3d_to_2d,
)

# devkit visualization/settings.py palette
LABEL_COLORS: Dict[str, Tuple[float, float, float]] = {
    "Car": (0.0, 0.8, 0.0),
    "Pedestrian": (0.8, 0.0, 0.0),
    "Cyclist": (0.0, 0.0, 0.8),
}
DEFAULT_CLASSES = ("Car", "Pedestrian", "Cyclist")

# box edges over the 8-corner layout of helpers.get_3d_label_corners
_BOX_EDGES = [(0, 1), (1, 2), (2, 3), (3, 0),
              (4, 5), (5, 6), (6, 7), (7, 4),
              (0, 4), (1, 5), (2, 6), (3, 7)]


def parse_frame_labels(raw_labels: Sequence[str]) -> List[Dict]:
    """KITTI-format label lines -> dicts (vod/frame/labels.py:30-58).

    Handles both the 16-field variant (with trailing score) and the plain
    15-field ground-truth variant (score defaults to 1.0)."""
    out = []
    for line in raw_labels:
        f = line.split()
        if len(f) < 15:
            continue
        h, w, l, x, y, z, rot = map(float, f[8:15])
        score = float(f[15]) if len(f) > 15 else 1.0
        out.append({"label_class": f[0], "h": h, "w": w, "l": l,
                    "x": x, "y": y, "z": z, "rotation": rot,
                    "score": score})
    return out


def label_corners_3d(labels: Sequence[Dict], t_camera_lidar: np.ndarray,
                     t_target_lidar: Optional[np.ndarray] = None
                     ) -> List[Dict]:
    """8-corner boxes per label in the lidar frame (or ``t_target_lidar``-
    transformed target frame) — helpers.get_3d_label_corners +
    get_transformed_3d_label_corners (helpers.py:27-95).

    Labels store (x, y, z) in camera coordinates with the devkit's
    adjusted rotation; corners are built z-up around the bottom-center in
    the lidar frame with rotation ``-(rot + pi/2)`` about z."""
    out = []
    t_lidar_camera = np.linalg.inv(t_camera_lidar)
    for lab in labels:
        x_c = np.array([lab["l"] / 2] * 2 + [-lab["l"] / 2] * 2
                       + [lab["l"] / 2] * 2 + [-lab["l"] / 2] * 2)
        y_c = np.array([lab["w"] / 2, -lab["w"] / 2, -lab["w"] / 2,
                        lab["w"] / 2] * 2)
        z_c = np.array([0.0] * 4 + [lab["h"]] * 4)
        corners = np.stack([x_c, y_c, z_c])  # [3, 8]

        rot = -(lab["rotation"] + np.pi / 2)
        c, s = np.cos(rot), np.sin(rot)
        rm = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
        center = (t_lidar_camera
                  @ np.array([lab["x"], lab["y"], lab["z"], 1.0]))[:3]
        pts = (rm @ corners).T + center  # [8, 3] lidar frame
        if t_target_lidar is not None:
            hom = np.concatenate([pts, np.ones((8, 1))], 1)
            pts = homogeneous_transformation(hom, t_target_lidar)[:, :3]
        out.append({"label_class": lab["label_class"],
                    "score": lab["score"], "corners_3d": pts,
                    "range": float(np.linalg.norm(center))})
    return out


def _filter_labels(boxes, classes, score_threshold, max_distance):
    return [b for b in boxes
            if b["label_class"] in classes
            and b["score"] >= score_threshold
            and b["range"] < max_distance]


def _project_points(points: np.ndarray, t_camera_sensor: np.ndarray,
                    projection: np.ndarray, img_shape,
                    min_distance: float, max_distance: float):
    """Project sensor-frame points into the image; return (uv, depth)
    filtered to the image bounds and depth window (vis_2d.py:72-108)."""
    hom = np.concatenate(
        [points[:, :3], np.ones((len(points), 1))], 1)
    cam = homogeneous_transformation(hom, t_camera_sensor)
    depth = cam[:, 2]
    uv = project_3d_to_2d(cam, projection)
    h, w = img_shape[:2]
    keep = ((depth > min_distance) & (depth < max_distance)
            & (uv[:, 0] >= 0) & (uv[:, 0] < w)
            & (uv[:, 1] >= 0) & (uv[:, 1] < h))
    return uv[keep], depth[keep]


class FrameVisualizer2D:
    """Camera-image overlay plots (vis_2d.py Visualization2D)."""

    def __init__(self, frame: VodFrame, transforms: FrameTransforms,
                 classes: Sequence[str] = DEFAULT_CLASSES):
        self.frame = frame
        self.tf = transforms
        self.classes = tuple(classes)

    def draw(
        self,
        out_path: str,
        show_radar: bool = True,
        show_lidar: bool = False,
        show_labels: bool = True,
        score_threshold: float = 0.0,
        min_distance: float = 0.0,
        max_distance: float = 50.0,
    ) -> str:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        img = self.frame.image
        fig, ax = plt.subplots(
            figsize=(img.shape[1] / 100, img.shape[0] / 100), dpi=100)
        ax.imshow(img)
        ax.axis("off")

        if show_lidar:
            uv, depth = _project_points(
                self.frame.lidar_data, self.tf.t_camera_lidar,
                self.tf.camera_projection_matrix, img.shape,
                min_distance, max_distance)
            ax.scatter(uv[:, 0], uv[:, 1], c=depth, cmap="viridis", s=1,
                       alpha=0.6)
        if show_radar:
            uv, depth = _project_points(
                self.frame.radar_data, self.tf.t_camera_radar,
                self.tf.camera_projection_matrix, img.shape,
                min_distance, max_distance)
            ax.scatter(uv[:, 0], uv[:, 1], c=depth, cmap="autumn", s=14,
                       alpha=0.9)

        if show_labels:
            labels = parse_frame_labels(self.frame.raw_labels)
            boxes = label_corners_3d(labels, self.tf.t_camera_lidar)
            boxes = _filter_labels(boxes, self.classes, score_threshold,
                                   max_distance)
            for b in boxes:
                hom = np.concatenate(
                    [b["corners_3d"], np.ones((8, 1))], 1)
                cam = homogeneous_transformation(hom,
                                                 self.tf.t_camera_lidar)
                if (cam[:, 2] <= 0.1).any():
                    continue
                uv = project_3d_to_2d(
                    cam, self.tf.camera_projection_matrix)
                color = LABEL_COLORS.get(b["label_class"], (0.5, 0.5, 0.5))
                for i, j in _BOX_EDGES:
                    ax.plot([uv[i, 0], uv[j, 0]], [uv[i, 1], uv[j, 1]],
                            color=color, linewidth=1.2)

        os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
        fig.savefig(out_path, bbox_inches="tight", pad_inches=0)
        plt.close(fig)
        return out_path


class FrameVisualizer3D:
    """3-D scene plot (vis_3d.py Visualization3D; matplotlib instead of
    the notebook-only k3d — same content, static PNG output)."""

    def __init__(self, frame: VodFrame, transforms: FrameTransforms,
                 origin: str = "lidar",
                 classes: Sequence[str] = DEFAULT_CLASSES):
        if origin not in ("lidar", "radar", "camera"):
            raise ValueError(origin)
        self.frame = frame
        self.tf = transforms
        self.origin = origin
        self.classes = tuple(classes)

    def _t_origin_from(self, sensor: str) -> np.ndarray:
        if sensor == self.origin:
            return np.eye(4)
        return getattr(self.tf, f"t_{self.origin}_{sensor}")

    def draw(
        self,
        out_path: str,
        show_radar: bool = True,
        show_lidar: bool = True,
        show_labels: bool = True,
        show_origins: bool = True,
        show_radial_velocity: bool = True,
        score_threshold: float = 0.0,
        max_distance: float = 60.0,
        grid_limit: float = 40.0,
    ) -> str:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig = plt.figure(figsize=(12, 9))
        ax = fig.add_subplot(projection="3d")

        if show_lidar:
            pts = self.frame.lidar_data[:, :3]
            hom = np.concatenate([pts, np.ones((len(pts), 1))], 1)
            pts = homogeneous_transformation(
                hom, self._t_origin_from("lidar"))[:, :3]
            keep = np.linalg.norm(pts, axis=1) < max_distance
            ax.scatter(*pts[keep].T, s=0.3, c="gray", alpha=0.4)

        if show_radar or show_radial_velocity:
            radar = self.frame.radar_data
            hom = np.concatenate(
                [radar[:, :3], np.ones((len(radar), 1))], 1)
            pts = homogeneous_transformation(
                hom, self._t_origin_from("radar"))[:, :3]
            keep = np.linalg.norm(pts, axis=1) < max_distance
            if show_radar:
                sc = ax.scatter(*pts[keep].T, s=10,
                                c=radar[keep, 4], cmap="coolwarm")
                fig.colorbar(sc, ax=ax, shrink=0.5, label="v_r [m/s]")
            if show_radial_velocity:
                # velocity vectors along the radial direction
                # (helpers.get_radar_velocity_vectors, helpers.py:202-206)
                unit = pts[keep] / np.maximum(
                    np.linalg.norm(pts[keep], axis=1, keepdims=True), 1e-6)
                vec = unit * radar[keep, 4:5]
                ax.quiver(*pts[keep].T, *vec.T, length=1.0, color="m",
                          linewidth=0.5, arrow_length_ratio=0.2)

        if show_labels:
            labels = parse_frame_labels(self.frame.raw_labels)
            boxes = label_corners_3d(
                labels, self.tf.t_camera_lidar,
                t_target_lidar=self._t_origin_from("lidar"))
            boxes = _filter_labels(boxes, self.classes, score_threshold,
                                   max_distance)
            for b in boxes:
                color = LABEL_COLORS.get(b["label_class"], (0.5, 0.5, 0.5))
                c3 = b["corners_3d"]
                for i, j in _BOX_EDGES:
                    ax.plot(*np.stack([c3[i], c3[j]]).T, color=color,
                            linewidth=1.5)

        if show_origins:
            # sensor-origin axis triads (helpers.k3d_get_axes equivalent)
            for sensor, ls in (("radar", "-"), ("lidar", "--"),
                               ("camera", ":")):
                t = self._t_origin_from(sensor)
                o = t[:3, 3]
                for axis, color in zip(t[:3, :3].T, "rgb"):
                    seg = np.stack([o, o + axis])
                    ax.plot(*seg.T, color=color, linestyle=ls,
                            linewidth=2)

        ax.set_xlim(-grid_limit, grid_limit)
        ax.set_ylim(-grid_limit, grid_limit)
        ax.set_zlim(-5, 10)
        ax.set_xlabel("x [m]")
        ax.set_ylabel("y [m]")
        ax.set_zlabel("z [m]")

        os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
        fig.savefig(out_path, dpi=110)
        plt.close(fig)
        return out_path
