"""Oriented-bounding-box utilities for the LiDAR-MOT pseudo-labeler (a copy
of ``cmflow_tpu/preprocess/boxes.py``; open3d-free replacements for
preprocess/utils/get_flow_samples.py:178-303).
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Tuple

import numpy as np
from scipy.spatial.transform import Rotation


@dataclasses.dataclass
class OrientedBox:
    center: np.ndarray  # [3]
    rotation: np.ndarray  # [3, 3]
    extent: np.ndarray  # [3] (l, w, h in box axes)

    def points_inside(self, points: np.ndarray) -> np.ndarray:
        """Indices of [N, 3] points inside the (closed) box — semantics of
        open3d ``get_point_indices_within_bounding_box``."""
        local = (points - self.center) @ self.rotation  # R^T (p - c)
        half = self.extent / 2.0
        ok = np.all(np.abs(local) <= half, axis=1)
        return np.argwhere(ok).flatten()

    def transform(self) -> np.ndarray:
        """4x4 ego->box-pose transform (get_bbx_transformation,
        get_flow_samples.py:241-248)."""
        t = np.zeros((4, 4))
        t[:3, :3] = self.rotation
        t[:3, 3] = self.center
        t[3, 3] = 1.0
        return t


def parse_track_labels(lines: List[str]) -> np.ndarray:
    """Parse AB3DMOT / KITTI-track label lines into
    [h, w, l, x, y, z, rot, score, id] rows (get_track_labels,
    get_flow_samples.py:264-281).  16- and 17-column variants supported."""
    rows = []
    for line in lines:
        f = line.split()
        if len(f) == 17:
            h, w, l, x, y, z, rot, score = f[9:17]
            tid = f[1]
        elif len(f) == 16:
            h, w, l, x, y, z, rot, score = f[8:16]
            tid = f[1]
        else:
            continue
        rows.append([float(h), float(w), float(l), float(x), float(y),
                     float(z), float(rot), float(score), int(tid)])
    return np.array(rows) if rows else np.array([])


def load_track_labels(label_path: str, frame: str) -> np.ndarray:
    path = os.path.join(label_path, f"{frame}.txt")
    if not os.path.exists(path):
        return np.array([])
    with open(path) as f:
        return parse_track_labels(f.readlines())


def box_from_label(obj: np.ndarray, t_sensor_camera: np.ndarray,
                   t_sensor_lidar_rot: np.ndarray) -> OrientedBox:
    """Oriented box in the sensor frame from a camera-frame KITTI label
    (get_bbx_param, get_flow_samples.py:285-303).

    Args:
      obj: [h, w, l, x, y, z, rot, score, id] row.
      t_sensor_camera: 4x4 camera->sensor transform.
      t_sensor_lidar_rot: 3x3 rotation lidar->sensor (identity for lidar).
    """
    center = (t_sensor_camera @ np.array([obj[3], obj[4], obj[5], 1.0]))[:3]
    extent = np.array([obj[2], obj[1], obj[0]])  # l, w, h
    rot = Rotation.from_euler(
        "XYZ", [0.0, 0.0, -(obj[6] + np.pi / 2)]).as_matrix()
    return OrientedBox(center=center, rotation=t_sensor_lidar_rot @ rot,
                       extent=extent)


def inbox_flow(points: np.ndarray, t_ego_box1: np.ndarray,
               t_ego_box2: np.ndarray) -> np.ndarray:
    """Rigid flow of box-1 points induced by the box-1 -> box-2 motion
    (get_inbox_flow, get_flow_samples.py:233-239)."""
    t12 = t_ego_box2 @ np.linalg.inv(t_ego_box1)
    h = np.concatenate([points, np.ones((len(points), 1))], axis=1)
    return (h @ t12.T)[:, :3] - points


def extract_fg_labels(
    labels1: np.ndarray,
    labels2: np.ndarray,
    pc_data1: np.ndarray,
    t_sensor_camera: np.ndarray,
    t_sensor_lidar_rot: np.ndarray,
    max_flow: float = 3.0,
) -> Tuple[List[int], np.ndarray, np.ndarray, List[OrientedBox]]:
    """Match MOT track ids across two frames and produce per-point
    foreground flow labels + confidences (extract_fg_labels,
    get_flow_samples.py:178-217).

    Returns (fg_idx, fg_confs [N], fg_labels [N, 3], fg_boxes).
    """
    n = pc_data1.shape[0]
    fg_idx: List[int] = []
    fg_boxes: List[OrientedBox] = []
    fg_confs = np.zeros(n, np.float32)
    fg_labels = np.zeros((n, 3), np.float32)

    if labels1.ndim != 2 or labels2.ndim != 2:
        return fg_idx, fg_confs, fg_labels, fg_boxes

    for i in range(labels1.shape[0]):
        track_id = labels1[i, -1]
        nxt = np.where(labels2[:, -1] == track_id)[0]
        if len(nxt) == 0:
            continue
        box1 = box_from_label(labels1[i], t_sensor_camera, t_sensor_lidar_rot)
        fg_boxes.append(box1)
        box2 = box_from_label(labels2[nxt[0]], t_sensor_camera,
                              t_sensor_lidar_rot)
        inside = box1.points_inside(pc_data1[:, 0:3])
        if len(inside) == 0:
            continue
        labels = inbox_flow(pc_data1[inside, 0:3], box1.transform(),
                            box2.transform())
        # reject implausible labels from bad MOT matches
        if np.linalg.norm(labels, axis=1).max() < max_flow:
            fg_labels[inside] = labels
            fg_confs[inside] = labels1[i, -2]
            fg_idx.extend(inside.tolist())

    return fg_idx, fg_confs, fg_labels, fg_boxes
