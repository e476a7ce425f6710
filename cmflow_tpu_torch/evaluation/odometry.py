"""Odometry RPE math (utils/odometry_util.py equivalents, host numpy).
A copy of ``cmflow_tpu/evaluation/odometry.py``."""

from __future__ import annotations

from typing import List

import numpy as np
from scipy.spatial.transform import Rotation


def se3_inverse(pose: np.ndarray) -> np.ndarray:
    """Inverse of a 4x4 rigid pose (utils/odometry_util.py:80-95)."""
    r_inv = pose[:3, :3].T
    t_inv = -r_inv @ pose[:3, 3]
    out = np.eye(4)
    out[:3, :3] = r_inv
    out[:3, 3] = t_inv
    return out


def relative_se3(pose_1: np.ndarray, pose_2: np.ndarray) -> np.ndarray:
    """``pose_1^{-1} @ pose_2`` (utils/odometry_util.py:63-78)."""
    return se3_inverse(pose_1) @ pose_2


def calculate_rpe_vector(gt: np.ndarray, pred: np.ndarray) -> List[np.ndarray]:
    """Relative error transforms for each pose pair
    (utils/odometry_util.py:34-61)."""
    return [relative_se3(gt[i], pred[i]) for i in range(len(gt))]


def so3_log(rot_matrix: np.ndarray) -> float:
    """Rotation angle (rad) of a rotation matrix
    (utils/odometry_util.py:144-160)."""
    vec = Rotation.from_matrix(rot_matrix).as_rotvec()
    return float(np.linalg.norm(vec))


def calc_rpe_error(
    error_vector: List[np.ndarray], error_type: str = "rotation_angle_deg"
) -> List[float]:
    """Scalar errors from relative transforms (utils/odometry_util.py:119-142)."""
    if error_type == "translation_part":
        return [float(np.linalg.norm(e[:3, 3])) for e in error_vector]
    if error_type == "rotation_part":
        return [float(np.linalg.norm(e[:3, :3] - np.eye(3)))
                for e in error_vector]
    if error_type == "rotation_angle_deg":
        return [abs(so3_log(e[:3, :3])) * 180 / np.pi for e in error_vector]
    raise NotImplementedError(error_type)


def get_statistics(rpe_vector) -> dict:
    """Summary statistics (utils/odometry_util.py:162-182)."""
    v = np.asarray(rpe_vector)
    return {
        "max": float(np.max(v)),
        "mean": float(np.mean(v)),
        "median": float(np.median(v)),
        "min": float(np.min(v)),
        "rmse": float(np.sqrt(np.mean(v**2))),
        "sse": float(np.sum(v**2)),
        "std": float(np.std(v)),
    }
