"""View-of-Delft raw-dataset IO (a copy of ``cmflow_tpu/preprocess/vod_io.py``,
the subset of the VoD devkit the preprocessing needs: preprocess/utils/vod/).

Directory layout (KITTI-style, vod devkit configuration/file_locations.py):

    <root>/radar/training/velodyne/<id>.bin     7-col float32 radar scans
    <root>/radar/training/calib/<id>.txt        radar calib (P2 + extrinsic)
    <root>/radar/training/pose/<id>.json        odomToCamera pose (json lines)
    <root>/lidar/training/velodyne/<id>.bin     4-col float32 lidar scans
    <root>/lidar/training/calib/<id>.txt        lidar calib
    <root>/lidar/training/image_2/<id>.jpg      camera images
    <root>/lidar/training/label_2/<id>.txt      KITTI ground-truth labels
"""

from __future__ import annotations

import dataclasses
import json
import os
from functools import cached_property
from typing import List, Optional

import numpy as np

IMG_WIDTH = 1936
IMG_HEIGHT = 1216


@dataclasses.dataclass(frozen=True)
class VodLocations:
    """Dataset directory layout (vod configuration/file_locations.py:4-36)."""

    root_dir: str
    frame_set_path: str = ""
    pred_dir: str = ""

    @property
    def radar_dir(self) -> str:
        return os.path.join(self.root_dir, "radar", "training", "velodyne")

    @property
    def radar_calib_dir(self) -> str:
        return os.path.join(self.root_dir, "radar", "training", "calib")

    @property
    def pose_dir(self) -> str:
        return os.path.join(self.root_dir, "radar", "training", "pose")

    @property
    def lidar_dir(self) -> str:
        return os.path.join(self.root_dir, "lidar", "training", "velodyne")

    @property
    def lidar_calib_dir(self) -> str:
        return os.path.join(self.root_dir, "lidar", "training", "calib")

    @property
    def img_dir(self) -> str:
        return os.path.join(self.root_dir, "lidar", "training", "image_2")

    @property
    def label_dir(self) -> str:
        return os.path.join(self.root_dir, "lidar", "training", "label_2")


class VodFrame:
    """Lazy per-frame loader (vod frame/data_loader.py:10-229)."""

    def __init__(self, locations: VodLocations, frame_number: str):
        self.loc = locations
        self.frame_number = str(frame_number)
        self.file_id = self.frame_number.zfill(5)

    @cached_property
    def radar_data(self) -> np.ndarray:
        """[N, 7] float32: x, y, z, RCS, v_r, v_r_compensated, time."""
        path = os.path.join(self.loc.radar_dir, f"{self.file_id}.bin")
        return np.fromfile(path, np.float32).reshape(-1, 7)

    @cached_property
    def lidar_data(self) -> np.ndarray:
        """[N, 4] float32: x, y, z, reflectance."""
        path = os.path.join(self.loc.lidar_dir, f"{self.file_id}.bin")
        return np.fromfile(path, np.float32).reshape(-1, 4)

    @cached_property
    def image(self) -> np.ndarray:
        """RGB uint8 image."""
        from PIL import Image

        path = os.path.join(self.loc.img_dir, f"{self.file_id}.jpg")
        return np.asarray(Image.open(path).convert("RGB"))

    @cached_property
    def raw_labels(self) -> List[str]:
        path = os.path.join(self.loc.label_dir, f"{self.file_id}.txt")
        if not os.path.exists(path):
            return []
        with open(path) as f:
            return f.readlines()


def _read_kitti_calib(path: str):
    with open(path) as f:
        lines = f.readlines()
    intrinsic = np.array(lines[2].strip().split(" ")[1:],
                         dtype=np.float32).reshape(3, 4)
    extrinsic = np.array(lines[5].strip().split(" ")[1:],
                         dtype=np.float32).reshape(3, 4)
    extrinsic = np.concatenate([extrinsic, [[0, 0, 0, 1]]], axis=0)
    return intrinsic, extrinsic


class FrameTransforms:
    """Transform graph for one frame (vod frame/transformations.py:11-283).

    Naming: ``t_a_b`` maps homogeneous points from frame ``b`` to ``a``.
    """

    def __init__(self, locations: VodLocations, frame_number: str):
        self.loc = locations
        self.file_id = str(frame_number).zfill(5)

    @cached_property
    def _radar_calib(self):
        return _read_kitti_calib(
            os.path.join(self.loc.radar_calib_dir, f"{self.file_id}.txt"))

    @cached_property
    def _lidar_calib(self):
        return _read_kitti_calib(
            os.path.join(self.loc.lidar_calib_dir, f"{self.file_id}.txt"))

    @property
    def camera_projection_matrix(self) -> np.ndarray:
        return self._radar_calib[0]

    @property
    def t_camera_radar(self) -> np.ndarray:
        return self._radar_calib[1]

    @property
    def t_camera_lidar(self) -> np.ndarray:
        return self._lidar_calib[1]

    @cached_property
    def t_radar_camera(self) -> np.ndarray:
        return np.linalg.inv(self.t_camera_radar)

    @cached_property
    def t_lidar_camera(self) -> np.ndarray:
        return np.linalg.inv(self.t_camera_lidar)

    @cached_property
    def t_radar_lidar(self) -> np.ndarray:
        return self.t_radar_camera @ self.t_camera_lidar

    @cached_property
    def t_lidar_radar(self) -> np.ndarray:
        return self.t_lidar_camera @ self.t_camera_radar

    @cached_property
    def t_odom_camera(self) -> np.ndarray:
        path = os.path.join(self.loc.pose_dir, f"{self.file_id}.json")
        with open(path) as f:
            first = json.loads(f.readline())
        return np.array(first["odomToCamera"], np.float32).reshape(4, 4)

    @cached_property
    def t_camera_odom(self) -> np.ndarray:
        return np.linalg.inv(self.t_odom_camera)


def homogeneous_transformation(points: np.ndarray,
                               transform: np.ndarray) -> np.ndarray:
    """Apply a 4x4 transform to [N, 4] homogeneous points."""
    if transform.shape != (4, 4):
        raise ValueError(f"{transform.shape} must be 4x4!")
    if points.shape[1] != 4:
        raise ValueError(f"{points.shape[1]} must be Nx4!")
    return points @ transform.T


def project_3d_to_2d(points: np.ndarray,
                     projection_matrix: np.ndarray) -> np.ndarray:
    """Project [N, 4] homogeneous camera-frame points to integer pixels
    (vod frame/transformations.py:285-405 equivalent)."""
    if points.shape[-1] != 4:
        raise ValueError(f"{points.shape[-1]} must be 4!")
    uvw = projection_matrix @ points.T
    uvw = uvw / uvw[2]
    return np.round(uvw[:2].T).astype(np.int64)


def filt_points_in_fov(pc_data: np.ndarray, t_camera_sensor: np.ndarray,
                       projection: np.ndarray) -> np.ndarray:
    """Indices of points whose camera projection lands inside the image
    (preprocess/utils/optical_flow.py:77-89)."""
    h = np.concatenate(
        [pc_data[:, 0:3], np.ones((pc_data.shape[0], 1))], axis=1)
    cam = homogeneous_transformation(h, t_camera_sensor)
    uvs = project_3d_to_2d(cam, projection)
    ok = ((uvs[:, 0] > 0) & (uvs[:, 0] <= IMG_WIDTH)
          & (uvs[:, 1] > 0) & (uvs[:, 1] <= IMG_HEIGHT))
    return np.argwhere(ok).flatten()


def filt_points_by_height(pc_data: np.ndarray, lo: float,
                          hi: float) -> np.ndarray:
    """Indices of points with z within [lo, hi]
    (get_flow_samples.py:306-312)."""
    z = pc_data[:, 2]
    return np.argwhere((z >= lo) & (z <= hi)).flatten()


def get_frame_list(path: str) -> List[str]:
    """Read a clip's frame-number list file (preprocess/clips/*.txt)."""
    with open(path) as f:
        return [ln.strip() for ln in f if ln.strip()]
