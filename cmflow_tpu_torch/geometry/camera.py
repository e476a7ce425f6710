"""Camera projection geometry for the cross-modal optical-flow loss.

Counterpart of ``cmflow_tpu/geometry/camera.py``: ``project_radar_to_image``
(utils/util.py:16-28) and ``point_ray_distance`` (utils/util.py:31-58),
channels-last, with the two calibration matrices passed explicitly, and the
host-side calibration record :class:`CameraCalib`.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class CameraCalib:
    """VoD radar->camera calibration (dataset/vod_radar_calib.txt): the
    3x4 camera projection and the 4x4 radar->camera transform, float32."""

    projection: np.ndarray
    t_camera_radar: np.ndarray

    @staticmethod
    def from_kitti_file(path: str) -> "CameraCalib":
        """Parse a KITTI-style calibration file (dataset/vod.py:127-134):
        ``P2`` on its third line, ``Tr_velo_to_cam`` on its sixth."""
        with open(path, "r") as f:
            lines = f.readlines()
        intrinsic = np.array(
            lines[2].strip().split(" ")[1:], dtype=np.float32).reshape(3, 4)
        extrinsic = np.array(
            lines[5].strip().split(" ")[1:], dtype=np.float32).reshape(3, 4)
        extrinsic = np.concatenate([extrinsic, [[0, 0, 0, 1]]], axis=0)
        return CameraCalib(projection=intrinsic,
                           t_camera_radar=extrinsic.astype(np.float32))


def _homogeneous(x: Tensor) -> Tensor:
    """``[B, N, C]`` -> ``[B, N, C + 1]`` with a trailing one."""
    return torch.cat([x, torch.ones_like(x[..., :1])], dim=-1)


def project_radar_to_image(pcs: Tensor, projection: Tensor,
                           t_camera_radar: Tensor) -> Tensor:
    """Pixel coordinates ``[B, N, 2]`` of radar-frame points ``[B, N, 3]``,
    through the radar->camera transform ``[4, 4]`` and the camera
    projection ``[3, 4]``."""
    cam = torch.einsum("ij,bnj->bni", t_camera_radar, _homogeneous(pcs))
    uvz = torch.einsum("ij,bnj->bni", projection, cam)
    return uvz[..., :2] / uvz[..., 2:3]


def point_ray_distance(warped_pcs: Tensor, pixels: Tensor, projection: Tensor,
                       t_camera_radar: Tensor) -> Tensor:
    """Distance ``[B, N]`` from warped radar-frame points ``[B, N, 3]`` to
    the camera rays through the target pixels ``[B, N, 2]``.

    The norm has torch's zero subgradient: a point exactly on its ray has a
    zero cross product, where the plain norm's gradient is NaN."""
    k_inv = torch.linalg.inv(projection[:3, :3])
    cam_dirs = torch.einsum("ij,bnj->bni", k_inv, _homogeneous(pixels))
    unit = cam_dirs / torch.linalg.norm(cam_dirs, dim=-1, keepdim=True)
    warped_cam = torch.einsum("ij,bnj->bni", t_camera_radar,
                              _homogeneous(warped_pcs))[..., :3]
    cr = torch.linalg.cross(unit, warped_cam, dim=-1)
    sq = torch.sum(cr * cr, dim=-1)
    nz = sq > 0
    return torch.where(nz, torch.sqrt(torch.where(nz, sq, 1.0)), 0.0)
