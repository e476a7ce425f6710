"""SE(3) and camera geometry."""

from cmflow_tpu_torch.geometry.camera import (
    CameraCalib,
    point_ray_distance,
    project_radar_to_image,
)
from cmflow_tpu_torch.geometry.se3 import (
    apply_transform,
    get_matrix_from_ext,
    kde_density,
    make_transform,
    quat2mat,
    relative_se3,
    rigid_to_flow,
    se3_inverse,
    weighted_kabsch,
)

__all__ = [
    "CameraCalib",
    "apply_transform",
    "get_matrix_from_ext",
    "kde_density",
    "make_transform",
    "point_ray_distance",
    "project_radar_to_image",
    "quat2mat",
    "relative_se3",
    "rigid_to_flow",
    "se3_inverse",
    "weighted_kabsch",
]
