"""Losses.  Counterpart of ``cmflow_tpu/losses``."""

from cmflow_tpu_torch.losses.radar_loss import (
    LOSS_ITEMS,
    binary_cross_entropy,
    dynamic_flow_loss,
    ego_motion_loss,
    motion_seg_loss,
    optical_flow_loss,
    radar_flow_loss,
    radial_displacement_loss,
    self_supervised_loss,
    soft_chamfer_loss,
    spatial_smoothness_loss,
)

__all__ = [
    "LOSS_ITEMS",
    "binary_cross_entropy",
    "dynamic_flow_loss",
    "ego_motion_loss",
    "motion_seg_loss",
    "optical_flow_loss",
    "radar_flow_loss",
    "radial_displacement_loss",
    "self_supervised_loss",
    "soft_chamfer_loss",
    "spatial_smoothness_loss",
]
