"""Train-time pseudo-label generation, run inside the train step on the
model's device.  Counterpart of ``cmflow_tpu/train/labels.py``
(reference main_util.py:63-67,209-278), with the experimental label
variants of the reference's inventory, unused by its training recipe.
"""

from __future__ import annotations

from typing import Tuple

import torch

from cmflow_tpu_torch.geometry import camera, se3

Tensor = torch.Tensor


def extract_dynamic_from_fg(fg_mask: Tensor, pc1: Tensor, trans: Tensor,
                            flow_label: Tensor) -> Tensor:
    """Refine the foreground mask ``[B, N]`` (1 = background) into a
    static/moving mask (main_util.py:209-224): foreground points whose
    labelled flow is within 0.05 m of the ego flow of ``trans`` ``[B, 4, 4]``
    are static.  Returns float32, 1 = static, 0 = moving."""
    flow_nr = se3.rigid_to_flow(pc1, trans) - flow_label
    fg = fg_mask != 1
    nr_norm = torch.linalg.norm(flow_nr * fg[..., None], dim=-1)
    return ((fg_mask == 1) | (nr_norm < 0.05)).to(torch.float32)


def mseg_label_rrv(pc1: Tensor, trans: Tensor, vel1: Tensor,
                   interval: Tensor, vr_thres: float) -> Tuple[Tensor, Tensor]:
    """Motion-segmentation pseudo labels from the relative radial velocity
    (main_util.py:253-265).  Returns ``(label, residual)``, 1 = static."""
    gt_sf_rg = se3.rigid_to_flow(pc1, trans)
    proj = torch.sum(gt_sf_rg * pc1, dim=-1) / torch.linalg.norm(pc1, dim=-1)
    residual = torch.abs(vel1 - proj / interval[:, None])
    bs = torch.mean(residual, dim=1, keepdim=True)
    return ((residual - bs) < vr_thres).to(torch.float32), residual


def merge_mseg_labels(mseg_rrv: Tensor, dyn_mask: Tensor) -> Tensor:
    """Where ``dyn_mask`` says moving (0), moving; else the RRV label
    (main_util.py:66-67)."""
    return torch.where(dyn_mask == 1, mseg_rrv, dyn_mask)


# --- experimental label variants kept for parity with the reference's
# --- inventory (main_util.py:227-278; unused by its training recipe, and
# --- their sigma_opt / sigma_rrv / opt_thres are not config keys)


def _rrv_residual(pc1: Tensor, trans: Tensor, vel1: Tensor,
                  interval: Tensor) -> Tensor:
    gt_sf_rg = se3.rigid_to_flow(pc1, trans)
    proj = torch.sum(gt_sf_rg * pc1, dim=-1) / torch.linalg.norm(pc1, dim=-1)
    return vel1 * interval[:, None] - proj


def _opt_residual(pc1: Tensor, trans: Tensor, radar_u: Tensor,
                  radar_v: Tensor, opt_flow: Tensor, projection: Tensor,
                  t_camera_radar: Tensor) -> Tensor:
    """Pixel distance ``[B, N]`` between each point's ego-motion warp
    projected into the image and the end of its optical flow."""
    gt_wp_rg = se3.rigid_to_flow(pc1, trans) + pc1
    end_pixels = torch.stack([radar_u, radar_v], dim=-1) + opt_flow
    rg_proj = camera.project_radar_to_image(gt_wp_rg, projection,
                                            t_camera_radar)
    return torch.linalg.norm(rg_proj - end_pixels, dim=-1)


def probabilistic_label_rrv(pc1: Tensor, trans: Tensor, vel1: Tensor,
                            interval: Tensor, sigma_rrv: float) -> Tensor:
    """Soft static probability ``[B, N]`` from the radial-velocity residual
    (main_util.py:242-251)."""
    residual = _rrv_residual(pc1, trans, vel1, interval)
    return torch.exp(-(residual ** 2) / (2 * sigma_rrv ** 2))


def probabilistic_label_opt(pc1: Tensor, trans: Tensor, radar_u: Tensor,
                            radar_v: Tensor, opt_flow: Tensor,
                            projection: Tensor, t_camera_radar: Tensor,
                            sigma_opt: float) -> Tensor:
    """Soft static probability ``[B, N]`` from the optical-flow reprojection
    residual (main_util.py:227-239)."""
    residual = _opt_residual(pc1, trans, radar_u, radar_v, opt_flow,
                             projection, t_camera_radar)
    return torch.exp(-(residual ** 2) / (2 * sigma_opt ** 2))


def mseg_label_opt(pc1: Tensor, trans: Tensor, radar_u: Tensor,
                   radar_v: Tensor, opt_flow: Tensor, projection: Tensor,
                   t_camera_radar: Tensor, opt_thres: float) -> Tensor:
    """Hard static (1) / moving (0) labels ``[B, N]`` from the optical-flow
    reprojection residual (main_util.py:267-278)."""
    residual = _opt_residual(pc1, trans, radar_u, radar_v, opt_flow,
                             projection, t_camera_radar)
    return (residual < opt_thres).to(torch.float32)
