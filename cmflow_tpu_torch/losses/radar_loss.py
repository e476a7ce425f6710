"""Multi-task radar scene-flow losses.

Counterpart of ``cmflow_tpu/losses/radar_loss.py`` (reference
losses/radar_loss.py): pure functions of tensors, channels-last
``[B, N, 3]``.  Under data parallelism (a process ``group``, the JAX
package's ``axis_name``) the count-normalised terms take the global batch's
counts (:func:`_global_ratio`).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

from cmflow_tpu_torch.geometry import camera as cam
from cmflow_tpu_torch.geometry import se3
from cmflow_tpu_torch.ops import pointops
from cmflow_tpu_torch.parallel import mesh
from cmflow_tpu_torch.parallel.mesh import Group

Tensor = torch.Tensor


def _l2_norm(x: Tensor, dim: int = -1) -> Tensor:
    """L2 norm with a zero subgradient at 0 (where the plain norm's gradient
    is NaN).  Zero differences occur: the loader duplicates points when a
    cloud has fewer than ``num_points``, so a point's neighbours can hold
    its own duplicate with an identical predicted flow."""
    sq = torch.sum(x * x, dim=dim)
    nz = sq > 0
    return torch.where(nz, torch.sqrt(torch.where(nz, sq, 1.0)), 0.0)


def soft_chamfer_loss(pc1: Tensor, pc2: Tensor, pc1_warp: Tensor,
                      zeta: float = 0.005) -> Tensor:
    """Density-gated soft Chamfer distance (radar_loss.py:17-58): KDE
    densities gate out sparse points, and nearest squared distances below
    0.01 are free."""
    mask1 = (se3.kde_density(pc1, pc2, 1.0) > zeta).to(pc1.dtype)
    mask2 = (se3.kde_density(pc2, pc1, 1.0) > zeta).to(pc1.dtype)
    sqrdist = pointops.square_distance(pc1_warp, pc2)  # [B, N, M]
    # amin splits the gradient among tied minima, as jnp.min does
    dist1 = torch.relu(torch.amin(sqrdist, dim=-1) - 0.01) * mask1
    dist2 = torch.relu(torch.amin(sqrdist, dim=1) - 0.01) * mask2
    return torch.mean(dist1) + torch.mean(dist2)


def spatial_smoothness_loss(pc1: Tensor, pred_flow: Tensor,
                            alpha: float = 0.5, num_nb: int = 8) -> Tensor:
    """Distance-weighted local flow smoothness (radar_loss.py:60-98).

    The ``num_nb + 1`` nearest points come from a stable sort, so that
    ties (a point and its duplicate at d^2 = 0) go to the lower index, as
    ``lax.top_k`` breaks them; the first, the point itself, is dropped."""
    b, n, _ = pc1.shape
    sqrdist = pointops.square_distance(pc1, pc1)
    dist, kidx = torch.sort(sqrdist, dim=-1, stable=True)
    dists = torch.clamp_min(dist[:, :, 1:num_nb + 1], 0.0)
    kidx = kidx[:, :, 1:num_nb + 1].to(torch.int32)
    w = torch.softmax(torch.exp(-dists / alpha).reshape(b, n * num_nb),
                      dim=1).reshape(b, n, num_nb)
    grouped = pointops.group_points(pred_flow, kidx)  # [B, N, K, 3]
    diff = _l2_norm(grouped - pred_flow[:, :, None, :])
    return torch.mean(torch.sum(n * w * diff, dim=2))


def radial_displacement_loss(pc1: Tensor, pred_f: Tensor, vel1: Tensor,
                             interval: float = 0.1) -> Tensor:
    """Doppler radial-projection consistency (radar_loss.py:100-122), with
    the reference's fixed 0.1 s interval."""
    pred_fr = (torch.sum(pred_f * pc1, dim=-1)
               / torch.linalg.norm(pc1, dim=-1))
    return torch.mean(torch.abs(vel1 * interval - pred_fr))


def self_supervised_loss(pc1: Tensor, pc2: Tensor, pred_f: Tensor,
                         vel1: Tensor, w_sc: float = 1.0, w_ss: float = 1.0,
                         w_rd: float = 1.0) -> Tuple[Tensor, Dict[str, Tensor]]:
    """Chamfer + smoothness + radial displacement (radar_loss.py:124-161)."""
    sc = soft_chamfer_loss(pc1, pc2, pc1 + pred_f)
    ss = spatial_smoothness_loss(pc1, pred_f)
    rd = radial_displacement_loss(pc1, pred_f, vel1)
    total = w_sc * sc + w_ss * ss + w_rd * rd
    return total, {"Loss": total, "chamferLoss": sc, "smoothnessLoss": ss,
                   "veloLoss": rd}


def ego_motion_loss(pc1: Tensor, pre_trans: Tensor,
                    gt_trans: Tensor) -> Tensor:
    """Mean distance between pc1 moved by the predicted and by the true
    transform (radar_loss.py:163-182)."""
    return torch.mean(_l2_norm(se3.apply_transform(pc1, pre_trans)
                               - se3.apply_transform(pc1, gt_trans)))


def _global_ratio(num: Tensor, den: Tensor, group: Group) -> Tensor:
    """A count-normalised term, ``num / max(den, 1)`` on one process.

    Under data parallelism each rank holds a slice of the batch, and the
    reference computes these terms on the whole batch.  The denominators
    are label counts (no gradient), so the rank's term is ``G * num_local /
    max(sum over ranks of den, 1)``: its mean over the ranks is the global
    ratio, and so is the mean of its gradient."""
    if group is None:
        return num / torch.clamp_min(den, 1.0)
    den_g = den.detach().clone()
    dist.all_reduce(den_g, group=group)
    return mesh.size(group) * num / torch.clamp_min(den_g, 1.0)


def binary_cross_entropy(p: Tensor, y: Tensor) -> Tensor:
    """Elementwise BCE on probabilities, logs clamped at -100 as
    ``torch.nn.BCELoss`` does."""
    logp = torch.clamp_min(torch.log(p), -100.0)
    log1p = torch.clamp_min(torch.log1p(-p), -100.0)
    return -(y * logp + (1.0 - y) * log1p)


def motion_seg_loss(mseg_pre: Tensor, mseg_gt: Tensor,
                    group: Group = None) -> Tensor:
    """Class-balanced BCE (radar_loss.py:184-205): half the mean over static
    points plus half the mean over moving points; an absent class adds 0."""
    bce = binary_cross_entropy(mseg_pre, mseg_gt)
    is0 = (mseg_gt == 0).to(bce.dtype)
    is1 = (mseg_gt == 1).to(bce.dtype)
    return 0.5 * (_global_ratio(torch.sum(bce * is0), torch.sum(is0), group)
                  + _global_ratio(torch.sum(bce * is1), torch.sum(is1), group))


def optical_flow_loss(opt: Tensor, radar_u: Tensor, radar_v: Tensor,
                      pc1_warp: Tensor, mseg_gt: Tensor, projection: Tensor,
                      t_camera_radar: Tensor, lower_bound: float = 0.25,
                      group: Group = None) -> Tensor:
    """Point-to-camera-ray reprojection loss on moving points
    (radar_loss.py:207-242)."""
    end_pixels = torch.stack([radar_u, radar_v], dim=-1) + opt
    opt_div = cam.point_ray_distance(pc1_warp, end_pixels, projection,
                                     t_camera_radar)
    opt_div = torch.relu(opt_div - lower_bound)
    moving = 1.0 - mseg_gt.detach().to(opt_div.dtype)
    return _global_ratio(torch.sum(moving * opt_div), torch.sum(moving),
                         group)


def dynamic_flow_loss(pred_f: Tensor, gt_f: Tensor, dyn_mask: Tensor,
                      group: Group = None) -> Tensor:
    """Supervised flow loss on (pseudo-labelled) moving points
    (radar_loss.py:244-258); ``dyn_mask`` is 1 static, 0 moving."""
    moving = 1.0 - dyn_mask
    err = _l2_norm(gt_f - pred_f)
    return _global_ratio(torch.sum(moving * err), torch.sum(moving), group)


def radar_flow_loss(
    model: str,
    pc1: Tensor,
    pc2: Tensor,
    pred_f: Tensor,
    vel1: Tensor,
    *,
    gt_f: Optional[Tensor] = None,
    pre_trans: Optional[Tensor] = None,
    mseg_pre: Optional[Tensor] = None,
    gt_trans: Optional[Tensor] = None,
    mseg_gt: Optional[Tensor] = None,
    dyn_mask: Optional[Tensor] = None,
    radar_u: Optional[Tensor] = None,
    radar_v: Optional[Tensor] = None,
    opt: Optional[Tensor] = None,
    projection: Optional[Tensor] = None,
    t_camera_radar: Optional[Tensor] = None,
    w_self: float = 1.0,
    w_em: float = 1.0,
    w_ms: float = 1.0,
    w_opt: float = 0.1,
    w_dyn: float = 1.0,
    group: Group = None,
) -> Tuple[Tensor, Dict[str, Tensor]]:
    """Composite loss (radar_loss.py:260-292): the self-supervised terms,
    and for the cross-modal models the ego-motion, motion-segmentation,
    optical-flow and supervised flow terms.  Returns ``(loss, items)``
    with the keys of ``LOSS_ITEMS[model]``.  ``group`` makes the
    count-normalised terms the global batch's (:func:`_global_ratio`)."""
    total, items = self_supervised_loss(pc1, pc2, pred_f, vel1)
    total = w_self * total
    if model in ("cmflow", "cmflow_t"):
        em = ego_motion_loss(pc1, pre_trans, gt_trans)
        ms = motion_seg_loss(mseg_pre, mseg_gt, group)
        dyn = dynamic_flow_loss(pred_f, gt_f, dyn_mask, group)
        opt_l = optical_flow_loss(opt, radar_u, radar_v, pc1 + pred_f,
                                  mseg_gt, projection, t_camera_radar,
                                  group=group)
        total = total + w_em * em + w_ms * ms + w_opt * opt_l + w_dyn * dyn
        items.update(egoLoss=em, maskLoss=ms, opticalLoss=opt_l,
                     superviseLoss=dyn)
    items["Loss"] = total
    return total, items


# loss-item keys per model (losses/loss_dict.py)
LOSS_ITEMS = {
    "raflow": ("Loss", "chamferLoss", "veloLoss", "smoothnessLoss"),
    "cmflow": (
        "Loss", "chamferLoss", "veloLoss", "smoothnessLoss",
        "egoLoss", "maskLoss", "superviseLoss", "opticalLoss",
    ),
    "cmflow_t": (
        "Loss", "chamferLoss", "veloLoss", "smoothnessLoss",
        "egoLoss", "maskLoss", "superviseLoss", "opticalLoss",
    ),
}
