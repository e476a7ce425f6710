"""Train-time pseudo-label generation, run inside the train step on the
model's device.  Counterpart of ``cmflow_tpu/train/labels.py``
(reference main_util.py:63-67,209-265); the experimental label variants of
the reference's inventory, unused by its training recipe, are not ported.
"""

from __future__ import annotations

from typing import Tuple

import torch

from cmflow_tpu_torch.geometry import se3

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
