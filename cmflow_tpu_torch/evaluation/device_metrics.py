"""On-device per-frame metric battery for the eval loop.

Counterpart of ``cmflow_tpu/evaluation/device_metrics.py``: the math of
:mod:`cmflow_tpu_torch.evaluation.metrics` (utils/eval_util.py:4-112) as
torch functions on device tensors, so the eval loop folds each batch's
``[B, 14]`` metric vector into device sums and the host reads them once per
pass.  Two differences from the host battery, both below float32 noise for
real inputs:

  * computed in float32 (the host battery upcasts to float64);
  * the RPE rotation angle is ``atan2(|skew(R)|/2, (tr(R)-1)/2)``, not
    scipy's rotation vector: algebraically the same, and accurate for small
    angles where ``arccos`` loses half the significant digits.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from cmflow_tpu_torch.evaluation.metrics import LIDAR_RES, RADAR_RES

Tensor = torch.Tensor

# metric slot order in the [B, 14] per-frame vector
METRIC_KEYS = ("rne", "50-50 rne", "mov_rne", "stat_rne", "sas", "ras",
               "epe", "accs", "accr", "acc", "miou", "sen", "RTE", "RAE")


def _cartesian_res(pc: Tensor, res: Dict[str, float]) -> Tensor:
    """Per-point xyz resolution, ``[..., 3]`` (``metrics.cartesian_res``).
    The sensor resolutions enter as Python scalars: a constant tensor would
    be a host-to-device copy per call."""
    rr, tr, pr = res["r_res"], res["theta_res"], res["phi_res"]
    x, y, z = pc[..., 0], pc[..., 1], pc[..., 2]
    r = torch.sqrt(x * x + y * y + z * z)
    theta = torch.asin(z / r)
    phi = torch.atan2(y, x)
    cp, sp, ct, st = phi.cos(), phi.sin(), theta.cos(), theta.sin()
    x_res = (cp * ct).abs() * rr + (r * st * cp).abs() * tr \
        + (r * ct * sp).abs() * pr
    y_res = (sp * ct).abs() * rr + (r * sp * st).abs() * tr \
        + (r * ct * cp).abs() * pr
    z_res = st.abs() * rr + (r * ct).abs() * tr
    return torch.stack((x_res, y_res, z_res), dim=-1)


def frame_metrics(pc1: Tensor, pred_f: Tensor, labels: Tensor, mask: Tensor,
                  valid: Tensor, gt_trans: Tensor, pred_trans: Tensor,
                  pred_m: Tensor) -> Tensor:
    """Per-frame metric vector ``[B, 14]`` in METRIC_KEYS order, float32."""
    valid = valid.float()
    nv = valid.sum(1)

    error = torch.sqrt(((pred_f - labels) ** 2).sum(-1) + 1e-20)
    gtflow_len = torch.sqrt((labels * labels).sum(-1) + 1e-20)

    def fmean(x):
        return (x * valid).sum(1) / nv

    def rate(err, bar):
        return fmean(((err <= bar) | (err / gtflow_len <= bar)).float())

    epe = fmean(error)
    accs = rate(error, 0.05)
    accr = rate(error, 0.10)

    res_r = torch.sqrt(_cartesian_res(pc1, RADAR_RES).sum(-1) + 1e-20)
    res_l = torch.sqrt(_cartesian_res(pc1, LIDAR_RES).sum(-1) + 1e-20)
    re_error = error / (res_r / res_l)
    # padded points sit at the origin, where the ratio is nan
    re_error = torch.where(valid > 0, re_error, torch.zeros_like(re_error))

    is_mov = (mask == 0).float() * valid
    is_stat = (mask == 1).float() * valid
    rne = fmean(re_error)
    mov_rne = (re_error * is_mov).sum(1) / (is_mov.sum(1) + 1e-6)
    stat_rne = (re_error * is_stat).sum(1) / is_stat.sum(1)
    avg_rne = (mov_rne + stat_rne) / 2

    sas = rate(re_error, 0.10)
    ras = rate(re_error, 0.20)

    # motion segmentation (eval_util.py:99-112)
    pm = pred_m.float()
    tp = ((pm == 1).float() * (mask == 1).float() * valid).sum(1)
    tn = ((pm == 0).float() * (mask == 0).float() * valid).sum(1)
    fp = ((pm == 1).float() * (mask == 0).float() * valid).sum(1)
    fn = ((pm == 0).float() * (mask == 1).float() * valid).sum(1)
    acc = (tp + tn) / (tp + tn + fp + fn)
    sen = tp / (tp + fn + 1e-10)
    miou = 0.5 * (tp / (tp + fp + fn + 1e-10)
                  + tn / (tn + fp + fn + 1e-10))

    # RPE (odometry_util.py:34-142): rel = inv(gt) @ pred
    r_inv = gt_trans[:, :3, :3].transpose(1, 2)
    t_inv = -torch.einsum("bij,bj->bi", r_inv, gt_trans[:, :3, 3])
    rel_r = torch.einsum("bij,bjk->bik", r_inv, pred_trans[:, :3, :3])
    rel_t = torch.einsum("bij,bj->bi", r_inv, pred_trans[:, :3, 3]) + t_inv
    rte = torch.linalg.norm(rel_t, dim=1)
    skew = 0.5 * (rel_r - rel_r.transpose(1, 2))
    sin_n = torch.sqrt(skew[:, 2, 1] ** 2 + skew[:, 0, 2] ** 2
                       + skew[:, 1, 0] ** 2)
    cos_t = 0.5 * (rel_r.diagonal(dim1=1, dim2=2).sum(-1) - 1.0)
    rae = torch.atan2(sin_n, cos_t).abs() * (180.0 / math.pi)

    return torch.stack([rne, avg_rne, mov_rne, stat_rne, sas, ras, epe,
                        accs, accr, acc, miou, sen, rte, rae], dim=1)


def accumulate(sums: Tensor, count: Tensor, frame_vec: Tensor,
               keep: Tensor) -> Tuple[Tensor, Tensor]:
    """Fold a batch's per-frame metric vectors into running device sums.

    ``keep`` [B] masks padding lanes and empty frames; a dropped frame adds
    nothing, not even a nan.  Returns (new_sums [14], new_count [])."""
    vec = torch.where(keep[:, None], frame_vec, torch.zeros_like(frame_vec))
    return sums + vec.sum(0), count + keep.to(frame_vec.dtype).sum()
