"""Evaluation metrics (host-side numpy) — utils/eval_util.py equivalents.
A copy of ``cmflow_tpu/evaluation/metrics.py``.

Scene-flow metrics: EPE, AccS/AccR, and the radar-specific
Resolution-Normalized Error (RNE) family, where per-point errors are
normalized by the ratio of radar to LiDAR Cartesian resolution at that
point's range/bearing (utils/eval_util.py:4-82).
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from cmflow_tpu_torch.evaluation import odometry

# HDL-64E LiDAR resolution constants (utils/eval_util.py:12-15)
LIDAR_RES = {
    "r_res": 0.04,
    "theta_res": 0.4 * np.pi / 180,
    "phi_res": 0.08 * np.pi / 180,
}

# VoD LRR30 radar resolution (dataset/vod.py:21-24)
RADAR_RES = {
    "r_res": 0.2,
    "theta_res": 1.5 * np.pi / 180,
    "phi_res": 1.5 * np.pi / 180,
}


def cartesian_res(pc: np.ndarray, res: Dict[str, float]) -> np.ndarray:
    """Per-point xyz measurement resolution from (r, theta, phi) sensor
    resolution (utils/eval_util.py:4-40).

    Args:
      pc: ``[B, N, 3]``.
      res: dict with r_res/theta_res/phi_res.
    Returns:
      ``[B, N, 3]`` xyz resolutions.
    """
    rv = np.array([res["r_res"], res["theta_res"], res["phi_res"]])
    x, y, z = pc[..., 0], pc[..., 1], pc[..., 2]
    r = np.sqrt(x**2 + y**2 + z**2)
    theta = np.arcsin(z / r)
    phi = np.arctan2(y, x)

    grad_x = np.stack(
        (np.cos(phi) * np.cos(theta), -r * np.sin(theta) * np.cos(phi),
         -r * np.cos(theta) * np.sin(phi)), axis=-1)
    grad_y = np.stack(
        (np.sin(phi) * np.cos(theta), -r * np.sin(phi) * np.sin(theta),
         r * np.cos(theta) * np.cos(phi)), axis=-1)
    grad_z = np.stack(
        (np.sin(theta), r * np.cos(theta), np.zeros_like(r)), axis=-1)

    x_res = np.sum(np.abs(grad_x) * rv, axis=-1)
    y_res = np.sum(np.abs(grad_y) * rv, axis=-1)
    z_res = np.sum(np.abs(grad_z) * rv, axis=-1)
    return np.stack((x_res, y_res, z_res), axis=-1)


def eval_scene_flow(
    pc: np.ndarray,
    pred: np.ndarray,
    labels: np.ndarray,
    mask: np.ndarray,
    radar_res: Dict[str, float] = RADAR_RES,
) -> Dict[str, float]:
    """Scene-flow metric battery (utils/eval_util.py:42-82).

    Args:
      pc: ``[B, N, 3]`` frame-1 points.
      pred: ``[B, N, 3]`` predicted flow.
      labels: ``[B, N, 3]`` gt flow.
      mask: ``[B, N]`` gt motion-seg mask (1 = static).
    """
    pc = np.asarray(pc, np.float64)
    pred = np.asarray(pred, np.float64)
    labels = np.asarray(labels, np.float64)
    mask = np.asarray(mask)

    error = np.sqrt(np.sum((pred - labels) ** 2, -1) + 1e-20)
    gtflow_len = np.sqrt(np.sum(labels * labels, -1) + 1e-20)

    epe = float(np.mean(error))
    npts = error.size
    accs = float(np.sum(
        np.logical_or(error <= 0.05, error / gtflow_len <= 0.05)) / npts)
    accr = float(np.sum(
        np.logical_or(error <= 0.10, error / gtflow_len <= 0.10)) / npts)

    res_r = np.sqrt(np.sum(cartesian_res(pc, radar_res), -1) + 1e-20)
    res_l = np.sqrt(np.sum(cartesian_res(pc, LIDAR_RES), -1) + 1e-20)

    re_error = error / (res_r / res_l)
    rne = float(np.mean(re_error))
    mov_rne = float(np.sum(re_error[mask == 0]) / (np.sum(mask == 0) + 1e-6))
    stat_rne = float(np.mean(re_error[mask == 1]))
    avg_rne = (mov_rne + stat_rne) / 2

    sas = float(np.sum(
        np.logical_or(re_error <= 0.10, re_error / gtflow_len <= 0.10)) / npts)
    ras = float(np.sum(
        np.logical_or(re_error <= 0.20, re_error / gtflow_len <= 0.20)) / npts)

    return {
        "rne": rne, "50-50 rne": avg_rne, "mov_rne": mov_rne,
        "stat_rne": stat_rne, "sas": sas, "ras": ras, "epe": epe,
        "accs": accs, "accr": accr,
    }


def eval_scene_flow_batch(
    pc: np.ndarray,
    pred: np.ndarray,
    labels: np.ndarray,
    mask: np.ndarray,
    valid: np.ndarray,
    radar_res: Dict[str, float] = RADAR_RES,
) -> Dict[str, np.ndarray]:
    """Vectorized per-frame scene-flow metrics over a PADDED batch.

    Returns a dict of ``[B]`` arrays whose entries equal
    ``eval_scene_flow(x[i:i+1, :nv_i])`` exactly (tested) — the epoch
    metric is the mean of per-frame metrics, so frames stay independent.
    One vectorized call per batch replaces a python call per frame.
    """
    pc = np.asarray(pc, np.float64)
    pred = np.asarray(pred, np.float64)
    labels = np.asarray(labels, np.float64)
    mask = np.asarray(mask)
    valid = np.asarray(valid, bool)
    nv = valid.sum(1)  # caller excludes nv == 0 frames

    error = np.sqrt(np.sum((pred - labels) ** 2, -1) + 1e-20)
    gtflow_len = np.sqrt(np.sum(labels * labels, -1) + 1e-20)

    def fmean(x):  # per-frame mean over valid points
        return np.sum(x * valid, 1) / nv

    epe = fmean(error)
    accs = fmean(np.logical_or(error <= 0.05, error / gtflow_len <= 0.05))
    accr = fmean(np.logical_or(error <= 0.10, error / gtflow_len <= 0.10))

    with np.errstate(invalid="ignore", divide="ignore"):
        res_r = np.sqrt(np.sum(cartesian_res(pc, radar_res), -1) + 1e-20)
        res_l = np.sqrt(np.sum(cartesian_res(pc, LIDAR_RES), -1) + 1e-20)
        re_error = error / (res_r / res_l)
    # padded points sit at the origin where r = 0 makes the resolution
    # ratio nan; they are excluded from every sum below
    re_error = np.where(valid, re_error, 0.0)

    is_mov = np.logical_and(mask == 0, valid)
    is_stat = np.logical_and(mask == 1, valid)
    rne = fmean(re_error)
    mov_rne = np.sum(re_error * is_mov, 1) / (is_mov.sum(1) + 1e-6)
    with np.errstate(invalid="ignore"):
        # a frame with zero static points is nan, like np.mean([])
        stat_rne = np.sum(re_error * is_stat, 1) / is_stat.sum(1)
    avg_rne = (mov_rne + stat_rne) / 2

    sas = fmean(np.logical_or(re_error <= 0.10,
                              re_error / gtflow_len <= 0.10))
    ras = fmean(np.logical_or(re_error <= 0.20,
                              re_error / gtflow_len <= 0.20))

    return {
        "rne": rne, "50-50 rne": avg_rne, "mov_rne": mov_rne,
        "stat_rne": stat_rne, "sas": sas, "ras": ras, "epe": epe,
        "accs": accs, "accr": accr,
    }


def eval_motion_seg_batch(pre: np.ndarray, gt: np.ndarray,
                          valid: np.ndarray) -> Dict[str, np.ndarray]:
    """Vectorized per-frame motion-seg metrics over a padded batch
    (per-frame values identical to :func:`eval_motion_seg`)."""
    pre = np.asarray(pre)
    gt = np.asarray(gt)
    valid = np.asarray(valid, bool)
    tp = (np.logical_and(pre == 1, gt == 1) & valid).sum(1)
    tn = (np.logical_and(pre == 0, gt == 0) & valid).sum(1)
    fp = (np.logical_and(pre == 1, gt == 0) & valid).sum(1)
    fn = (np.logical_and(pre == 0, gt == 1) & valid).sum(1)
    acc = (tp + tn) / (tp + tn + fp + fn)
    sen = tp / (tp + fn + 1e-10)
    miou = 0.5 * (tp / (tp + fp + fn + 1e-10) + tn / (tn + fp + fn + 1e-10))
    return {"acc": acc, "miou": miou, "sen": sen}


def eval_trans_rpe_batch(gt_trans: np.ndarray,
                         rigid_trans: np.ndarray) -> Dict[str, np.ndarray]:
    """Vectorized per-frame relative pose errors (``[B]`` arrays matching
    :func:`eval_trans_rpe` on each frame)."""
    from scipy.spatial.transform import Rotation

    gt = np.asarray(gt_trans, np.float64)
    pred = np.asarray(rigid_trans, np.float64)
    r_inv = np.swapaxes(gt[:, :3, :3], 1, 2)
    t_inv = -np.einsum("bij,bj->bi", r_inv, gt[:, :3, 3])
    rel_r = np.einsum("bij,bjk->bik", r_inv, pred[:, :3, :3])
    rel_t = np.einsum("bij,bj->bi", r_inv, pred[:, :3, 3]) + t_inv
    rte = np.linalg.norm(rel_t, axis=1)
    rotvec = Rotation.from_matrix(rel_r).as_rotvec()
    rae = np.abs(np.linalg.norm(rotvec, axis=1)) * 180 / np.pi
    return {"RTE": rte, "RAE": rae}


def eval_trans_rpe(gt_trans: np.ndarray,
                   rigid_trans: np.ndarray) -> Dict[str, float]:
    """Relative pose error of the predicted ego transforms
    (utils/eval_util.py:85-97)."""
    errors = odometry.calculate_rpe_vector(
        np.asarray(gt_trans, np.float64), np.asarray(rigid_trans, np.float64))
    trans_err = odometry.calc_rpe_error(errors, "translation_part")
    angle_err = odometry.calc_rpe_error(errors, "rotation_angle_deg")
    return {
        "RTE": float(np.mean(trans_err)),
        "RAE": float(np.mean(angle_err)),
    }


def eval_motion_seg(pre: np.ndarray, gt: np.ndarray) -> Dict[str, float]:
    """Motion-segmentation accuracy / mIoU / sensitivity
    (utils/eval_util.py:99-112)."""
    pre = np.asarray(pre)
    gt = np.asarray(gt)
    tp = np.logical_and(pre == 1, gt == 1).sum()
    tn = np.logical_and(pre == 0, gt == 0).sum()
    fp = np.logical_and(pre == 1, gt == 0).sum()
    fn = np.logical_and(pre == 0, gt == 1).sum()
    acc = (tp + tn) / (tp + tn + fp + fn)
    sen = tp / (tp + fn + 1e-10)
    miou = 0.5 * (tp / (tp + fp + fn + 1e-10) + tn / (tn + fp + fn + 1e-10))
    return {"acc": float(acc), "miou": float(miou), "sen": float(sen)}
