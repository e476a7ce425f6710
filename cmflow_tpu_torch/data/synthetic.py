"""Synthetic radar scene-flow scene generator (``make_scene`` and
``write_synthetic_dataset`` of ``cmflow_tpu/data/synthetic.py``, copied);
``make_request``, which batches its scenes into one served request, and
``make_train_batch``, which batches them into one training batch.

Produces physically consistent frame pairs in the exact on-disk ujson
schema of the reference preprocessing output
(preprocess/utils/get_flow_samples.py:162-175), so the same reader,
training step, losses and metrics run end-to-end without the (multi-GB,
license-gated) View-of-Delft download:

  * a rigid ego transform moves all static points;
  * a few moving clusters get extra rigid motions of their own;
  * Doppler v_r is derived from the true per-point displacement projected
    on the line of sight (divided by the frame interval);
  * optical-flow labels are exact reprojections through the VoD camera
    calibration;
  * gt/pseudo masks and flow labels follow the preprocess conventions
    (1 = static/background, 0 = moving/foreground).
"""

from __future__ import annotations

import json
import os
from typing import Dict

import numpy as np
from scipy.spatial.transform import Rotation

from cmflow_tpu_torch.data import schema
from cmflow_tpu_torch.data.vod import (
    VOD_CAMERA_PROJECTION,
    VOD_INTERVAL,
    VOD_T_CAMERA_RADAR,
    decode_sample,
)


def _random_rigid(rng: np.random.Generator, rot_deg: float,
                  trans_m: float) -> np.ndarray:
    t = np.eye(4)
    t[:3, :3] = Rotation.from_euler(
        "zyx", rng.uniform(-rot_deg, rot_deg, 3), degrees=True
    ).as_matrix()
    t[:3, 3] = rng.uniform(-trans_m, trans_m, 3)
    return t


def make_scene(
    rng: np.random.Generator,
    n1: int = 256,
    n2: int = 256,
    num_moving_clusters: int = 2,
    moving_fraction: float = 0.25,
    ego_rot_deg: float = 1.0,
    ego_trans_m: float = 0.5,
    object_speed_m: float = 0.4,
    noise: float = 0.0,
) -> Dict:
    """Generate one frame pair in the raw preprocess-output schema."""
    n = max(n1, n2)
    # radar-like geometry: points in front of the sensor, tens of meters out
    pts = np.stack([
        rng.uniform(2.0, 40.0, n),
        rng.uniform(-15.0, 15.0, n),
        rng.uniform(-1.0, 3.0, n),
    ], axis=1)

    # ego motion: static world points move by T_ego (radar1 -> radar2)
    t_ego = _random_rigid(rng, ego_rot_deg, ego_trans_m)

    # moving objects: contiguous clusters with their own extra motion
    moving = np.zeros(n, bool)
    flow = pts @ t_ego[:3, :3].T + t_ego[:3, 3] - pts
    n_mov = int(n * moving_fraction)
    if num_moving_clusters > 0 and n_mov > 0:
        per = n_mov // num_moving_clusters
        for c in range(num_moving_clusters):
            center = np.array([
                rng.uniform(5, 30), rng.uniform(-10, 10), rng.uniform(0, 1)])
            sl = slice(c * per, (c + 1) * per)
            pts[sl] = center + rng.normal(0, 1.0, (per, 3))
            moving[sl] = True
            obj_motion = rng.normal(0, object_speed_m, 3)
            flow[sl] = (pts[sl] @ t_ego[:3, :3].T + t_ego[:3, 3] - pts[sl]
                        + obj_motion)

    warped = pts + flow

    # Doppler radial velocity: displacement projected on line of sight / dt
    unit1 = pts / np.linalg.norm(pts, axis=1, keepdims=True)
    v_r = np.sum(flow * unit1, axis=1) / VOD_INTERVAL
    if noise > 0:
        v_r = v_r + rng.normal(0, noise, n)
    rcs = rng.uniform(-20.0, 10.0, n)

    # 7-column radar format [x,y,z,RCS,v_r,v_r_comp,time]
    # (vod devkit frame/data_loader.py:69-86)
    def radar_cols(xyz, rcs_, vr_):
        z = np.zeros(len(xyz))
        return np.concatenate(
            [xyz, rcs_[:, None], vr_[:, None], vr_[:, None], z[:, None]],
            axis=1)

    pc1 = radar_cols(pts, rcs, v_r)[:n1]
    # frame 2 = warped frame-1 points (subsampled to n2) + fresh noise pts
    perm = rng.permutation(n)[:n2]
    pts2 = warped[perm]
    v_r2 = v_r[perm]  # not used in losses for frame 2 beyond features
    pc2 = radar_cols(pts2, rcs[perm], v_r2)

    # optical-flow labels: exact reprojection through the camera
    def project(p):
        h = np.concatenate([p, np.ones((len(p), 1))], 1)
        cam = h @ VOD_T_CAMERA_RADAR.T
        uvz = cam @ VOD_CAMERA_PROJECTION.T
        return uvz[:, :2] / uvz[:, 2:3]

    uv1 = project(pts[:n1])
    uv2 = project(warped[:n1])
    opt_flow = uv2 - uv1

    # masks/labels, preprocess conventions (get_flow_samples.py:117-148):
    # gt_mask 1=static 0=moving; pse_mask 1=background 0=foreground
    gt_mask = (~moving[:n1]).astype(float)
    pse_mask = gt_mask.copy()
    labels = flow[:n1]

    # stored trans is the pose whose INVERSE maps static pc1 into frame 2
    # (dataset/vod.py:90)
    stored_trans = np.linalg.inv(t_ego)

    return {
        "pc1": pc1.tolist(),
        "pc2": pc2.tolist(),
        "trans": stored_trans.tolist(),
        "gt_mask": gt_mask.tolist(),
        "gt_labels": labels.tolist(),
        "pse_mask": pse_mask.tolist(),
        "pse_labels": labels.tolist(),
        "opt_info": {
            "opt_flow": opt_flow.tolist(),
            "radar_u": uv1[:, 0].tolist(),
            "radar_v": uv1[:, 1].tolist(),
        },
    }


def write_synthetic_dataset(
    root: str,
    partitions: Dict[str, int],
    clips_per_partition: int = 2,
    seed: int = 0,
    n_range=(200, 320),
    **scene_kwargs,
) -> None:
    """Materialize a synthetic dataset tree mirroring the VoD layout:
    ``<root>/<partition>/delft_<i>/<j>_<j+1>.json``."""
    rng = np.random.default_rng(seed)
    for partition, n_samples in partitions.items():
        per_clip = max(1, n_samples // clips_per_partition)
        idx = 0
        for c in range(clips_per_partition):
            clip_dir = os.path.join(root, partition, f"delft_{c + 1}")
            os.makedirs(clip_dir, exist_ok=True)
            for j in range(per_clip):
                n1 = int(rng.integers(*n_range))
                n2 = int(rng.integers(*n_range))
                scene = make_scene(rng, n1=n1, n2=n2, **scene_kwargs)
                path = os.path.join(clip_dir, f"{idx:05d}_{idx + 1:05d}.json")
                with open(path, "w") as f:
                    json.dump(scene, f)
                idx += 1


def make_request(seed: int, batch: int, n_range) -> Dict:
    """One served request: ``batch`` scenes whose frames hold a number of
    points drawn from ``[n_range[0], n_range[1])``, decoded as the val split,
    padded to their common bucket and collated."""
    rng = np.random.default_rng(seed)
    samples = []
    for _ in range(batch):
        n1, n2 = (int(x) for x in rng.integers(*n_range, size=2))
        samples.append(decode_sample(make_scene(rng, n1=n1, n2=n2), "val",
                                     eval_mode=True, num_points=256))
    bucket = schema.bucket_size(max(max(s["pc1"].shape[0], s["pc2"].shape[0])
                                    for s in samples))
    return schema.collate([schema.pad_to(s, bucket) for s in samples])


def make_train_batch(seed: int, batch: int, num_points: int) -> Dict:
    """One training batch: ``batch`` scenes of ``num_points + 16`` points
    per frame (as the JAX package's train tests draw them), decoded as the
    train split (pseudo labels, optical flow, exactly ``num_points`` per
    cloud) and stacked, without valid masks."""
    rng = np.random.default_rng(seed)
    n = num_points + 16
    samples = [decode_sample(make_scene(rng, n1=n, n2=n, moving_fraction=0.25),
                             "train", eval_mode=False, num_points=num_points,
                             rng=rng)
               for _ in range(batch)]
    return {k: np.stack([s[k] for s in samples]) for k in samples[0]
            if k not in ("valid1", "valid2")}
