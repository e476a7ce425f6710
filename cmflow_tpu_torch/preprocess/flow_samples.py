"""Scene-flow sample builder: raw VoD frames -> on-disk ujson samples (a copy
of ``cmflow_tpu/preprocess/flow_samples.py``; the reference's
preprocess/utils/get_flow_samples.py without open3d or cv2).

Fixes over the reference pipeline (documented deviations):
  * the optical-flow model is initialized once per run, not once per frame
    pair (reference re-inits RAFT in every ``get_one_sample`` call,
    get_flow_samples.py:46);
  * optical flow is a pluggable provider (see optical_flow.py) so the
    camera modality can be swapped or disabled.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional

import numpy as np

from cmflow_tpu_torch.preprocess import boxes as boxlib
from cmflow_tpu_torch.preprocess import vod_io


def rigid_flow_from_ego(pc: np.ndarray, radar1_radar2: np.ndarray) -> np.ndarray:
    """Rigid (ego-induced) flow: static points move by the *inverse* of the
    radar1->radar2 pose (get_rigid_flow, get_flow_samples.py:221-230)."""
    h = np.concatenate([pc[:, 0:3], np.ones((len(pc), 1))], axis=1)
    moved = h @ np.linalg.inv(radar1_radar2).T
    return moved[:, :3] - pc[:, 0:3]


def ego_transform(tf1: vod_io.FrameTransforms,
                  tf2: vod_io.FrameTransforms) -> np.ndarray:
    """radar1 -> radar2 transform via the odometry chain
    (get_flow_samples.py:82-89)."""
    odom_radar_1 = tf1.t_odom_camera @ tf1.t_camera_radar
    odom_radar_2 = tf2.t_odom_camera @ tf2.t_camera_radar
    return np.linalg.inv(odom_radar_1) @ odom_radar_2


def build_sample(
    frame1: str,
    frame2: str,
    locations: vod_io.VodLocations,
    label_path: str,
    mode: str,
    opt_provider=None,
    height_range=(-3.0, 3.0),
) -> Optional[Dict]:
    """Assemble one frame-pair sample dict (get_one_sample,
    get_flow_samples.py:44-175).  Returns None if a frame has no points."""
    data1 = vod_io.VodFrame(locations, frame1)
    data2 = vod_io.VodFrame(locations, frame2)
    tf1 = vod_io.FrameTransforms(locations, frame1)
    tf2 = vod_io.FrameTransforms(locations, frame2)

    radar1 = data1.radar_data[:, 0:5]
    radar2 = data2.radar_data[:, 0:5]
    proj = tf1.camera_projection_matrix
    radar1 = radar1[vod_io.filt_points_in_fov(radar1, tf1.t_camera_radar,
                                              proj)]
    radar2 = radar2[vod_io.filt_points_in_fov(
        radar2, tf2.t_camera_radar, tf2.camera_projection_matrix)]
    radar1 = radar1[vod_io.filt_points_by_height(radar1, *height_range)]
    radar2 = radar2[vod_io.filt_points_by_height(radar2, *height_range)]
    if radar1.shape[0] == 0 or radar2.shape[0] == 0:
        return None

    radar1_radar2 = ego_transform(tf1, tf2)

    # camera modality (train only, get_flow_samples.py:91-102).  Train
    # samples must always carry per-point opt_info (the train-mode reader
    # indexes it, data/vod.py); without a provider the flow targets are
    # zero — the camera modality is simply uninformative, not unreadable.
    if mode == "train":
        h = np.concatenate(
            [radar1[:, 0:3], np.ones((len(radar1), 1))], axis=1)
        cam = vod_io.homogeneous_transformation(h, tf1.t_camera_radar)
        uvs = vod_io.project_3d_to_2d(cam, proj)
        if opt_provider is not None:
            flow_img = opt_provider(data1.image, data2.image)
            radar_opt = flow_img[uvs[:, 1] - 1, uvs[:, 0] - 1]
        else:
            radar_opt = np.zeros((len(radar1), 2), np.float32)
        opt_info = {
            "radar_u": uvs[:, 0].astype(float).tolist(),
            "radar_v": uvs[:, 1].astype(float).tolist(),
            "opt_flow": radar_opt.astype(float).tolist(),
        }
    else:
        opt_info = {"radar_u": [], "radar_v": [], "opt_flow": []}

    # LiDAR-MOT (train) or gt (val/test) track labels
    lbl_dir = label_path
    labels1 = boxlib.load_track_labels(lbl_dir, frame1)
    labels2 = boxlib.load_track_labels(lbl_dir, frame2)
    fg_idx, fg_confs, fg_labels, _ = boxlib.extract_fg_labels(
        labels1, labels2, radar1, tf1.t_radar_camera,
        tf1.t_radar_lidar[:3, :3])

    n = radar1.shape[0]
    gt_mask = np.zeros(n, np.float32)
    gt_labels = np.zeros((n, 3), np.float32)
    pse_mask = np.zeros(n, np.float32)
    pse_labels = np.zeros((n, 3), np.float32)

    if mode in ("test", "val"):
        # gt composition (get_flow_samples.py:117-135)
        flow_r = rigid_flow_from_ego(radar1, radar1_radar2)
        flow_nr = fg_labels[fg_idx] - flow_r[fg_idx] if fg_idx else \
            np.zeros((0, 3))
        mov_idx = (np.array(fg_idx)[np.linalg.norm(flow_nr, axis=1) > 0.05]
                   if fg_idx else np.array([], int))
        stat_idx = (np.delete(np.arange(n), mov_idx) if len(mov_idx)
                    else np.arange(n))
        gt_mask[stat_idx] = 1
        gt_labels[stat_idx] = flow_r[stat_idx]
        if len(mov_idx):
            gt_labels[mov_idx] = fg_labels[mov_idx]
            gt_mask[mov_idx] = 1 - fg_confs[mov_idx]
    else:
        # pseudo supervision (get_flow_samples.py:139-148)
        bg_idx = (np.delete(np.arange(n), fg_idx) if fg_idx
                  else np.arange(n))
        pse_mask[bg_idx] = 1
        if fg_idx:
            pse_labels[fg_idx] = fg_labels[fg_idx]
            pse_mask[fg_idx] = 1 - fg_confs[fg_idx]

    return {
        "pc1": radar1.astype(float).tolist(),
        "pc2": radar2.astype(float).tolist(),
        "trans": radar1_radar2.astype(float).tolist(),
        "opt_info": opt_info,
        "gt_mask": gt_mask.astype(float).tolist(),
        "gt_labels": gt_labels.astype(float).tolist(),
        "pse_mask": pse_mask.astype(float).tolist(),
        "pse_labels": pse_labels.astype(float).tolist(),
    }


def process_clip(
    locations: vod_io.VodLocations,
    frames,
    save_dir: str,
    clip: str,
    split: str,
    label_path: str,
    mode: str,
    opt_provider=None,
    log=print,
) -> int:
    """Write samples for all consecutive pairs of a clip
    (get_radar_flow_samples, get_flow_samples.py:26-41)."""
    out_dir = os.path.join(save_dir, split, clip)
    os.makedirs(out_dir, exist_ok=True)
    lbl = os.path.join(label_path, clip) if mode == "train" else label_path
    written = 0
    for f1, f2 in zip(frames[:-1], frames[1:]):
        sample = build_sample(f1, f2, locations, lbl, mode, opt_provider)
        if sample is None:
            continue
        with open(os.path.join(out_dir, f"{f1}_{f2}.json"), "w") as fo:
            json.dump(sample, fo)
        written += 1
    log(f"{clip} [{split}]: {written} samples")
    return written


# VoD scene-flow split (preprocess/scene_flow_split_info.yaml:5-9) — the
# clip partition used by the paper's released preprocessing config.
SCENE_FLOW_SPLITS = {
    "train": ["delft_2", "delft_3", "delft_7", "delft_8", "delft_9",
              "delft_11", "delft_13", "delft_16", "delft_18", "delft_20",
              "delft_21", "delft_25", "delft_27"],
    "val": ["delft_1", "delft_10", "delft_14", "delft_22"],
    "test": ["delft_4", "delft_6", "delft_12", "delft_19", "delft_23",
             "delft_24", "delft_26"],
}


def run_preprocess(
    root_dir: str,
    save_dir: str,
    clips_dir: str,
    pseudo_label_path: str,
    true_label_path: str,
    splits: Optional[Dict] = None,
    opt_provider=None,
    log=print,
) -> None:
    """Full offline pipeline (preprocess/preprocess_vod.py:17-49)."""
    splits = splits or SCENE_FLOW_SPLITS
    loc = vod_io.VodLocations(root_dir=root_dir)
    smp_path = os.path.join(save_dir, "flow_smp")
    for split, clips in splits.items():
        mode = "train" if split == "train" else split
        label_path = pseudo_label_path if mode == "train" else true_label_path
        for clip in clips:
            frames = vod_io.get_frame_list(
                os.path.join(clips_dir, f"{clip}.txt"))
            process_clip(loc, frames, smp_path, clip, split, label_path,
                         mode, opt_provider if mode == "train" else None,
                         log=log)
