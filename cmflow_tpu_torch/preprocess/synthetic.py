"""A synthetic raw View-of-Delft tree for the preprocessing path.

VoD cannot be downloaded, so the preprocessing runs on trees built here, as
``tests/test_preprocess.py`` builds one: a static world seen by a radar
that moves forward between frames, and one object (MOT track 7) with a
motion of its own, under VoD's radar->camera extrinsic.  Every clip of
``splits`` gets its own run of frames and a clip list; the train split gets
LiDAR-MOT pseudo labels per clip and camera images (the only images the
pipeline reads), val and test ground-truth labels.

    paths = write_raw_tree(root, SCENE_FLOW_SPLITS, frames_per_clip=4)
    run_preprocess(**paths, save_dir=out, opt_provider=...)
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from cmflow_tpu_torch.data.vod import (
    VOD_CAMERA_PROJECTION,
    VOD_T_CAMERA_RADAR,
)
from cmflow_tpu_torch.preprocess.vod_io import IMG_HEIGHT, IMG_WIDTH

EGO_FORWARD = 0.5  # radar-frame x translation of the ego between frames
OBJECT_MOTION = (1.0, 0.2, 0.0)  # the object's motion beyond the ego's
OBJECT_CENTER = (12.0, 1.0, 0.3)
LATERAL = 5.0  # half-width in metres of the band the points lie in

_CALIB = (
    "P0: dummy\nP1: dummy\n"
    "P2: {}\n"
    "R0_rect: 1 0 0 0 1 0 0 0 1\n"
    "Tr_imu: dummy\n"
    "Tr_velo_to_cam: {}\n"
)


def _write_calib(path: str, projection: np.ndarray,
                 extrinsic: np.ndarray) -> None:
    with open(path, "w") as f:
        f.write(_CALIB.format(
            " ".join(str(v) for v in projection.flatten()),
            " ".join(str(v) for v in extrinsic[:3].flatten())))


def _image(rng: np.random.RandomState, size: Tuple[int, int],
           shift: int) -> np.ndarray:
    """A blocky RGB texture, moved ``shift`` pixels left."""
    h, w = size
    base = rng.randint(0, 255, (h // 8 + 1, w // 8 + 1, 3)).astype(np.uint8)
    tex = base.repeat(8, 0).repeat(8, 1)[:h, :w]
    return np.roll(tex, -shift, axis=1)


def write_raw_tree(
    root: str,
    splits: Dict[str, Sequence[str]],
    frames_per_clip: int = 3,
    n_points: int = 120,
    image_size: Tuple[int, int] = (IMG_HEIGHT, IMG_WIDTH),
    projection: Optional[np.ndarray] = None,
    seed: int = 0,
) -> Dict[str, str]:
    """Write the tree under ``root``; returns ``run_preprocess``'s paths
    (``root_dir``, ``clips_dir``, ``pseudo_label_path``,
    ``true_label_path``).

    Args:
      splits: ``{split: [clip, ...]}``; a split named ``train`` is the one
        that gets images and pseudo labels.
      n_points: radar points a frame, 15 of them on the object.
      image_size: ``(H, W)`` of the camera images.
      projection: the 3x4 camera projection (VoD's by default); a smaller
        focal length and principal point keep the projections inside a
        smaller image.
    """
    raw = os.path.join(root, "raw")
    dirs = {k: os.path.join(raw, *k.split("/")) for k in (
        "radar/training/velodyne", "radar/training/calib",
        "radar/training/pose", "lidar/training/velodyne",
        "lidar/training/calib", "lidar/training/image_2",
        "lidar/training/label_2")}
    for d in dirs.values():
        os.makedirs(d, exist_ok=True)
    clips_dir = os.path.join(root, "clips")
    pseudo_dir = os.path.join(root, "mot_labels")
    os.makedirs(clips_dir, exist_ok=True)

    proj = (VOD_CAMERA_PROJECTION if projection is None
            else np.asarray(projection)).astype(np.float64)
    t_cam_radar = VOD_T_CAMERA_RADAR.astype(np.float64)
    rng = np.random.RandomState(seed)
    next_frame = 0
    for split, clips in splits.items():
        for clip in clips:
            frames: List[str] = []
            world = np.stack([rng.uniform(5, 30, n_points),
                              rng.uniform(-LATERAL, LATERAL, n_points),
                              rng.uniform(-0.5, 1.5, n_points)], 1)
            world[:15] = (np.array(OBJECT_CENTER)
                          + rng.uniform(-0.8, 0.8, (15, 3)) * [1.5, 0.6, 0.4])
            texture_seed = rng.randint(2 ** 31)
            for k in range(frames_per_clip):
                fid = str(next_frame).zfill(5)
                next_frame += 1
                frames.append(fid)
                ego = np.array([k * EGO_FORWARD, 0.0, 0.0])
                pts = world - ego
                pts[:15] += k * np.array(OBJECT_MOTION)
                cols = np.zeros((n_points, 7), np.float32)
                cols[:, :3] = pts
                cols[:, 3] = rng.uniform(-10, 5, n_points)  # RCS
                cols.tofile(os.path.join(dirs["radar/training/velodyne"],
                                         f"{fid}.bin"))
                for d in ("radar/training/calib", "lidar/training/calib"):
                    # the lidar co-located with the radar
                    _write_calib(os.path.join(dirs[d], f"{fid}.txt"), proj,
                                 t_cam_radar)
                odom_radar = np.eye(4)
                odom_radar[:3, 3] = ego
                # odom_radar = odom_camera @ camera_radar
                t_oc = odom_radar @ np.linalg.inv(t_cam_radar)
                with open(os.path.join(dirs["radar/training/pose"],
                                       f"{fid}.json"), "w") as f:
                    f.write(json.dumps(
                        {"odomToCamera": t_oc.flatten().tolist()}) + "\n")
                # the object's box in camera coordinates, track 7
                # (16-column KITTI-track line)
                center = (np.array(OBJECT_CENTER) - ego
                          + k * np.array(OBJECT_MOTION))
                cam = t_cam_radar @ np.array([*center, 1.0])
                line = (f"Car 7 0 0 0 0 0 0 1.5 2.0 4.0 "
                        f"{cam[0]} {cam[1]} {cam[2]} 0.0 0.8\n")
                if split == "train":
                    label_dir = os.path.join(pseudo_dir, clip)
                    os.makedirs(label_dir, exist_ok=True)
                    _write_jpeg(
                        os.path.join(dirs["lidar/training/image_2"],
                                     f"{fid}.jpg"),
                        _image(np.random.RandomState(texture_seed),
                               image_size, 4 * k))
                else:
                    label_dir = dirs["lidar/training/label_2"]
                with open(os.path.join(label_dir, f"{fid}.txt"), "w") as f:
                    f.write(line)
            with open(os.path.join(clips_dir, f"{clip}.txt"), "w") as f:
                f.write("\n".join(frames) + "\n")
    return dict(root_dir=raw, clips_dir=clips_dir,
                pseudo_label_path=pseudo_dir,
                true_label_path=dirs["lidar/training/label_2"])


def _write_jpeg(path: str, rgb: np.ndarray) -> None:
    from PIL import Image

    Image.fromarray(rgb).save(path, quality=95)
