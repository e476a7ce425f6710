"""View-of-Delft preprocessed scene-flow dataset readers (a copy of
``cmflow_tpu/data/vod.py``): ``VodDataset`` for frame pairs and
``VodClipDataset`` for CMFlow_T's mini-clips.

Reads ``<root>/<partition>/<clip>/<i>_<j>.json``; only clips named
``delft_*`` contribute samples (vod.py:43-44).  The samples are read with
the C++ sample codec (``native/codec.py``), as the JAX package's default
reader reads them: it parses straight to float32, so ``trans`` is inverted
in float32 and the batches are that reader's bit for bit.  A file the codec
rejects is read with Python's ``json``, as there.

A raw sample is the ujson dict written by the reference's preprocessing
(preprocess/utils/get_flow_samples.py:162-175): features are columns
[4, 3, 3] of the 7-column radar points (v_r, RCS, RCS); val/test use gt
labels and mask, train uses pseudo labels, mask and optical-flow info;
``trans`` is the inverse of the stored odometry transform; training draws
exactly ``num_points`` per cloud, eval keeps full clouds.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

import numpy as np

from cmflow_tpu_torch.data.schema import Sample
from cmflow_tpu_torch.native import codec

# VoD radar sensor resolution (dataset/vod.py:21-24)
VOD_RADAR_RES = {
    "r_res": 0.2,
    "theta_res": 1.5 * np.pi / 180,
    "phi_res": 1.5 * np.pi / 180,
}

# VoD radar->camera calibration (dataset/vod_radar_calib.txt — dataset
# metadata, not code): camera projection P and extrinsic radar->camera.
VOD_CAMERA_PROJECTION = np.array(
    [[1495.468642, 0.0, 961.272442, 0.0],
     [0.0, 1495.468642, 624.89592, 0.0],
     [0.0, 0.0, 1.0, 0.0]], dtype=np.float32)

VOD_T_CAMERA_RADAR = np.array(
    [[-0.013857, -0.9997468, 0.01772762, 0.05283124],
     [0.10934269, -0.01913807, -0.99381983, 0.98100483],
     [0.99390751, -0.01183297, 0.1095802, 1.44445002],
     [0.0, 0.0, 0.0, 1.0]], dtype=np.float32)

VOD_INTERVAL = 0.10  # seconds between frames (dataset/vod.py:29)


def _list_clips(root: str) -> List[str]:
    """Clip directories in numeric order, skipping entries that are not
    ``name_N`` directories (a stray file or oddly named dir must not crash
    listing — dataset/vod.py:38 sorts blindly and would)."""
    clips = []
    for entry in os.listdir(root):
        if not os.path.isdir(os.path.join(root, entry)):
            continue
        parts = entry.split("_")
        if len(parts) < 2 or not parts[-1].isdigit():
            continue
        clips.append(entry)
    return sorted(clips, key=lambda x: int(x.split("_")[-1]))


def _list_samples(clip_path: str) -> List[str]:
    names = sorted(
        os.listdir(clip_path),
        key=lambda x: int(x.split("/")[-1].split("_")[0]),
    )
    return [os.path.join(clip_path, n) for n in names]


def load_sample_file(path: str) -> Dict:
    """Load a raw sample json through the C++ codec; a file it rejects
    through Python's ``json``."""
    parsed = codec.parse_sample_file(path)
    if parsed is not None:
        return parsed
    with open(path, "rb") as f:
        return json.load(f)


def decode_sample(
    data: Dict, partition: str, *, eval_mode: bool, num_points: int,
    rng: Optional[np.random.Generator] = None,
) -> Sample:
    """Turn one raw ujson dict into a Sample (dataset/vod.py:49-124)."""
    data_1 = np.asarray(data["pc1"], np.float32)
    data_2 = np.asarray(data["pc2"], np.float32)

    pos_1 = data_1[:, 0:3]
    pos_2 = data_2[:, 0:3]
    feature_1 = data_1[:, [4, 3, 3]]
    feature_2 = data_2[:, [4, 3, 3]]

    if partition in ("test", "val", "train_anno"):
        labels = np.asarray(data["gt_labels"], np.float32)
        mask = np.asarray(data["gt_mask"], np.float32)
        opt_flow = np.zeros((pos_1.shape[0], 2), np.float32)
        radar_u = np.zeros(pos_1.shape[0], np.float32)
        radar_v = np.zeros(pos_1.shape[0], np.float32)
    else:
        labels = np.asarray(data["pse_labels"], np.float32)
        mask = np.asarray(data["pse_mask"], np.float32)
        opt_info = data["opt_info"]
        opt_flow = np.asarray(opt_info["opt_flow"], np.float32)
        radar_u = np.asarray(opt_info["radar_u"], np.float32)
        radar_v = np.asarray(opt_info["radar_v"], np.float32)

    trans = np.linalg.inv(np.asarray(data["trans"])).astype(np.float32)

    if not eval_mode:
        if rng is None:
            raise ValueError("training-mode decoding needs an rng")
        idx1 = _sample_indices(pos_1.shape[0], num_points, rng)
        idx2 = _sample_indices(pos_2.shape[0], num_points, rng)
        pos_1, feature_1 = pos_1[idx1], feature_1[idx1]
        pos_2, feature_2 = pos_2[idx2], feature_2[idx2]
        radar_u, radar_v = radar_u[idx1], radar_v[idx1]
        opt_flow = opt_flow[idx1]
        labels, mask = labels[idx1], mask[idx1]

    n1, n2 = pos_1.shape[0], pos_2.shape[0]
    return {
        "pc1": pos_1, "pc2": pos_2, "ft1": feature_1, "ft2": feature_2,
        "trans": trans, "labels": labels, "mask": mask.astype(np.float32),
        "interval": np.float32(VOD_INTERVAL),
        "radar_u": radar_u, "radar_v": radar_v, "opt_flow": opt_flow,
        "valid1": np.ones(n1, bool), "valid2": np.ones(n2, bool),
    }


def _sample_indices(npts: int, num_points: int,
                    rng: np.random.Generator) -> np.ndarray:
    """Random fixed-size sampling with duplicate-padding
    (dataset/vod.py:98-111)."""
    if npts < num_points:
        extra = rng.choice(npts, num_points - npts, replace=True)
        return np.concatenate([np.arange(npts), extra])
    return rng.choice(npts, num_points, replace=False)


class VodDataset:
    """Per-pair dataset (dataset/vod.py equivalent).

    ``_rng`` draws the training subsamples in item order; the loader's
    prefetch threads share it, so only ``num_workers=0`` reproduces a draw
    order (as in the JAX package)."""

    def __init__(
        self,
        root: str,
        partition: str = "train",
        num_points: int = 256,
        eval_mode: bool = False,
        seed: int = 1234,
        log=print,
    ):
        self.num_points = num_points
        self.eval_mode = eval_mode
        self.partition = partition
        self.root = os.path.join(root, partition)
        self.res = dict(VOD_RADAR_RES)
        self.camera_projection_matrix = VOD_CAMERA_PROJECTION
        self.t_camera_radar = VOD_T_CAMERA_RADAR
        self.interval = VOD_INTERVAL
        self._rng = np.random.default_rng(seed)

        self.samples: List[str] = []
        self.clips_info: List[Dict] = []
        for clip in _list_clips(self.root):
            # the reference appends clips_info for *every* clip but samples
            # only for delft_* ones (dataset/vod.py:39-45); filter both so
            # clips_info ranges always match self.samples
            if clip[:5] != "delft":
                continue
            samples = _list_samples(os.path.join(self.root, clip))
            if eval_mode:
                self.clips_info.append({
                    "clip_name": clip,
                    "index": [len(self.samples),
                              len(self.samples) + len(samples)],
                })
            self.samples.extend(samples)
        log(f"{partition} : {len(self.samples)}")

    def __len__(self) -> int:
        return len(self.samples)

    def __getitem__(self, index: int) -> Sample:
        return self.get(index, self._rng)

    def get(self, index: int, rng: np.random.Generator) -> Sample:
        """Sample ``index``, a training subsample drawn from ``rng``."""
        data = load_sample_file(self.samples[index])
        return decode_sample(
            data, self.partition, eval_mode=self.eval_mode,
            num_points=self.num_points, rng=rng,
        )


class VodClipDataset:
    """Temporal mini-clip dataset (dataset/vod_clip.py equivalent).

    Training items are stacked mini-clips ``[T, ...]`` of ``mini_clip_len``
    consecutive frames of one clip (a clip's last ``len % T`` frames are
    left out); evaluation items are single frames in clip order, with
    ``clips_info`` marking the clips (vod_clip.py:38-64).  ``_rng`` draws
    the training subsamples, as in :class:`VodDataset`."""

    def __init__(
        self,
        root: str,
        partition: str = "train",
        num_points: int = 256,
        eval_mode: bool = False,
        mini_clip_len: int = 5,
        update_len: int = 5,
        seed: int = 1234,
        log=print,
    ):
        self.num_points = num_points
        self.eval_mode = eval_mode
        self.partition = partition
        self.root = os.path.join(root, partition)
        self.mini_clip_len = mini_clip_len
        self.update_len = update_len
        self.res = dict(VOD_RADAR_RES)
        self.camera_projection_matrix = VOD_CAMERA_PROJECTION
        self.t_camera_radar = VOD_T_CAMERA_RADAR
        self.interval = VOD_INTERVAL
        self._rng = np.random.default_rng(seed)

        self.samples: List[str] = []
        self.mini_samples: List[List[str]] = []
        self.clips_info: List[Dict] = []
        for clip in _list_clips(self.root):
            # the same delft_* filter as VodDataset (vod_clip.py:30-64)
            if clip[:5] != "delft":
                continue
            samples = _list_samples(os.path.join(self.root, clip))
            if eval_mode:
                self.clips_info.append({
                    "clip_name": clip,
                    "index": [len(self.samples),
                              len(self.samples) + len(samples)],
                })
                self.samples.extend(samples)
            else:
                for i in range(len(samples) // mini_clip_len):
                    st = i * mini_clip_len
                    self.mini_samples.append(samples[st:st + mini_clip_len])
        if eval_mode:
            log(f"{partition} : {len(self.samples)} frames")
        else:
            log(f"{partition} : {len(self.mini_samples)} mini_clips")

    def __len__(self) -> int:
        return len(self.samples) if self.eval_mode else len(self.mini_samples)

    def __getitem__(self, index: int) -> Sample:
        return self.get(index, self._rng)

    def get(self, index: int, rng: np.random.Generator) -> Sample:
        """Item ``index``, its training subsamples drawn from ``rng``."""
        if self.eval_mode:
            return decode_sample(
                load_sample_file(self.samples[index]), self.partition,
                eval_mode=True, num_points=self.num_points, rng=rng)
        frames = [
            decode_sample(load_sample_file(p), self.partition,
                          eval_mode=False, num_points=self.num_points,
                          rng=rng)
            for p in self.mini_samples[index]
        ]
        return {k: np.stack([f[k] for f in frames]) for k in frames[0]}
