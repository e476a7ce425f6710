"""Sample/batch schema (a copy of ``cmflow_tpu/data/schema.py``).

A frame-pair sample is a dict of numpy arrays with the same fields the
reference dataloaders emit as an 11-tuple (dataset/vod.py:124), plus
explicit validity masks so evaluation can run with static padded
shapes instead of the reference's dynamic per-frame point counts:

  pc1, pc2      [N, 3]   radar points (frame 1 / frame 2)
  ft1, ft2      [N, 3]   features (v_r, RCS, RCS)  (dataset/vod.py:62-63)
  trans         [4, 4]   gt ego transform mapping static frame-1 points
                         into frame 2 (inverse of the stored odom pose,
                         dataset/vod.py:90)
  labels        [N, 3]   gt or pseudo flow labels
  mask          [N]      gt motion-seg mask (eval) or pseudo FG mask (train)
  interval      []       frame interval (s)
  radar_u/v     [N]      projected pixel coords of pc1 (train only)
  opt_flow      [N, 2]   RAFT optical flow at those pixels (train only)
  valid1/valid2 [N]      bool, real-point mask (all True for training)
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

Sample = Dict[str, np.ndarray]

FIELDS_N1 = ("pc1", "ft1", "labels", "radar_u", "radar_v", "opt_flow", "mask")
FIELDS_N2 = ("pc2", "ft2")


def pad_to(sample: Sample, n: int) -> Sample:
    """Zero-pad every per-point field to ``n`` points and set valid masks.

    Padding value 0 is safe: all ops consuming the arrays mask padded
    points via valid1/valid2.
    """
    out = dict(sample)
    n1 = sample["pc1"].shape[0]
    n2 = sample["pc2"].shape[0]
    if n1 > n or n2 > n:
        raise ValueError(f"bucket {n} too small for sample with {n1}/{n2} pts")

    def pad(x, cur):
        width = [(0, n - cur)] + [(0, 0)] * (x.ndim - 1)
        return np.pad(x, width)

    for f in FIELDS_N1:
        if f in out:
            out[f] = pad(np.asarray(out[f]), n1)
    for f in FIELDS_N2:
        if f in out:
            out[f] = pad(np.asarray(out[f]), n2)
    out["valid1"] = np.arange(n) < n1
    out["valid2"] = np.arange(n) < n2
    return out


def bucket_size(n: int, multiple: int = 128, minimum: int = 256) -> int:
    """Round a point count up to a static bucket (multiples of 128), which
    bounds the number of distinct batch shapes."""
    return max(minimum, ((n + multiple - 1) // multiple) * multiple)


def collate(samples: List[Sample]) -> Sample:
    """Stack samples into a batch (all samples must share shapes)."""
    keys = samples[0].keys()
    return {k: np.stack([s[k] for s in samples]) for k in keys}
