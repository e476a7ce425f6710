"""Pluggable optical-flow providers for preprocessing (the counterpart of
``cmflow_tpu/preprocess/optical_flow.py``).

The camera modality is one of three cross-modal supervision sources; the
reference hard-wires a torch RAFT-small (preprocess/utils/optical_flow.py).
Here the provider is an interface, so flow can come from the port's
RAFT-small on the card, from precomputed files, or be disabled, and the
model is built once per run (the reference re-initialises it for every
frame pair, get_flow_samples.py:46).

A provider is any callable ``(img1_rgb_uint8, img2_rgb_uint8) -> flow
[H, W, 2] float32``.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from cmflow_tpu_torch.models.convert import load_raft_small
from cmflow_tpu_torch.models.raft import RaftSmall, init_raft_small
from cmflow_tpu_torch.utils.device import DeviceLike, resolve_device


class ZeroFlowProvider:
    """Disable the camera modality (optical-flow loss weight 0.1 simply
    sees zero targets)."""

    def __call__(self, img1: np.ndarray, img2: np.ndarray) -> np.ndarray:
        return np.zeros((*img1.shape[:2], 2), np.float32)


class PrecomputedFlowProvider:
    """Read flow from ``<dir>/<key>.npy``; keys assigned via
    ``set_key`` before each call (lets a caller reuse cached RAFT output)."""

    def __init__(self, flow_dir: str):
        self.flow_dir = flow_dir
        self._key: Optional[str] = None

    def set_key(self, key: str) -> None:
        self._key = key

    def __call__(self, img1: np.ndarray, img2: np.ndarray) -> np.ndarray:
        if self._key is None:
            raise RuntimeError("set_key() before requesting flow")
        return np.load(os.path.join(self.flow_dir, f"{self._key}.npy"))


class RaftSmallProvider:
    """RAFT-small on ``device`` (``None`` is the GPU, and raises without
    one; pass ``"cpu"`` for the CPU), built once.

    Args:
      weights_path: optional path to the public torch ``raft-small.pth``
        checkpoint; otherwise the weights are drawn from a
        ``torch.Generator`` seeded with ``seed`` (useful only for pipeline
        testing).
      iters: GRU iterations (the reference uses 12,
        preprocess/utils/optical_flow.py:23).
    """

    def __init__(self, weights_path: Optional[str] = None, iters: int = 12,
                 device: DeviceLike = None, seed: int = 0):
        self.device = resolve_device(device)
        self.iters = iters
        model = RaftSmall()
        if weights_path:
            model.load_state_dict(load_raft_small(weights_path))
        else:
            init_raft_small(model, torch.Generator().manual_seed(seed))
        self.model = model.to(self.device).eval()

    def __call__(self, img1: np.ndarray, img2: np.ndarray) -> np.ndarray:
        h, w = img1.shape[:2]
        ph = (8 - h % 8) % 8
        pw = (8 - w % 8) % 8
        if ph or pw:
            pad = ((0, ph), (0, pw), (0, 0))
            img1 = np.pad(img1, pad)
            img2 = np.pad(img2, pad)

        def to_device(img):
            return torch.tensor(img, device=self.device).permute(
                2, 0, 1)[None]

        with torch.inference_mode():
            flow = self.model(to_device(img1), to_device(img2),
                              iters=self.iters)
            flow = flow[0].permute(1, 2, 0).to("cpu", torch.float32).numpy()
        return flow[:h, :w]
