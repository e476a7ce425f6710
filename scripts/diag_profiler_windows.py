#!/usr/bin/env python3
"""Whether capturing a CUDA graph spoils ``torch.profiler``'s later windows.

    python scripts/diag_profiler_windows.py

In one process: the CMFlow float32 train step (B=16, N=256, seeded) traced
by ``chip_smoke.device_ms`` (a window counts only when every kernel it
recorded appears a multiple of the step count times), ``ROUNDS`` times;
then one CUDA graph of 20 farthest-point-sampling calls captured and
replayed (``chip_smoke.graph_ms``); then the step traced ``ROUNDS`` times
again.  Prints one JSON line per traced round: before or after the
capture, and whether a whole window came within ``TRIES`` tries.  Needs a
CUDA device; exits with code 1 without one.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402
from cmflow_tpu_torch.data.synthetic import make_train_batch  # noqa: E402
from cmflow_tpu_torch.data.vod import (  # noqa: E402
    VOD_CAMERA_PROJECTION,
    VOD_T_CAMERA_RADAR,
)
from cmflow_tpu_torch.models import build_model  # noqa: E402
from cmflow_tpu_torch.native import build  # noqa: E402
from cmflow_tpu_torch.ops import sampling  # noqa: E402
from cmflow_tpu_torch.train.state import create_train_state  # noqa: E402
from cmflow_tpu_torch.train.steps import make_train_step  # noqa: E402

ROUNDS = 3
TRIES = 3


def traced(step, when: str, i: int) -> None:
    try:
        _, ms, _, ops = chip_smoke.device_ms(step, 3)
        row = dict(whole=True, device_ms=ms, cuda_ops_per_step=ops)
    except RuntimeError as e:
        row = dict(whole=False, error=str(e))
    print(json.dumps(dict(when=when, round=i, **row)), flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip(),
        flush=True)
    chip_smoke.PROFILE_TRIES = TRIES
    build.build()
    dev = torch.device("cuda")
    model = build_model("cmflow", device=dev, seed=0)
    state = create_train_state(model)
    step = make_train_step("cmflow", model, VOD_CAMERA_PROJECTION,
                           VOD_T_CAMERA_RADAR)
    batch = make_train_batch(0, 16, 256)
    for i in range(ROUNDS):
        traced(lambda: step(state, batch), "before_capture", i)
    xyz = chip_smoke.unit_sphere(torch.Generator().manual_seed(0), 16,
                                 1024).to(dev)
    ms, kernels = chip_smoke.graph_ms(
        lambda: sampling.farthest_point_sample(xyz, 512), 20)
    print(json.dumps(dict(fps_graph_ms=ms, kernels_per_call=kernels)),
          flush=True)
    for i in range(ROUNDS):
        traced(lambda: step(state, batch), "after_capture", i)
    return 0


if __name__ == "__main__":
    sys.exit(main())
