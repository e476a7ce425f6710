#!/usr/bin/env python3
"""Where the time of one RAFT-small frame pair goes on the card.

    python scripts/profile_torch_raft.py [H W]

Builds RAFT-small as the preprocessing does (``RaftSmallProvider``: seeded
weights, TF32 off) and runs it at VoD's camera size (1216x1936 unless
given), 12 iterations, on two seeded uint8 images.  Prints JSON lines:

* ``stages``: CUDA-event milliseconds (median of 5 after a warm-up) of each
  stage called alone on the forward's own tensors: the feature net on each
  image, the context net, the correlation pyramid, one window lookup, one
  update block, the upsampling; the lookup and the update block also times
  12, and the whole forward;
* ``memory``: the peak allocated memory of each stage over what was
  allocated before it;
* ``ops``: the profiler's device time of one whole forward by operator
  (top 20) and by kernel (top 20);
* the card's name and power limit beside every line.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from cmflow_tpu_torch.models import raft  # noqa: E402
from cmflow_tpu_torch.preprocess.optical_flow import (  # noqa: E402
    RaftSmallProvider,
)

ITERS = 12
TIMED = 5


def timed(fn) -> float:
    """Median CUDA-event milliseconds of ``TIMED`` calls after one."""
    fn()
    times = []
    for _ in range(TIMED):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def peak_gb(fn) -> float:
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - base) / 1e9


def main() -> int:
    size = tuple(int(v) for v in sys.argv[1:3]) or (1216, 1936)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    dev = torch.device("cuda")
    model = RaftSmallProvider(device=dev, seed=0).model
    # the stages are called alone: autotune their convolutions as
    # RaftSmall.forward does, before any plan for these shapes is cached
    torch.backends.cudnn.benchmark = True
    rng = np.random.RandomState(0)
    img1, img2 = (torch.from_numpy(rng.randint(0, 255, (1, 3, *size))
                                   .astype(np.uint8)).to(dev)
                  for _ in range(2))

    with torch.inference_mode():
        x1 = 2.0 * (img1.float() / 255.0) - 1.0
        x2 = 2.0 * (img2.float() / 255.0) - 1.0
        fmap1, fmap2 = model.fnet(x1), model.fnet(x2)
        cmap = model.cnet(x1)
        net = torch.tanh(cmap[:, :96])
        inp = torch.relu(cmap[:, 96:])
        pyramid = raft.corr_pyramid(fmap1, fmap2)
        b, _, h, w = fmap1.shape
        ys, xs = torch.meshgrid(torch.arange(h, device=dev).float(),
                                torch.arange(w, device=dev).float(),
                                indexing="ij")
        coords = torch.stack([xs, ys])[None] + 0.3
        corr = raft.corr_lookup(pyramid, coords)
        flow = coords - coords.floor()

        def lookups():
            for _ in range(ITERS):
                raft.corr_lookup(pyramid, coords)

        def updates():
            for _ in range(ITERS):
                model.update_block(net, inp, corr, flow)

        stages = {
            "fnet_one_image": lambda: model.fnet(x1),
            "cnet": lambda: model.cnet(x1),
            "corr_pyramid": lambda: raft.corr_pyramid(fmap1, fmap2),
            "corr_lookup": lambda: raft.corr_lookup(pyramid, coords),
            f"corr_lookup_x{ITERS}": lookups,
            "update_block": lambda: model.update_block(net, inp, corr, flow),
            f"update_block_x{ITERS}": updates,
            "upflow8": lambda: raft.upflow8(flow),
            "forward": lambda: model(img1, img2, ITERS),
        }
        ms = {k: timed(fn) for k, fn in stages.items()}
        print(json.dumps(dict(size=list(size), iters=ITERS, stages_ms=ms,
                              card=card)), flush=True)
        del pyramid
        torch.cuda.empty_cache()
        mem = {k: peak_gb(stages[k]) for k in (
            "fnet_one_image", "cnet", "corr_pyramid", "forward")}
        print(json.dumps(dict(memory_peak_gb=mem, card=card)), flush=True)

        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            model(img1, img2, ITERS)
            torch.cuda.synchronize()
    ops = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                  for e in prof.key_averages()
                  if e.self_device_time_total > 0
                  and e.device_type == DeviceType.CPU),
                 key=lambda r: -r[1])[:20]
    kernels = sorted(((e.key[:90], e.self_device_time_total / 1e3, e.count)
                      for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA),
                     key=lambda r: -r[1])[:20]
    total = sum(e.self_device_time_total for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA) / 1e3
    print(json.dumps(dict(device_ms=total, ops_ms=ops, kernels_ms=kernels,
                          card=card)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
