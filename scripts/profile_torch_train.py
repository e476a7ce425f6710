#!/usr/bin/env python3
"""Where the time of the port's CMFlow train step goes, on one GPU.

    python scripts/profile_torch_train.py [float32|bfloat16]

Builds a full-width CMFlow (seeded weights) in the compute dtype given
(float32 by default; bfloat16 is ``compute_dtype: bfloat16``, bf16
training) and takes train steps
(``make_train_step``: pseudo labels, train-mode forward, composite loss,
backward, Adam) on one synthetic batch of ``BATCH`` frame pairs of
``NUM_POINTS`` points (``synthetic.make_train_batch``, the batch
``chip_smoke.py`` trains on).  Reports the step's wall time and frames/s
over ``TIMED`` warmed steps without the profiler (host clock, each step
ending in a synchronise), the peak device memory of a step, then ``ITERS``
steps traced with ``torch.profiler``: host wall time per step, device busy
share (summed kernel time over wall time; one stream, so kernels do not
overlap), device time by group (the port's kernels K1, K2, K6, K7, cuBLAS
products, the 3x3 SVDs, Adam's fused updates, reductions, elementwise
kernels, the rest) and the top kernels by device time.
Needs a CUDA device; exits with code 1 without one.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from cmflow_tpu_torch.data.synthetic import make_train_batch  # noqa: E402
from cmflow_tpu_torch.data.vod import (  # noqa: E402
    VOD_CAMERA_PROJECTION,
    VOD_T_CAMERA_RADAR,
)
from cmflow_tpu_torch.models import build_model  # noqa: E402
from cmflow_tpu_torch.train.state import create_train_state  # noqa: E402
from cmflow_tpu_torch.train.steps import make_train_step  # noqa: E402

BATCH = 16
NUM_POINTS = 256
SEED = 0
ITERS = 3
TIMED = 10
# device-side names, first match wins (K7's kernels, the CSR build and the
# piece sum, both hold "gather_rows_backward")
GROUPS = (("K1 ball_query", ("ball_query_kernel",)),
          ("K2 knn", ("knn_kernel",)),
          ("K7 gather_bwd", ("gather_rows_backward",)),
          ("K6 gather", ("gather_rows_kernel",)),
          ("cublas", ("gemm", "gemv", "sm90_xmma", "cutlass")),
          ("svd", ("svd", "jacobi")),
          ("adam", ("multi_tensor_apply",)),
          ("reductions", ("reduce_kernel",)),
          ("elementwise", ("elementwise_kernel",)))


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip(),
        flush=True)
    dtype = sys.argv[1] if len(sys.argv) > 1 else "float32"
    model = build_model("cmflow", seed=SEED, compute_dtype=dtype)
    state = create_train_state(model)
    step = make_train_step("cmflow", model, VOD_CAMERA_PROJECTION,
                           VOD_T_CAMERA_RADAR)
    batch = make_train_batch(SEED, BATCH, NUM_POINTS)
    for _ in range(3):
        step(state, batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    walls = []
    for _ in range(TIMED):
        t0 = time.perf_counter()
        step(state, batch)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    walls.sort()
    median = walls[len(walls) // 2]

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(ITERS):
            step(state, batch)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0) / ITERS

    # device-side kernels only: a CPU operator's device time repeats the
    # time of the kernels it launched, and the optimizer's annotated range
    # ("Optimizer.step#Adam.step") spans the kernels it holds
    rows = [(e.key, e.self_device_time_total / 1e3 / ITERS, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total
            and not getattr(e, "is_user_annotation", False)
            and not e.key.startswith("Optimizer.")]
    device_ms = sum(ms for _, ms, _ in rows)
    groups = {name: 0.0 for name, _ in GROUPS}
    groups["other"] = 0.0
    launches = 0
    for key, ms, count in rows:
        low = key.lower()
        name = next((g for g, pats in GROUPS if any(p in low for p in pats)),
                    "other")
        groups[name] += ms
        launches += count
    print(json.dumps(dict(
        device=torch.cuda.get_device_name(0), compute_dtype=dtype,
        batch=BATCH,
        num_points=NUM_POINTS,
        step_ms_median=1e3 * median, step_ms_min=1e3 * walls[0],
        step_ms_max=1e3 * walls[-1], frames_per_s_median=BATCH / median,
        peak_memory_gib=peak / 2 ** 30,
        profiled_wall_ms_per_step=wall_ms,
        device_ms_per_step=device_ms,
        device_busy_share=device_ms / wall_ms,
        kernels_per_step=launches / ITERS,
        device_ms_by_group=groups)), flush=True)
    rows.sort(key=lambda r: -r[1])
    for key, ms, count in rows[:15]:
        print(json.dumps(dict(kernel=key[:90], device_ms_per_step=ms,
                              calls_per_step=count / ITERS)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
