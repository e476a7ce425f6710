#!/usr/bin/env python3
"""Where the time of the port's CMFlow eval forward goes, on one GPU.

    python scripts/profile_torch_eval.py

Builds a full-width CMFlow (seeded weights), serves one request of
``BATCH`` synthetic frames at the 256-point bucket (the request
``chip_smoke.py`` serves there, from ``synthetic.make_request``) through
``make_eval_step``, and traces ``ITERS`` warmed forwards with
``torch.profiler``.  Prints the host wall time per forward, the device busy
share (summed kernel time over wall time; one stream, so kernels do not
overlap), device time by group (the port's kernels, matrix products, the
rest), and the top kernels by device time.  Needs a CUDA device; exits with
code 1 without one.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from cmflow_tpu_torch.data.synthetic import make_request  # noqa: E402
from cmflow_tpu_torch.models import build_model  # noqa: E402
from cmflow_tpu_torch.train.steps import make_eval_step  # noqa: E402

BATCH = 16
SEED = 0
ITERS = 5
# device-side names of the port's kernels and of cuBLAS products
GROUPS = (("ball_query", ("ball_query_kernel",)),
          ("knn", ("knn_kernel",)),
          ("gather", ("gather_rows_kernel",)),
          ("matmul", ("gemm", "gemv", "sm90_xmma", "cutlass")))


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1

    model = build_model("cmflow", seed=SEED)
    step = make_eval_step("cmflow", model)
    req = make_request(SEED, BATCH, (200, 256))
    for _ in range(3):
        step(req)
    torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(ITERS):
            step(req)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0) / ITERS

    # device-side events only: a CPU operator's device time repeats the
    # time of the kernels it launched
    rows = [(e.key, e.self_device_time_total / 1e3 / ITERS, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total]
    device_ms = sum(ms for _, ms, _ in rows)
    groups = {name: 0.0 for name, _ in GROUPS}
    groups["other"] = 0.0
    for key, ms, _ in rows:
        low = key.lower()
        name = next((g for g, pats in GROUPS if any(p in low for p in pats)),
                    "other")
        groups[name] += ms
    print(json.dumps(dict(
        device=torch.cuda.get_device_name(0), batch=BATCH,
        bucket=req["pc1"].shape[1], wall_ms_per_forward=wall_ms,
        device_ms_per_forward=device_ms,
        device_busy_share=device_ms / wall_ms,
        device_ms_by_group=groups)))
    rows.sort(key=lambda r: -r[1])
    for key, ms, count in rows[:20]:
        print(json.dumps(dict(kernel=key[:90], device_ms_per_forward=ms,
                              calls_per_forward=count / ITERS)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
