#!/usr/bin/env python3
"""Where the time of the port's CMFlow eval forward goes, on one GPU, on
both routes: the fused serving engine and the module route.

    python scripts/profile_torch_eval.py [bfloat16] [TREE]

``bfloat16`` serves at ``compute_dtype`` bfloat16 (the fused route's bf16
arms; the module route ignores the dtype, as the JAX package's does).
``TREE`` is the root of a checkout whose package is imported (default:
this script's own), so that one machine can time two versions in turns.
Builds a full-width CMFlow (seeded weights) and serves one request of
``BATCH`` synthetic frames at the 256-point bucket (the request
``chip_smoke.py`` serves there, from ``synthetic.make_request``) through
``make_eval_step`` with ``fused="on"`` and with ``fused="off"``.  For each
route: the request latency and frames/s over ``TIMED`` warmed forwards
without the profiler (host clock, each forward ending in a synchronise), then
``ITERS`` forwards traced with ``torch.profiler``: host wall time per
forward, device busy share (summed kernel time over wall time; one stream,
so kernels do not overlap), device time by group (the port's kernels, matrix
products, the rest), and the top kernels by device time.  Needs a CUDA
device; exits with code 1 without one.
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

ARGS = sys.argv[1:]
DTYPE = torch.bfloat16 if "bfloat16" in ARGS else torch.float32
TREE = Path(next((a for a in ARGS if a != "bfloat16"),
                 Path(__file__).resolve().parents[1])).resolve()
sys.path.insert(0, str(TREE))

from cmflow_tpu_torch.data.synthetic import make_request  # noqa: E402
from cmflow_tpu_torch.models import build_model  # noqa: E402
from cmflow_tpu_torch.train.steps import make_eval_step  # noqa: E402

BATCH = 16
SEED = 0
ITERS = 5
TIMED = 20
# device-side names of the port's kernels and of cuBLAS products
# (either dtype's arm)
GROUPS = (("ball_query", ("ball_query_kernel",)),
          ("knn", ("knn_kernel",)),
          ("gather", ("gather_rows_kernel",)),
          ("mse", ("mse_kernel", "mse_bf16_kernel")),
          ("cv", ("cv_p2p_kernel", "cv_p2p_bf16_kernel")),
          ("cv_agg", ("cv_agg_kernel", "cv_agg_bf16_kernel")),
          ("plf", ("plf_kernel", "plf_bf16_kernel")),
          ("matmul", ("gemm", "gemv", "sm90_xmma", "cutlass")))


def profile_route(model, req, fused: str) -> None:
    step = make_eval_step("cmflow", model, fused=fused, compute_dtype=DTYPE)
    for _ in range(3):
        step(req)
    torch.cuda.synchronize()
    latencies = []
    for _ in range(TIMED):
        t0 = time.perf_counter()
        step(req)
        torch.cuda.synchronize()
        latencies.append(time.perf_counter() - t0)
    latencies.sort()
    median = latencies[len(latencies) // 2]

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
    launches = 0
    for key, ms, count in rows:
        low = key.lower()
        name = next((g for g, pats in GROUPS if any(p in low for p in pats)),
                    "other")
        groups[name] += ms
        launches += count
    print(json.dumps(dict(
        route=fused, dtype=str(DTYPE), tree=str(TREE),
        device=torch.cuda.get_device_name(0), batch=BATCH,
        bucket=req["pc1"].shape[1],
        latency_ms_median=1e3 * median, latency_ms_min=1e3 * latencies[0],
        latency_ms_max=1e3 * latencies[-1],
        frames_per_s_median=BATCH / median,
        profiled_wall_ms_per_forward=wall_ms,
        device_ms_per_forward=device_ms,
        device_busy_share=device_ms / wall_ms,
        kernels_per_forward=launches / ITERS,
        device_ms_by_group=groups)), flush=True)
    rows.sort(key=lambda r: -r[1])
    for key, ms, count in rows[:12]:
        print(json.dumps(dict(route=fused, kernel=key[:90],
                              device_ms_per_forward=ms,
                              calls_per_forward=count / ITERS)), flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip(),
        flush=True)
    model = build_model("cmflow", seed=SEED)
    req = make_request(SEED, BATCH, (200, 256))
    for fused in ("on", "off"):
        profile_route(model, req, fused)
    return 0


if __name__ == "__main__":
    sys.exit(main())
