#!/usr/bin/env python3
"""The host's cost of the port's point ops and of the steps that run them,
for one or more checkouts of the port, on one GPU.

    python scripts/host_cost_torch.py [TREE ...]

Each TREE is a directory holding a ``cmflow_tpu_torch`` package (this
checkout when none is given); each is timed in a process of its own, in
the order given, so two trees compare within one call (give them as A B B
A).  In each: the kernels are built, then

* the wrappers' host cost: ``ITERS_OP`` back-to-back calls of the ball
  query, kNN and row gather of ``cmflow_tpu_torch.ops.pointops`` at the
  train step's shapes (B=16, N=256), the host clock over the calls before
  one synchronise (each call's kernel is far shorter than its issue, so
  this is the host's time a call), the median of ``ROUNDS_OP`` rounds;
* the CMFlow float32 train step (``make_train_step``, B=16, N=256, seeded
  weights and batch) and one module-route request (``make_eval_step(...,
  fused="off")``, B=16, bucket 256): ``TIMED`` warmed calls each ended by a
  synchronise, median and mean wall ms on the host clock.

Prints the card's name and power limit, then one JSON line per tree.
Needs a CUDA device; exits with code 1 without one.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

BATCH = 16
NUM_POINTS = 256
SEED = 0
WARM = 3
TIMED = 20
ITERS_OP = 500
ROUNDS_OP = 5


def wall_ms(fn, n: int) -> list:
    out = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(1e3 * (time.perf_counter() - t0))
    return out


def host_us(fn) -> float:
    for _ in range(WARM):
        fn()
    rounds = []
    for _ in range(ROUNDS_OP):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(ITERS_OP):
            fn()
        rounds.append(1e6 * (time.perf_counter() - t0) / ITERS_OP)
    torch.cuda.synchronize()
    return statistics.median(rounds)


def measure(tree: str) -> dict:
    sys.path.insert(0, tree)
    import cmflow_tpu_torch
    from cmflow_tpu_torch.data.synthetic import make_request, make_train_batch
    from cmflow_tpu_torch.data.vod import (
        VOD_CAMERA_PROJECTION,
        VOD_T_CAMERA_RADAR,
    )
    from cmflow_tpu_torch.models import build_model
    from cmflow_tpu_torch.native import build
    from cmflow_tpu_torch.ops import pointops
    from cmflow_tpu_torch.train.state import create_train_state
    from cmflow_tpu_torch.train.steps import make_eval_step, make_train_step

    assert Path(cmflow_tpu_torch.__file__).resolve().parents[1] == \
        Path(tree).resolve()
    build.build()
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(SEED)
    pts = torch.rand((BATCH, NUM_POINTS, 3), generator=gen).to(dev)
    feat = torch.rand((BATCH, NUM_POINTS, 64), generator=gen).to(dev)
    idx = torch.randint(0, NUM_POINTS, (BATCH, NUM_POINTS), generator=gen,
                        dtype=torch.int32).to(dev)
    ops = dict(
        ball_query_us=host_us(lambda: pointops.ball_query(
            0.25, 16, pts, pts)),
        knn_us=host_us(lambda: pointops.knn(16, pts, pts)),
        gather_points_us=host_us(lambda: pointops.gather_points(feat, idx)))

    model = build_model("cmflow", device=dev, seed=SEED)
    state = create_train_state(model)
    step = make_train_step("cmflow", model, VOD_CAMERA_PROJECTION,
                           VOD_T_CAMERA_RADAR)
    batch = make_train_batch(SEED, BATCH, NUM_POINTS)
    wall_ms(lambda: step(state, batch), WARM)
    train = wall_ms(lambda: step(state, batch), TIMED)

    module = make_eval_step("cmflow", model, fused="off")
    req = make_request(SEED + 1, BATCH, (200, NUM_POINTS))
    wall_ms(lambda: module(req), WARM)
    serve = wall_ms(lambda: module(req), TIMED)
    return dict(tree=tree, ops_host=ops,
                train_step_ms=dict(median=statistics.median(train),
                                   mean=statistics.mean(train)),
                module_request_ms=dict(median=statistics.median(serve),
                                       mean=statistics.mean(serve)))


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    if len(sys.argv) == 3 and sys.argv[1] == "--one":
        print(json.dumps(measure(sys.argv[2])), flush=True)
        return 0
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip(),
        flush=True)
    trees = sys.argv[1:] or [str(Path(__file__).resolve().parents[1])]
    for tree in trees:
        proc = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--one",
             str(Path(tree).resolve())],
            capture_output=True, text=True, timeout=900)
        sys.stderr.write(proc.stderr)
        if proc.returncode != 0:
            print(f"{tree}: exit {proc.returncode}", file=sys.stderr)
            return 1
        print(proc.stdout.strip().splitlines()[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
