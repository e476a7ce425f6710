#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of CMFlow on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA GPU and nvcc.  Steps:

1. print the card's name and power limit (nvidia-smi);
2. build every CUDA kernel of ``cmflow_tpu_torch/csrc`` with nvcc, timed;
3. for each kernel, at every shape the CMFlow eval forward gives it (B=16 at
   the 256 bucket, and the padded 384 bucket with valid masks), require an
   exact match with its plain PyTorch version and time the kernel, the plain
   version and, where one exists, a single PyTorch call computing the same
   function (CUDA events, warmed, averaged over many launches);
4. serve four requests of synthetic frames (decoded, padded to their bucket,
   collated; B=16: three at the 256 bucket, one at the 384 bucket) through
   ``make_eval_step`` with a full-width CMFlow whose weights come from a
   seeded generator and whose BatchNorm statistics are seeded random; require
   the kernels' launch counts per forward (ball query 12, kNN 2, gather 16),
   finite outputs, and agreement of the first request with the same forward
   on the CPU (plain versions): stat_cls and sf_agg atol 1e-4, pre_trans atol
   5e-4, motion masks agreeing on >= 99% of valid points;
5. print one JSON line per kernel shape and per request, then the
   ``{"kernels": [...]}`` summary, then ``{"ok": true, "device": ...}`` last.

Any failed check raises, so the exit code is non-zero and the last line is
not printed.  Without a CUDA device, or run from anywhere but the root of a
checkout (with ``cmflow_tpu_torch`` beside it), it exits with code 1 at once.
"""

from __future__ import annotations

import copy
import json
import subprocess
import sys
import time

from pathlib import Path

import numpy as np
import torch

import cmflow_tpu_torch
from cmflow_tpu_torch.data.synthetic import make_request
from cmflow_tpu_torch.evaluation import metrics
from cmflow_tpu_torch.models import build_model
from cmflow_tpu_torch.native import build
from cmflow_tpu_torch.nn.blocks import BatchNorm
from cmflow_tpu_torch.ops import fused, neighbors
from cmflow_tpu_torch.train.steps import make_eval_step

B = 16
SEED = 0
# published peaks of one H100 SXM (NVIDIA data sheet), used for the bounds
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
# float32 operations per (query, point) pair: 3 products and 2 sums for the
# cross term, the -2 scale, 2 sums, the clamp and the comparison
PAIR_FLOPS = 10
BARS = {"flow": 1e-4, "cls": 1e-4, "trans": 5e-4, "agree": 0.99}
LAUNCHES_PER_FORWARD = {"ball_query": 12, "knn": 2, "gather": 16}
WRAPPERS = {"ball_query": neighbors.ball_query_multi, "knn": neighbors.knn,
            "gather": fused.gather_rows}
SOURCES = {
    "ball_query": ("cmflow_tpu_torch/csrc/neighbors.cu",
                   "cmflow_tpu/ops/neighbors.py:64"),
    "knn": ("cmflow_tpu_torch/csrc/neighbors.cu",
            "cmflow_tpu/ops/neighbors.py:101"),
    "gather": ("cmflow_tpu_torch/csrc/gather.cu",
               "cmflow_tpu/ops/fused.py:519"),
}


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes: float, flops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / F32_FLOP_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


# ---------------------------------------------------------------------------
# kernels against their plain versions
# ---------------------------------------------------------------------------

def max_err(a, b) -> float:
    if isinstance(a, tuple):
        return max(max_err(x, y) for x, y in zip(a, b))
    return float((a.double() - b.double()).abs().max())


def ball_scan_pairs(r: float, k: int, pc, valid) -> int:
    """(query, point) pairs the scan visits: up to the k-th hit, or all N."""
    d = neighbors.square_distance(pc, pc)
    hit = (d < neighbors.radius_sq(r)) & valid[:, None, :]
    full = hit.cumsum(-1) >= k
    n = pc.shape[1]
    stop = torch.where(full.any(-1), full.float().argmax(-1) + 1, n)
    return int(stop.sum())


def kernel_cases(req: dict, dev, gen: torch.Generator):
    """Every (kernel, shape) the eval forward of one request launches, with
    its multiplicity per forward, the kernel call, its plain version, a
    library call (or None), and the bytes and operations of the function."""
    pc1 = torch.as_tensor(req["pc1"], device=dev)
    pc2 = torch.as_tensor(req["pc2"], device=dev)
    v1 = torch.as_tensor(req["valid1"], device=dev)
    v2 = torch.as_tensor(req["valid2"], device=dev)
    b, n, _ = pc1.shape
    cloud_bytes = b * n * (3 * 4 + 1)
    radii, ks = (2.0, 4.0, 8.0, 16.0), (4, 8, 16, 32)
    cases = []
    ball_idx = {}
    for r, k in zip(radii, ks):
        (idx,) = neighbors.ball_query_multi((r,), (k,), pc1, pc1, v1)
        ball_idx[k] = idx
        cases.append(dict(
            kernel="ball_query", shape=f"B={b} N={n} r={r} K={k} masked",
            mult=3,  # sa encoder on pc1 and pc2, propagation encoder on pc1
            run=lambda r=r, k=k: neighbors.ball_query_multi(
                (r,), (k,), pc1, pc1, v1),
            plain=lambda r=r, k=k: neighbors.ball_query_multi_plain(
                (r,), (k,), pc1, pc1, v1),
            library=None,
            nbytes=cloud_bytes + b * n * k * 4,
            flops=PAIR_FLOPS * ball_scan_pairs(r, k, pc1, v1)))
    knn_idx = {}
    for name, pts, valid in (("pc1->pc2", pc2, v2), ("pc1->pc1", pc1, v1)):
        knn_idx[name] = neighbors.knn(8, pc1, pts, valid)
        dist = neighbors.masked_square_distance(pc1, pts, valid)
        cases.append(dict(
            kernel="knn", shape=f"B={b} N={n} k=8 {name} masked", mult=1,
            run=lambda pts=pts, valid=valid: neighbors.knn(8, pc1, pts, valid),
            plain=lambda pts=pts, valid=valid: neighbors.knn_plain(
                8, pc1, pts, valid),
            library=lambda dist=dist: torch.topk(dist, 8, largest=False),
            nbytes=(cloud_bytes * (1 if pts is pc1 else 2)
                    + b * n * 8 * 4),
            flops=PAIR_FLOPS * b * n * n))

    def gather_case(c, idx, mult, what):
        pts = torch.randn((b, n, c), generator=gen).to(dev)
        flat = idx.reshape(b, -1)
        flat_long = flat.long()
        rows = torch.arange(b, device=dev)[:, None]
        m = flat.shape[1]
        cases.append(dict(
            kernel="gather", shape=f"B={b} N={n} M={m} C={c} ({what})",
            mult=mult,
            run=lambda: fused.gather_rows(pts, flat),
            plain=lambda: fused.gather_rows_plain(pts, flat),
            library=lambda: pts[rows, flat_long],
            nbytes=b * n * c * 4 + b * m * 4 + b * m * c * 4, flops=0))

    for k in ks:
        gather_case(32, ball_idx[k], 2, f"sa encoder K={k}")
        gather_case(512, ball_idx[k], 1 if k != 8 else 3,
                    f"propagation encoder K={k}"
                    + (" and cost volume" if k == 8 else ""))
    gather_case(3, knn_idx["pc1->pc2"], 2, "cost volume xyz k=8")
    return cases


def check_kernels(requests, dev, gen):
    per_forward = {}  # kernel -> sums over one forward at the first bucket
    for ri, req in enumerate(requests):
        for case in kernel_cases(req, dev, gen):
            got, want = case["run"](), case["plain"]()
            torch.cuda.synchronize()
            err = max_err(got, want)
            require(err == 0.0, f"{case['kernel']} {case['shape']}: kernel "
                                f"and plain version differ by {err}")
            row = dict(kernel=case["kernel"], shape=case["shape"],
                       kernel_ms=cuda_ms(case["run"], 50),
                       plain_ms=cuda_ms(case["plain"], 10),
                       library_ms=(cuda_ms(case["library"], 20)
                                   if case["library"] else None),
                       max_abs_err=err)
            row["bound_ms"], row["bound_by"] = bound_ms(case["nbytes"],
                                                        case["flops"])
            row["launches_per_forward"] = case["mult"]
            emit(row)
            if ri:
                continue
            acc = per_forward.setdefault(case["kernel"], dict(
                ms=0.0, plain_ms=0.0, library_ms=0.0, nbytes=0.0, flops=0.0,
                max_abs_err=0.0, has_library=True))
            acc["ms"] += case["mult"] * row["kernel_ms"]
            acc["plain_ms"] += case["mult"] * row["plain_ms"]
            acc["nbytes"] += case["mult"] * case["nbytes"]
            acc["flops"] += case["mult"] * case["flops"]
            acc["max_abs_err"] = max(acc["max_abs_err"], err)
            if row["library_ms"] is None:
                acc["has_library"] = False
            else:
                acc["library_ms"] += case["mult"] * row["library_ms"]
    return per_forward


# ---------------------------------------------------------------------------
# the served model
# ---------------------------------------------------------------------------

def randomize_batchnorm(model, step, req, gen: torch.Generator) -> None:
    """Seeded random BatchNorm statistics on the scale of the activations:
    on one calibration forward, each BatchNorm takes the mean and variance
    of its input, perturbed by random factors, and a random affine."""

    def uniform(shape, lo, hi):
        return (lo + (hi - lo) * torch.rand(shape, generator=gen))

    def pre_hook(mod, args):
        x = args[0].reshape(-1, args[0].shape[-1])
        c = x.shape[-1]
        mean, var = x.mean(0), x.var(0, unbiased=False)
        dev = x.device
        mod.running_mean.copy_(mean + uniform(c, -0.2, 0.2).to(dev)
                               * var.sqrt())
        mod.running_var.copy_(var * uniform(c, 0.7, 1.4).to(dev) + 1e-3)
        mod.weight.copy_(uniform(c, 0.7, 1.3).to(dev))
        mod.bias.copy_(uniform(c, -0.2, 0.2).to(dev))

    hooks = [m.register_forward_pre_hook(pre_hook)
             for m in model.modules() if isinstance(m, BatchNorm)]
    step(req)
    for h in hooks:
        h.remove()


def frame_metrics(req: dict, out) -> dict:
    sf, _, trans, _ = (x.cpu().numpy() for x in out)
    sfm = metrics.eval_scene_flow_batch(req["pc1"], sf, req["labels"],
                                        req["mask"], req["valid1"])
    pose = metrics.eval_trans_rpe_batch(req["trans"], trans)
    res = {k: float(np.mean(sfm[k])) for k in ("epe", "accs", "accr")}
    res.update({k: float(np.mean(pose[k])) for k in ("RTE", "RAE")})
    return res


def compare_with_cpu(model, req, out) -> dict:
    cpu_model = copy.deepcopy(model).to("cpu")
    ref = make_eval_step("cmflow", cpu_model)(req)
    (sf, cls, trans, mask), (rsf, rcls, rtrans, rmask) = (
        [x.cpu().numpy() for x in o] for o in (out, ref))
    valid = req["valid1"]
    same = mask == rmask
    res = dict(
        cls_max_abs_err=float(np.abs(cls - rcls).max()),
        trans_max_abs_err=float(np.abs(trans - rtrans).max()),
        flow_max_abs_err=float(np.abs(sf - rsf)[same].max()),
        mask_agreement=float(same[valid].mean()))
    require(res["cls_max_abs_err"] <= BARS["cls"], f"stat_cls vs CPU: {res}")
    require(res["trans_max_abs_err"] <= BARS["trans"],
            f"pre_trans vs CPU: {res}")
    require(res["flow_max_abs_err"] <= BARS["flow"], f"sf_agg vs CPU: {res}")
    require(res["mask_agreement"] >= BARS["agree"], f"mask vs CPU: {res}")
    return res


def serve(model, step, requests) -> dict:
    launches = {k: 0 for k in WRAPPERS}
    cpu_check = None
    for i, req in enumerate(requests):
        for fn in WRAPPERS.values():
            fn.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = step(req)
        torch.cuda.synchronize()
        latency = time.perf_counter() - t0
        counts = {k: fn.launches for k, fn in WRAPPERS.items()}
        require(counts == LAUNCHES_PER_FORWARD,
                f"request {i}: launches {counts}, want {LAUNCHES_PER_FORWARD}")
        for k in launches:
            launches[k] += counts[k]
        b, n = req["pc1"].shape[:2]
        sf, cls, trans, mask = out
        require(sf.shape == (b, n, 3) and cls.shape == (b, n)
                and trans.shape == (b, 4, 4) and mask.shape == (b, n),
                f"request {i}: output shapes")
        require(all(bool(torch.isfinite(x).all()) for x in (sf, cls, trans)),
                f"request {i}: non-finite output")
        row = dict(request=i, batch=int(b), bucket=int(n),
                   latency_ms=1e3 * latency, frames_per_s=b / latency,
                   launches=counts, **frame_metrics(req, out))
        if i == 0:
            cpu_check = compare_with_cpu(model, req, out)
            row["vs_cpu"] = cpu_check
        emit(row)
    return launches


def main() -> int:
    # the kernels must build from this checkout's sources, not from a copy
    # of the package installed elsewhere
    here = Path(__file__).resolve().parent
    if Path(cmflow_tpu_torch.__file__).resolve().parents[1] != here:
        print(f"chip_smoke: cmflow_tpu_torch was imported from "
              f"{cmflow_tpu_torch.__file__}, not from {here}", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    dev = torch.device("cuda")

    t0 = time.perf_counter()
    libs = build.build()
    emit(dict(build_s=time.perf_counter() - t0,
              libraries=sorted(p.name for p in libs.values())))

    requests = [make_request(SEED + i, B, (200, 256)) for i in range(3)]
    requests.append(make_request(SEED + 3, B, (300, 384)))
    require([r["pc1"].shape[1] for r in requests] == [256, 256, 256, 384],
            "request buckets")
    gen = torch.Generator().manual_seed(SEED)

    model = build_model("cmflow", device=dev, seed=SEED)
    step = make_eval_step("cmflow", model)
    randomize_batchnorm(model, step, make_request(SEED + 99, B, (200, 256)),
                        gen)

    per_forward = check_kernels([requests[0], requests[3]], dev, gen)
    launches = serve(model, step, requests)

    kernels = []
    for name, acc in per_forward.items():
        source, replaces = SOURCES[name]
        bms, bby = bound_ms(acc["nbytes"], acc["flops"])
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=launches[name], max_abs_err=acc["max_abs_err"],
            ms=acc["ms"], plain_ms=acc["plain_ms"], bound_ms=bms,
            bound_by=bby,
            library_ms=acc["library_ms"] if acc["has_library"] else None))
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
