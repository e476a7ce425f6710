#!/usr/bin/env python3
"""Where ``three_nn`` on the card and on the CPU part ways, if they do.

    python scripts/diag_three_nn_bits.py

Runs ``pointops.three_nn`` and ``pointops.knn_with_dists`` on the same
seeded clouds (the shapes of ``tests/test_torch_cuda.py::
test_three_nn_on_card``, then those of PointNet++ SSG's two propagation
levels) on a CUDA device and on the CPU, and compares, operation by
operation, every intermediate of the distance: the inputs, the kNN indices
(K2 against the plain version), the gathered neighbours (K6 against the
plain gather), each product and partial sum of ``pair_square_distance``,
the clamp and the square root; then the full ``square_distance`` matrix.
Prints one JSON line per case with, for each step, the number of elements
whose bits differ and the first such element's values in hex.  Then, on
``SQRT_SAMPLES`` uniform float32 values in [0, 100) and in [0, 1), the
share of ``torch.sqrt`` results on each device, and of
``pointops.sqrt_rn``'s, that differ from numpy's correctly rounded
``np.sqrt``.  Needs a CUDA device; exits with code 1 without one.
"""

from __future__ import annotations

import json
import struct
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from cmflow_tpu_torch.ops import neighbors, pointops  # noqa: E402

SQRT_SAMPLES = 10_000_000
# (batch, queries, points, scale, masked)
CASES = ((4, 300, 80, 4.0, False), (4, 300, 80, 4.0, True),
         (16, 1024, 512, 1.0, False), (16, 512, 128, 1.0, False))


def hexf(x: float) -> str:
    return struct.pack(">f", x).hex()


def steps(query, points, valid):
    """Every intermediate of ``three_nn``'s distance, in order."""
    out = {}
    idx = pointops.knn(3, query, points, valid)
    out["knn_idx"] = idx
    nb = pointops.group_points(points, idx)
    out["neighbours"] = nb
    q = query[:, :, None, :]
    cross = q[..., 0] * nb[..., 0]
    s2 = q[..., 0] * q[..., 0]
    d2 = nb[..., 0] * nb[..., 0]
    out["cross0"], out["s2_0"], out["d2_0"] = cross, s2, d2
    for c in range(1, 3):
        pc = q[..., c] * nb[..., c]
        out[f"prod_cross{c}"] = pc
        cross = cross + pc
        s2 = s2 + q[..., c] * q[..., c]
        d2 = d2 + nb[..., c] * nb[..., c]
        out[f"cross{c}"], out[f"s2_{c}"], out[f"d2_{c}"] = cross, s2, d2
    m2 = -2.0 * cross
    out["minus2cross"] = m2
    out["plus_s2"] = m2 + s2
    out["plus_d2"] = (m2 + s2) + d2
    out["pair_sq"] = pointops.pair_square_distance(query, nb)
    dist, _ = pointops.three_nn(query, points, valid)
    out["three_nn_dist"] = dist
    kd2, kidx = pointops.knn_with_dists(3, query, points, valid)
    out["knn_with_dists_d2"] = kd2
    out["knn_with_dists_idx"] = kidx
    out["sqrt_knn_with_dists"] = torch.sqrt(torch.clamp_min(kd2, 0.0))
    out["sqrt_rn_knn_with_dists"] = pointops.sqrt_rn(
        torch.clamp_min(kd2, 0.0))
    out["square_distance"] = neighbors.square_distance(query, points)
    return out


def compare(a: torch.Tensor, b: torch.Tensor) -> dict:
    a = a.detach().cpu()
    if a.dtype.is_floating_point:
        differ = a.view(torch.int32) != b.view(torch.int32)
    else:
        differ = a != b
    n = int(differ.sum())
    row = dict(differ=n, of=a.numel())
    if n and a.dtype.is_floating_point:
        at = tuple(int(i) for i in differ.nonzero()[0])
        row.update(at=at, card=hexf(float(a[at])), cpu=hexf(float(b[at])),
                   card_value=float(a[at]), cpu_value=float(b[at]))
    return row


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip(),
        flush=True)
    print(json.dumps(dict(torch=torch.__version__, cuda=torch.version.cuda)))
    rs = np.random.RandomState(0)
    any_differ = False
    for b, s, n, scale, masked in CASES:
        query = torch.from_numpy((rs.rand(b, s, 3) * scale)
                                 .astype(np.float32))
        points = torch.from_numpy((rs.rand(b, n, 3) * scale)
                                  .astype(np.float32))
        valid = None
        if masked:
            real = np.array([n - n // 4 - 3 * i for i in range(b)])
            valid = torch.from_numpy((rs.rand(b, n) > 0.2)
                                     & (np.arange(n)[None, :]
                                        < real[:, None]))
        cpu = steps(query, points, valid)
        card = steps(query.cuda(), points.cuda(),
                     None if valid is None else valid.cuda())
        torch.cuda.synchronize()
        rows = {k: compare(card[k], cpu[k]) for k in cpu}
        any_differ |= any(r["differ"] for r in rows.values())
        print(json.dumps(dict(case=dict(batch=b, queries=s, points=n,
                                        scale=scale, masked=masked),
                              steps=rows)), flush=True)
    print(json.dumps(dict(card_equals_cpu=not any_differ)))
    gen = torch.Generator().manual_seed(1)
    for scale in (100.0, 1.0):
        x = torch.rand(SQRT_SAMPLES, generator=gen) * scale
        want = torch.from_numpy(np.sqrt(x.numpy()))
        row = {}
        for name, fn in (("torch_sqrt", torch.sqrt),
                         ("sqrt_rn", pointops.sqrt_rn)):
            for where, arg in (("cpu", x), ("card", x.cuda())):
                got = fn(arg).cpu()
                row[f"{name}_{where}_ulp_off"] = int((got != want).sum())
        print(json.dumps(dict(sqrt_vs_numpy=dict(
            samples=SQRT_SAMPLES, range=[0.0, scale], **row))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
