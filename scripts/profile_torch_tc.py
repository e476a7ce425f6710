#!/usr/bin/env python3
"""The tensor-core kernels K5 (``csrc/plf.cu``) and K4a
(``csrc/cost_volume.cu::cv_p2p_kernel``) across neighbour counts, on one GPU.

    python scripts/profile_torch_tc.py

At B=16, N=256, with seeded full-width weights and random features and
neighbour indices (some outside [0, N), which gather a zero row), for K5 at
k in {1, 3, 4, 8, 16, 32, 33, 64} and K4a at k in {1, 5, 8, 32}: the
kernel's max abs error against its plain version and the output's largest
magnitude (the bars are 1e-4 and 1e-5 of it), whether two launches give the
same bits, the kernel's own device time and that of cuBLAS float32 on the
same products alone (``torch.profiler``, 20 warmed calls), and the bound of
its arithmetic in 3xTF32 at 495 TFLOP/s.  One JSON line per case.  Needs a
CUDA device; exits with code 1 without one.
"""

from __future__ import annotations

import json
import subprocess
import sys
import warnings
from pathlib import Path

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from cmflow_tpu_torch.nn import blocks  # noqa: E402
from cmflow_tpu_torch.ops import fused  # noqa: E402

B, N = 16, 256
ITERS = 20
TF32_FLOP_PER_S = 495e12


def seeded(module, seed: int, dev):
    gen = torch.Generator().manual_seed(seed)
    blocks.init_parameters(module, gen)
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, blocks.BatchNorm):
                m.weight.uniform_(0.7, 1.3, generator=gen)
                m.bias.uniform_(-0.2, 0.2, generator=gen)
                m.running_mean.uniform_(-0.1, 0.1, generator=gen)
                m.running_var.uniform_(0.5, 2.0, generator=gen)
    return module.to(dev)


def device_ms(fn, kernel: str = "") -> float:
    """Summed durations of the kernels of one ``fn()`` whose names hold
    ``kernel``."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(ITERS):
                fn()
            torch.cuda.synchronize()
        return sum(e.self_device_time_total for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and kernel in e.key
                   ) / 1e3 / ITERS


def case(name, k, run, plain, widths, kernel, dev):
    got, again, want = run(), run(), plain()
    torch.cuda.synchronize()
    rows = B * N * k
    xs = [torch.randn((rows, c), device=dev) for c in widths[:-1]]
    ws = [torch.randn((c, o), device=dev)
          for c, o in zip(widths[:-1], widths[1:])]
    flops = 2 * rows * sum(c * o for c, o in zip(widths[:-1], widths[1:]))
    print(json.dumps(dict(
        kernel=name, k=k,
        max_abs_err=float((got.double() - want.double()).abs().max()),
        plain_max_abs=float(want.abs().max()),
        same_bits=bool(torch.equal(got, again)),
        kernel_ms=device_ms(run, kernel),
        cublas_products_ms=device_ms(lambda: [x @ w for x, w in zip(xs, ws)]),
        bound_3xtf32_ms=1e3 * 3 * flops / TF32_FLOP_PER_S)), flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip(),
        flush=True)
    dev = torch.device("cuda")
    rs = np.random.RandomState(0)

    def randn(*shape):
        return torch.from_numpy(rs.randn(*shape).astype(np.float32)).to(dev)

    pc = torch.from_numpy((rs.rand(B, N, 3) * 20).astype(np.float32)).to(dev)
    f1, f2, z1, z2 = randn(B, N, 512), randn(B, N, 512), randn(B, N, 8), \
        randn(B, N, 8)
    with torch.no_grad():
        plf = seeded(blocks.PointLocalFeature(4.0, 8, 1027, (512, 256, 64),
                                              (64, 64, 64)), 2, dev)
        chain, _, _ = fused.plf_params_from_variables(plf)
        for k in (1, 3, 4, 8, 16, 32, 33, 64):
            idx = torch.from_numpy(rs.randint(-1, N, (B, N, k)).astype(
                np.int32)).to(dev)
            case("plf", k,
                 lambda: fused.fused_point_local_feature(f1, idx, pc, chain),
                 lambda: fused.fused_point_local_feature_plain(f1, idx, pc,
                                                               chain),
                 fused.PLF_WIDTHS, "plf_kernel", dev)
        fc = seeded(blocks.FeatureCorrelator(8, 512, 512, (512, 512, 512)),
                    3, dev)
        dense, wn1, _ = fused.cv_params_from_variables(fc)
        for k in (1, 5, 8, 32):
            idx = torch.from_numpy(rs.randint(-1, N, (B, N, k)).astype(
                np.int32)).to(dev)
            args = (f1, f2, idx, z1, z2, dense[1:], wn1[1:])
            case("cv", k, lambda: fused.cost_volume_p2p(*args),
                 lambda: fused.cost_volume_p2p_plain(*args), (512,) * 3,
                 "cv_p2p_kernel", dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
