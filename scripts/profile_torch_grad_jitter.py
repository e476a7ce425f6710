#!/usr/bin/env python3
"""How far the port's train-mode gradients move when the inputs move by a
rounding error: the reason the train step's gradient bar is a relative L2
bar and not ``1e-3`` of each leaf's largest entry.

    python scripts/profile_torch_grad_jitter.py [--device cpu]

Runs on the GPU, or on the CPU with ``--device cpu``.  For one full-width
propagation-encoder scale
(``PointLocalFeature`` 512-256-64, mlp2 64-64-64) at each K of the model, on a synthetic B=2, N=64 cloud, it takes the
train-mode gradient of ``sum(out * r)`` in every parameter, once as is and
once with the input features moved by ``eps`` of their size, and prints
per (K, eps) the worst leaf's ``max|d| / max|g|`` and the worst leaf's
relative L2 error.  A max over neighbours picks another row when a near
tie moves, so single entries jump while the L2 error stays small.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from cmflow_tpu_torch.data.synthetic import make_train_batch  # noqa: E402
from cmflow_tpu_torch.models.convert import export_flax_variables  # noqa: E402
from cmflow_tpu_torch.nn import blocks  # noqa: E402
from cmflow_tpu_torch.utils.device import resolve_device  # noqa: E402

SCALES = ((4.0, 8), (8.0, 16), (16.0, 32))
EPS = (1e-7, 1e-6, 1e-5)


def leaves(tree, prefix=""):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from leaves(value, f"{prefix}{key}/")
        else:
            yield prefix + key, value


def grads(module, xyz, feat, r):
    module.zero_grad()
    (module(xyz, feat, True) * r).sum().backward()
    return dict(leaves(export_flax_variables(module, grads=True)["params"]))


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--device", default=None,
                        help="cpu for the CPU; the GPU by default")
    dev = resolve_device(parser.parse_args().device)
    rs = np.random.RandomState(0)
    xyz = torch.as_tensor(make_train_batch(0, 2, 64)["pc1"], device=dev)
    feat, r, noise = (torch.as_tensor(rs.randn(2, 64, 64).astype(np.float32),
                                      device=dev) for _ in range(3))
    for radius, k in SCALES:
        module = blocks.PointLocalFeature(radius, k, 64, (512, 256, 64),
                                          (64, 64, 64))
        blocks.init_parameters(module, torch.Generator().manual_seed(0))
        module.to(dev)
        base = grads(module, xyz, feat, r)
        for eps in EPS:
            moved = grads(module, xyz, feat * (1 + eps * noise), r)
            max_ratio = {n: float(np.abs(moved[n] - g).max() / np.abs(g).max())
                         for n, g in base.items()}
            l2 = {n: float(np.linalg.norm(moved[n] - g) / np.linalg.norm(g))
                  for n, g in base.items()}
            worst = max(max_ratio, key=max_ratio.get)
            print(json.dumps(dict(
                device=str(dev), k=k, eps=eps,
                worst_leaf=worst, worst_max_over_max=max_ratio[worst],
                worst_leaf_rel_l2=max(l2.values()),
                leaves_over_1e_3=sum(v > 1e-3 for v in max_ratio.values()),
                leaves=len(base))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
