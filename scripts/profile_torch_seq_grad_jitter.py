#!/usr/bin/env python3
"""How far the gradients of CMFlow_T's mini-clip step move between the card
and the CPU, and on the card when the inputs move by a rounding error.

    python scripts/profile_torch_seq_grad_jitter.py [--case CASE.npz
        --save FILE.npz]

Needs a GPU.  For each seed of SEEDS, a full-width CMFlow_T with weights
from that seed takes one T=2 ``make_train_step_seq`` step at learning rate 0 (so the
second frame sees the first frame's weights, and its carry) on B=16, N=256
synthetic frames; the gradients left in the model are the second frame's.
For each clip (two distinct frames, or the first frame twice) it prints one
JSON line per pair of runs: card against CPU, and card against the card
with every frame's features moved by ``eps`` of their size, each with the
worst leaf's relative L2 error, the median leaf's and the whole gradient's.

``--case CASE.npz --save FILE.npz`` also takes that step on the card on
the CPU tests' case, which ``python tests/test_torch_cmflow_t.py case
CASE.npz`` writes (the weights and the two B=2, N=64 frames, so that no
random draw has to agree between machines): on the first frame twice and
on the two frames, and writes both second frames' gradients to
``FILE.npz`` (keys ``card|0,1|['trunk'][...]``; 35 MiB), which ``python
tests/test_torch_cmflow_t.py gradients FILE.npz`` holds to the JAX package
on a machine that has it.
"""

from __future__ import annotations

import argparse
import copy
import json
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from cmflow_tpu_torch.data.synthetic import make_train_batch  # noqa: E402
from cmflow_tpu_torch.data.vod import (  # noqa: E402
    VOD_CAMERA_PROJECTION,
    VOD_T_CAMERA_RADAR,
)
from cmflow_tpu_torch.models import build_model  # noqa: E402
from cmflow_tpu_torch.models.convert import export_flax_variables  # noqa: E402
from cmflow_tpu_torch.train.state import create_train_state  # noqa: E402
from cmflow_tpu_torch.train.steps import make_train_step_seq  # noqa: E402

B, N = 16, 256
SEEDS = (30, 31, 32)
EPS = (1e-7, 1e-6)


def leaves(tree, prefix=""):
    """``{"['a']['b']": array}``, the key form of ``jax.tree_util.keystr``."""
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from leaves(value, f"{prefix}['{key}']")
        else:
            yield f"{prefix}['{key}']", value


def second_frame_grads(model, clip) -> dict:
    state = create_train_state(model, lr=0.0)
    make_train_step_seq(model, VOD_CAMERA_PROJECTION,
                        VOD_T_CAMERA_RADAR)(state, clip)
    return dict(leaves(export_flax_variables(model, grads=True)["params"]))


def distance(got: dict, want: dict) -> dict:
    rel = {k: float(np.linalg.norm(got[k] - w) / np.linalg.norm(w))
           for k, w in want.items() if np.linalg.norm(w) > 0}
    worst = max(rel, key=rel.get)
    whole = (sum(float(np.sum((got[k] - w) ** 2)) for k, w in want.items())
             / sum(float(np.sum(w ** 2)) for w in want.values())) ** 0.5
    return dict(worst_leaf=worst, worst_leaf_rel_l2=rel[worst],
                median_leaf_rel_l2=float(np.median(list(rel.values()))),
                whole_rel_l2=whole)


def clips_of(frames):
    return (("two frames", (0, 1)), ("first frame twice", (0, 0))), {
        pick: {k: np.stack([frames[i][k] for i in pick], axis=1)
               for k in frames[0]} for pick in ((0, 1), (0, 0))}


def jitter(seed: int, dev) -> None:
    model = build_model("cmflow_t", dev, seed=seed)
    frames = [make_train_batch(seed + i, B, N) for i in range(2)]
    names, clips = clips_of(frames)
    rs = np.random.RandomState(0)
    for name, pick in names:
        clip = clips[pick]
        card = second_frame_grads(copy.deepcopy(model), clip)
        cpu = second_frame_grads(copy.deepcopy(model).to("cpu"), clip)
        print(json.dumps(dict(seed=seed, clip=name, pair="card vs cpu",
                              **distance(card, cpu))), flush=True)
        for eps in EPS:
            moved = dict(clip)
            noise = rs.randn(*clip["ft1"].shape).astype(np.float32)
            moved["ft1"] = (clip["ft1"] * (1 + eps * noise)).astype(
                np.float32)
            again = second_frame_grads(copy.deepcopy(model), moved)
            print(json.dumps(dict(seed=seed, clip=name,
                                  pair=f"card vs card, eps {eps}",
                                  **distance(again, card))), flush=True)


def save_test_case(case: str, path: str, dev) -> None:
    saved = np.load(case)
    model = build_model("cmflow_t", dev)
    model.load_state_dict({k.split("|", 1)[1]: torch.from_numpy(saved[k])
                           for k in saved.files if k.startswith("state|")})
    frames = [{k.split("|", 1)[1]: saved[k] for k in saved.files
               if k.startswith(f"frame{i}|")} for i in range(2)]
    names, clips = clips_of(frames)
    out = {}
    for _, pick in names:
        for k, g in second_frame_grads(copy.deepcopy(model),
                                       clips[pick]).items():
            out[f"card|{pick[0]},{pick[1]}|{k}"] = g
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    np.savez(path, **out)
    print(json.dumps(dict(saved=path, arrays=len(out))), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--case", default=None)
    ap.add_argument("--save", default=None)
    args = ap.parse_args()
    if (args.case is None) != (args.save is None):
        ap.error("--case and --save go together")
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    if args.save:
        save_test_case(args.case, args.save, dev)
    for seed in SEEDS:
        jitter(seed, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
