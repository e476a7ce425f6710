"""How far free-running CMFlow training drifts between runs that differ only
in float32 summation order, on the CPU.

    python scripts/dp_drift_torch.py [LR ...]

Trains CMFlow (full width, N=64) for two epochs of four B=4 steps on a
synthetic tree of 16 frames through the data-parallel loader and step, at
each learning rate given (default 0 and 1e-3): as one rank of a group of
one, as two ranks (gloo), and as one rank on three threads.  Prints each
run's loss at every step.  At learning rate 0 the runs agree step for step
(the same batches, the same forward and loss); at 1e-3 Adam moves every
parameter by about lr * sign(g), so a gradient sign that rounding flips sets
the runs apart within a few steps, two ranks or one on other thread
counts alike.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile

import torch

from cmflow_tpu_torch.data import BatchLoader, VodDataset
from cmflow_tpu_torch.data.synthetic import write_synthetic_dataset
from cmflow_tpu_torch.data.vod import VOD_CAMERA_PROJECTION, VOD_T_CAMERA_RADAR
from cmflow_tpu_torch.models import build_model
from cmflow_tpu_torch.parallel import mesh
from cmflow_tpu_torch.train.state import create_train_state
from cmflow_tpu_torch.train.steps import make_train_step

SEED = 1234
EPOCHS = 2


def train(dp, tree: str, out: str, lr: float, threads: int) -> None:
    """One rank: two epochs, its loss at every step saved by rank 0."""
    torch.set_num_threads(threads)
    ds = VodDataset(tree, "train", 64, False, seed=SEED, log=lambda s: None)
    loader = BatchLoader(ds, 4, shuffle=True, drop_last=True, num_workers=0,
                         seed=SEED, shard=(dp.rank, dp.size))
    model = build_model("cmflow", "cpu", seed=SEED, group=dp.group)
    state = create_train_state(model, steps_per_epoch=len(loader), lr=lr)
    step = make_train_step("cmflow", model, VOD_CAMERA_PROJECTION,
                           VOD_T_CAMERA_RADAR, group=dp.group)
    losses = []
    for _ in range(EPOCHS):
        for batch in loader:
            items = step(state, {k: v for k, v in batch.items()
                                 if k not in ("valid1", "valid2")})
            losses.append(float(items["Loss"]))
    if dp.rank == 0:
        with open(out, "w") as f:
            json.dump(losses, f)


def main(argv) -> int:
    lrs = [float(a) for a in argv] or [0.0, 1e-3]
    with tempfile.TemporaryDirectory() as tmp:
        tree = os.path.join(tmp, "tree")
        write_synthetic_dataset(tree, {"train": 16, "val": 4, "test": 4},
                                seed=0)
        for lr in lrs:
            runs = {}
            for name, ranks, threads in (("1 rank, 1 thread", 1, 1),
                                         ("2 ranks, 1 thread", 2, 1),
                                         ("1 rank, 3 threads", 1, 3)):
                out = os.path.join(tmp, "losses.json")
                mesh.spawn(train, (tree, out, lr, threads), ranks, "cpu")
                with open(out) as f:
                    runs[name] = json.load(f)
            ref = runs["1 rank, 1 thread"]
            for name, losses in runs.items():
                rel = [abs(a - b) / abs(b) for a, b in zip(losses, ref)]
                print(json.dumps(dict(lr=lr, run=name, loss=losses,
                                      rel_to_1_rank=rel)))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
