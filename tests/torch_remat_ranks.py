"""What each rank of the port's data-parallel recomputation test computes
(tests/test_torch_remat.py): the CMFlow step of ``torch_dp_ranks`` on the
rank's rows, once per ``remat`` mode, each from fresh seeded weights.  The
ranks import the port and nothing of JAX."""

from __future__ import annotations

import os

import torch

import torch_dp_ranks as R
from cmflow_tpu_torch.models import build_model
from cmflow_tpu_torch.models.convert import export_flax_variables
from cmflow_tpu_torch.parallel import mesh
from cmflow_tpu_torch.train.state import create_train_state
from cmflow_tpu_torch.train.steps import make_train_step

MODES = (False, "dots")


def rank_remat(dp: mesh.DataParallel, out_dir: str) -> None:
    """A rank's entry (``mesh.spawn``): one CMFlow step in each mode of
    MODES on its rows, the items, gradients and variables after the step
    saved."""
    torch.set_num_threads(1)
    rows = mesh.shard_batch(R.train_batch(), dp.group)
    out = {}
    for remat in MODES:
        model = build_model("cmflow", device="cpu",
                            seed=R.MODEL_SEED["cmflow"], group=dp.group,
                            remat=remat)
        state = create_train_state(model, steps_per_epoch=R.STEPS_PER_EPOCH)
        step = make_train_step("cmflow", model, R.P, R.TCR, group=dp.group)
        items = step(state, rows)
        out[str(remat)] = dict(
            items={k: float(v) for k, v in items.items()},
            grads=export_flax_variables(model, grads=True)["params"],
            after=export_flax_variables(model))
    torch.save(out, os.path.join(out_dir, f"rank{dp.rank}.pt"))
