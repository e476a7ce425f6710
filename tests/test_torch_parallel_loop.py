"""The port's experiment loop at two data-parallel ranks on the CPU (gloo,
a file store; what each rank runs is ``tests/torch_dp_ranks.py::
rank_loop``), on a tiny synthetic tree at full width:

* one epoch of CMFlow (B=4, 2 rows a rank, N=64): ``run.log`` and
  ``metrics.jsonl`` written once, by rank 0, and both checkpoints;
* its validation pass, sharded over the ranks (each rank's rows padded to
  their own bucket, on this tree not always the global batch's), against
  the one-process evaluation of the checkpoint it chose: every metric
  within 1e-5;
* a ``batch_size`` that does not divide over the ranks raises, as the JAX
  loop's does;
* a checkpoint taken after three steps and restored on both ranks gives,
  two steps on, the bits of the run that never stopped; both ranks hold
  the same bits;
* a checkpoint written by the two-rank run restores into one process, and
  one written by one process restores into the two ranks.
"""

import json
import os

import numpy as np
import pytest
import torch

import torch_dp_ranks as R
from cmflow_tpu_torch.data import VodDataset
from cmflow_tpu_torch.data.synthetic import write_synthetic_dataset
from cmflow_tpu_torch.models import build_model
from cmflow_tpu_torch.parallel import mesh
from cmflow_tpu_torch.train import loop
from cmflow_tpu_torch.train.state import create_train_state
from cmflow_tpu_torch.utils import config


class _Quiet:
    def cprint(self, text):
        pass


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The tree, a one-process checkpoint, then the two ranks' run."""
    root = tmp_path_factory.mktemp("dp")
    tree = str(root / "tree")
    write_synthetic_dataset(tree, {"train": 8, "val": 6, "test": 3},
                            clips_per_partition=1, seed=1, n_range=(100, 150))
    cfg_kw = dict(exp_name="dp", dataset_path=tree, epochs=1, batch_size=4,
                  num_points=64, num_workers=0, eval_batch_size=4,
                  eval_buckets=(128, 192), eval_pad_multiple=64,
                  checkpoints_dir=str(root / "ckpt"), platform="cpu")
    one_ckpt = str(root / "one_process")
    loop.save_checkpoint(one_ckpt, create_train_state(
        build_model("cmflow", "cpu", seed=5), steps_per_epoch=2))
    mesh.spawn(R.rank_loop, (cfg_kw, str(root), one_ckpt), 2, "cpu")
    ranks = [torch.load(root / f"rank{r}.pt", weights_only=False)
             for r in range(2)]
    return dict(cfg=config.Config(**cfg_kw), ranks=ranks, root=root,
                exp=root / "ckpt" / "dp")


def test_rank0_writes_the_run_once(run):
    log = (run["exp"] / "run.log").read_text()
    assert log.count("data-parallel over 2 ranks (gloo), 2 rows a rank") == 1
    assert log.count("mean train loss") == 1
    assert log.count("mean RNE score") == 1
    rows = [json.loads(line) for line in open(run["exp"] / "metrics.jsonl")]
    assert [(r["epoch"], r["phase"]) for r in rows] == [(0, "train"),
                                                        (0, "val")]
    assert all(np.isfinite(v) for k, v in rows[0].items() if k != "phase")
    for name in ("best", "last"):
        assert os.path.isfile(run["exp"] / "models" / name)
    assert [r["summary"]["best_rne"] for r in run["ranks"]] == [
        rows[1]["rne"]] * 2


def test_sharded_validation_against_one_process(run):
    """The validation pass of the two ranks against one process's
    evaluation of the same weights, the checkpoint that pass chose."""
    rows = [json.loads(line) for line in open(run["exp"] / "metrics.jsonl")]
    state = loop.restore_checkpoint(
        str(run["exp"] / "models" / "best"),
        create_train_state(build_model("cmflow", "cpu")))
    got = rows[1]
    want = loop.evaluate_frames(
        run["cfg"], state.model,
        VodDataset(run["cfg"].dataset_path, "val", 64, True,
                   log=lambda s: None), _Quiet())
    want = {k: v for d in want for k, v in d.items()}
    assert sorted(want) == sorted(k for k in got
                                  if k not in ("epoch", "phase", "ts"))
    for k, v in want.items():
        assert abs(got[k] - v) <= 1e-5, (k, got[k], v)


def test_rank_buckets_differ_on_this_tree(run):
    """The tree puts rank 0's rows of the first val batch in a smaller
    bucket than rank 1's (and than one process's, 192), so the pass above
    held a rank's padding that differs from one process's."""
    ds = VodDataset(run["cfg"].dataset_path, "val", 64, True,
                    log=lambda s: None)
    buckets = [[b["pc1"].shape[1] for b in loop.BatchLoader(
        ds, 4, pad_bucket=64, pad_buckets=[64, 128, 192], num_workers=0,
        pad_batch=True, shard=(r, 2))] for r in range(2)]
    assert buckets == [[128, 192], [192, 192]]


def test_batch_size_must_divide_over_the_ranks(run):
    for rank in run["ranks"]:
        assert "not divisible by the 2-rank data-parallel group" in \
            rank["odd_batch"]


def test_resume_gives_the_bits_of_the_run_that_never_stopped(run):
    assert [r["resumed_same_bits"] for r in run["ranks"]] == [True, True]
    assert R.same_bits(*(r["final"] for r in run["ranks"]))
    assert run["ranks"][0]["final"]["step"] == R.LOOP_STEPS


def test_checkpoints_cross_between_one_process_and_the_ranks(run):
    assert [r["one_process_restored"] for r in run["ranks"]] == [True, True]
    state = loop.restore_checkpoint(
        str(run["root"] / "resume"),
        create_train_state(build_model("cmflow", "cpu", seed=9)))
    assert state.step == 3
    payload = torch.load(run["root"] / "resume", weights_only=True)
    for k, v in state.model.state_dict().items():
        assert torch.equal(v, payload["model"][k]), k
