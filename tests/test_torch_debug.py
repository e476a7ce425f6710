"""The port's debugging switches on the CPU: ``nan_check`` (the JAX
package's ``jax_debug_nans``) and ``profile_dir`` (its ``jax.profiler``
trace).

* A batch with a NaN in ``pc1``: the JAX package's train step under
  ``jax.debug_nans(True)`` (for this call only) and the port's
  ``nan_check`` step both raise ``FloatingPointError``; so does the port's
  eval step.  A NaN that first appears in the gradients is named there.
* On a clean batch the checked step gives the unchecked step's bits.
* A CLI run with ``--profile_dir`` writes a Chrome trace that parses and
  names the train step's ops; ``nan_check: true`` through the CLI trains to
  the bits of the same run without it.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmflow_tpu.models import build_model as jax_build_model
from cmflow_tpu.train import steps as jsteps
from cmflow_tpu.train.state import TrainState as JaxTrainState
from cmflow_tpu.train.state import make_optimizer as jax_make_optimizer
from cmflow_tpu_torch.cli import main as climain
from cmflow_tpu_torch.data.synthetic import (
    make_request,
    make_train_batch,
    write_synthetic_dataset,
)
from cmflow_tpu_torch.data.vod import VOD_CAMERA_PROJECTION, VOD_T_CAMERA_RADAR
from cmflow_tpu_torch.models import build_model
from cmflow_tpu_torch.models.convert import export_flax_variables
from cmflow_tpu_torch.train.state import create_train_state
from cmflow_tpu_torch.train.steps import (
    check_nan,
    make_eval_step,
    make_train_step,
)

P, TCR = VOD_CAMERA_PROJECTION, VOD_T_CAMERA_RADAR


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def poisoned(batch):
    out = {k: v.copy() for k, v in batch.items()}
    out["pc1"][0, 5, 1] = np.nan
    return out


def test_jax_and_port_raise_on_a_nan_input():
    batch = poisoned(make_train_batch(0, 2, 32))
    jmodel = jax_build_model("cmflow")
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    variables = jmodel.init({"params": jax.random.PRNGKey(0)},
                            *[jb[k] for k in ("pc1", "pc2", "ft1", "ft2",
                                              "mask")], True)
    tx = jax_make_optimizer(lr=1e-3, steps_per_epoch=10)
    state = JaxTrainState(step=jnp.zeros((), jnp.int32),
                          params=variables["params"],
                          batch_stats=variables["batch_stats"],
                          opt_state=tx.init(variables["params"]), tx=tx)
    with jax.debug_nans(True):
        with pytest.raises(FloatingPointError):
            jsteps.make_train_step("cmflow", jmodel, P, TCR)(state, jb)
    assert not jax.config.jax_debug_nans  # set for that call only

    model = build_model("cmflow", device="cpu", seed=0)
    step = make_train_step("cmflow", model, P, TCR, nan_check=True)
    with torch.autograd.set_detect_anomaly(True):
        with pytest.raises(FloatingPointError, match="input pc1"):
            step(create_train_state(model), batch)
    req = make_request(1, 2, (40, 64))
    req["pc1"] = req["pc1"].copy()
    req["pc1"][1, 3, 0] = np.nan
    with pytest.raises(FloatingPointError, match="input pc1"):
        make_eval_step("cmflow", model, fused="off", nan_check=True)(req)


def test_nan_named_where_it_is_held():
    with pytest.raises(FloatingPointError, match="loss item egoLoss"):
        check_nan("loss item", {"Loss": torch.tensor(1.0),
                                "egoLoss": torch.tensor(float("nan")),
                                "count": torch.tensor(3)})
    check_nan("gradient of", {"w": torch.zeros(3), "none": None})


def test_nan_in_the_backward_raises():
    """A NaN made in the backward, from a finite forward: anomaly mode
    finds it and the step raises ``FloatingPointError``."""
    model = build_model("raflow", device="cpu", seed=1)
    step = make_train_step("raflow", model, P, TCR, nan_check=True)
    batch = make_train_batch(1, 2, 32)

    class NanGrad(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            return x.clone()

        @staticmethod
        def backward(ctx, g):
            return g * float("nan")

    fp = model.fp.out
    real = fp.forward
    fp.forward = lambda x: NanGrad.apply(real(x))
    with torch.autograd.set_detect_anomaly(True):
        with pytest.raises(FloatingPointError, match="nan"):
            step(create_train_state(model), batch)


def test_checked_step_gives_the_same_bits():
    batch = make_train_batch(2, 2, 32)
    out = []
    for check in (False, True):
        model = build_model("cmflow", device="cpu", seed=2)
        state = create_train_state(model)
        step = make_train_step("cmflow", model, P, TCR, nan_check=check)
        with torch.autograd.set_detect_anomaly(check):
            items = step(state, batch)
        out.append(({k: float(v) for k, v in items.items()},
                    export_flax_variables(model),
                    export_flax_variables(model, grads=True)))
    assert out[0][0] == out[1][0]
    for a, b in zip(jax.tree_util.tree_leaves(out[0][1:]),
                    jax.tree_util.tree_leaves(out[1][1:])):
        np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("tree"))
    write_synthetic_dataset(root, {"train": 4, "val": 2, "test": 2},
                            clips_per_partition=1, seed=3, n_range=(70, 90))
    return root


def cli(tree, tmp_path, name, *extra):
    cfg = tmp_path / "c.yaml"
    cfg.write_text("num_points: 64\neval_pad_multiple: 64\n"
                   "data_parallel: false\n")
    assert climain.main(
        ["--config", str(cfg), "--platform", "cpu", "--dataset_path", tree,
         "--checkpoints_dir", str(tmp_path / "ck"), "--num_workers", "0",
         "--epochs", "1", "--batch_size", "2", "--eval_batch_size", "2",
         "--exp_name", name, *extra]) == 0
    return tmp_path / "ck" / name


@pytest.mark.parametrize("remat", [False, "dots"])
def test_cli_profile_dir_writes_a_trace(tree, tmp_path, remat):
    """The trace names the train step's ops: on the CPU the plain ball
    query's and kNN's sort, the plain gather, the products and Adam; under
    ``remat: dots`` also the point ops as custom ops."""
    exp = cli(tree, tmp_path, "prof", "--profile_dir", str(tmp_path / "p"),
              *(["--remat", remat] if remat else []))
    path = tmp_path / "p" / "trace.json"
    with open(path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    want = ["aten::sort", "aten::gather", "Optimizer.step#Adam.step",
            "aten::mm"]
    custom = ["cmflow::ball_query", "cmflow::knn", "cmflow::gather_rows"]
    if remat == "dots":
        want += custom
    else:
        assert not names & set(custom)
    for op in want:
        assert op in names, op
    assert f"profiler trace: {path}" in (exp / "run.log").read_text()


def test_cli_nan_check_gives_the_same_bits(tree, tmp_path):
    runs = []
    for name, extra in (("plain", ""), ("checked", "nan_check: true\n")):
        cfg = tmp_path / f"{name}.yaml"
        cfg.write_text("num_points: 64\neval_pad_multiple: 64\n"
                       "data_parallel: false\n" + extra)
        assert climain.main(
            ["--config", str(cfg), "--platform", "cpu", "--dataset_path",
             tree, "--checkpoints_dir", str(tmp_path / "ck"),
             "--num_workers", "0", "--epochs", "1", "--batch_size", "2",
             "--eval_batch_size", "2", "--exp_name", name]) == 0
        runs.append(torch.load(tmp_path / "ck" / name / "models" / "last",
                               weights_only=True)["model"])
    assert not torch.is_anomaly_enabled()  # the run's setting, undone
    for k, v in runs[0].items():
        assert torch.equal(v, runs[1][k]), k
