"""Recomputation (``remat``) in the port's train steps, on the CPU.

``remat`` (the config's key; the JAX package's ``remat_wrap``) runs each
sa- and propagation-encoder branch and the cost volume under
``torch.utils.checkpoint``: ``True`` recomputes all of them in the
backward, ``"dots"`` keeps the neighbour indices, every gather's output
and every pre-BN product and recomputes only the BatchNorm and activation
chains.  Recomputation repeats the first run's operations, so every family's
step gives the bits of ``remat: false``: loss items, gradients, the
parameters after Adam and the BatchNorm statistics (updated once).  The
port's ``"dots"`` step meets the train step's bars against the JAX
package's ``"dots"`` step (tests/test_torch_train.py: loss items rtol 1e-4,
statistics atol 1e-5, gradients relative L2 3e-2 a leaf and 1e-2 whole).
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import unfreeze

import torch_remat_ranks
from cmflow_tpu.models import build_model as jax_build_model
from cmflow_tpu.train import steps as jsteps
from cmflow_tpu_torch.cli import main as climain
from cmflow_tpu_torch.data.synthetic import (
    make_train_batch,
    write_synthetic_dataset,
)
from cmflow_tpu_torch.data.vod import VOD_CAMERA_PROJECTION, VOD_T_CAMERA_RADAR
from cmflow_tpu_torch.models import build_model
from cmflow_tpu_torch.models.convert import (
    export_flax_variables,
    load_flax_variables,
)
from cmflow_tpu_torch.nn import blocks
from cmflow_tpu_torch.ops import fused
from cmflow_tpu_torch.parallel import mesh
from cmflow_tpu_torch.train.state import create_train_state
from cmflow_tpu_torch.train.steps import make_train_step, make_train_step_seq
from cmflow_tpu_torch.utils import config

P, TCR = VOD_CAMERA_PROJECTION, VOD_T_CAMERA_RADAR


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(a)
            for p, a in jax.tree_util.tree_flatten_with_path(
                unfreeze(tree))[0]}


def assert_same_bits(a, b):
    a, b = leaves(a), leaves(b)
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.fixture
def gathers(monkeypatch):
    """A count of the row gathers run (the plain version stands in for K6 on
    the CPU)."""
    count = [0]
    real = fused.gather_rows_plain

    def counting(*a):
        count[0] += 1
        return real(*a)

    monkeypatch.setattr(fused, "gather_rows_plain", counting)
    return count


def one_step(name, remat, gathers):
    """One step of family ``name`` from its seeded weights: items,
    gradients, variables after the step and the gathers it ran."""
    model = build_model(name, device="cpu", seed=3, remat=remat)
    state = create_train_state(model, steps_per_epoch=10)
    if name == "cmflow_t":
        batch = make_train_batch(2, 2, 48)
        clip = {k: np.stack([v, v[::-1]], axis=1) for k, v in batch.items()}
        step, data = make_train_step_seq(model, P, TCR), clip
    else:
        step = make_train_step(name, model, P, TCR)
        data = make_train_batch(1, 2, 48)
    gathers[0] = 0
    items = step(state, data)
    return dict(items={k: float(v) for k, v in items.items()},
                grads=export_flax_variables(model, grads=True)["params"],
                after=export_flax_variables(model), gathers=gathers[0])


@pytest.mark.parametrize("name", ["cmflow", "raflow", "cmflow_t"])
def test_remat_modes_give_the_same_bits(name, gathers):
    plain = one_step(name, False, gathers)
    for mode in (True, "dots"):
        got = one_step(name, mode, gathers)
        assert got["items"] == plain["items"], mode
        assert_same_bits(got["grads"], plain["grads"])
        assert_same_bits(got["after"], plain["after"])
        if mode == "dots":  # every gather's output kept: none run again
            assert got["gathers"] == plain["gathers"]
        else:
            assert got["gathers"] > plain["gathers"]


def test_batchnorm_statistics_update_once():
    """A recomputed forward leaves the running statistics as one forward
    does."""
    model = build_model("cmflow", device="cpu", seed=4, remat=True)
    ref = build_model("cmflow", device="cpu", seed=4)
    b = make_train_batch(3, 2, 48)
    x = [torch.from_numpy(b[k]) for k in ("pc1", "pc2", "ft1", "ft2")]
    for m in (model, ref):
        out = m(*x, torch.from_numpy(b["mask"]), True)
        (out[0].sum() + out[1].sum()).backward()
    for (k, a), (_, c) in zip(model.state_dict().items(),
                              ref.state_dict().items()):
        assert torch.equal(a, c), k
    assert not blocks.recomputing()


def test_bad_remat_raises():
    for bad in ("dot", "on", 1, "full"):
        with pytest.raises(ValueError, match="remat"):
            config.Config(remat=bad)
        with pytest.raises(ValueError, match="remat"):
            build_model("cmflow", device="cpu", remat=bad)
    for good in (False, None, True, "dots"):
        blocks.check_remat(good)


def test_no_checkpoint_without_a_gradient(monkeypatch):
    """Eval and ``no_grad`` forwards run the modules once, plainly."""
    calls = []
    monkeypatch.setattr(blocks, "checkpoint",
                        lambda *a, **kw: calls.append(1))
    model = build_model("cmflow", device="cpu", seed=5, remat="dots")
    b = make_train_batch(3, 1, 32)
    x = [torch.from_numpy(b[k]) for k in ("pc1", "pc2", "ft1", "ft2")]
    with torch.no_grad():
        model(*x, None, False)
        model(*x, torch.from_numpy(b["mask"]), True)
    assert not calls


def test_dots_against_jax_remat_step():
    """The port's "dots" step against the JAX package's "dots" model, from
    the same flax variables, at the train step's bars."""
    batch = make_train_batch(0, 2, 64)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jmodel = jax_build_model("cmflow", SimpleNamespace(remat="dots"))
    inputs = [jb[k] for k in ("pc1", "pc2", "ft1", "ft2", "mask")]
    variables = jax.tree_util.tree_map(np.asarray, unfreeze(jax.jit(
        lambda key: jmodel.init({"params": key}, *inputs, True))(
            jax.random.PRNGKey(0))))

    def loss(params):
        return jsteps._frame_loss("cmflow", jmodel, params,
                                  variables["batch_stats"], jb,
                                  jnp.asarray(P), jnp.asarray(TCR), 0.3)

    (_, (items, stats, _)), grads = jax.jit(jax.value_and_grad(
        loss, has_aux=True))(variables["params"])

    model = build_model("cmflow", device="cpu", seed=3, remat="dots")
    load_flax_variables(model, variables)
    state = create_train_state(model, steps_per_epoch=10)
    got = make_train_step("cmflow", model, P, TCR)(state, batch)
    for k, v in items.items():
        np.testing.assert_allclose(float(got[k]), float(v), rtol=1e-4,
                                   err_msg=k)
    g = leaves(export_flax_variables(model, grads=True)["params"])
    w = leaves(grads)
    assert sorted(g) == sorted(w)
    rel = {k: float(np.linalg.norm(g[k] - w[k]) / np.linalg.norm(w[k]))
           for k in w}
    assert not {k: v for k, v in rel.items() if not v <= 3e-2}, rel
    whole = np.sqrt(sum(np.sum((g[k] - w[k]) ** 2) for k in w)
                    / sum(np.sum(w[k] ** 2) for k in w))
    assert whole <= 1e-2, whole
    gs = leaves(export_flax_variables(model)["batch_stats"])
    ws = leaves(stats)
    assert sorted(gs) == sorted(ws)
    for k in ws:
        np.testing.assert_allclose(gs[k], ws[k], rtol=0, atol=1e-5,
                                   err_msg=k)


def test_cli_trains_with_remat_dots(tmp_path):
    tree = str(tmp_path / "tree")
    write_synthetic_dataset(tree, {"train": 4, "val": 2, "test": 2},
                            clips_per_partition=1, seed=2, n_range=(70, 90))
    args = ["--platform", "cpu", "--dataset_path", tree, "--checkpoints_dir",
            str(tmp_path / "ck"), "--num_workers", "0", "--epochs", "1",
            "--batch_size", "2", "--eval_batch_size", "2"]
    cfg = tmp_path / "c.yaml"
    cfg.write_text("num_points: 64\neval_pad_multiple: 64\n"
                   "data_parallel: false\n")
    runs = {}
    for name, extra in (("plain", []), ("dots", ["--remat", "dots"])):
        assert climain.main(["--config", str(cfg), "--exp_name", name]
                            + args + extra) == 0
        runs[name] = torch.load(tmp_path / "ck" / name / "models" / "last",
                                weights_only=True)["model"]
        log = (tmp_path / "ck" / name / "run.log").read_text()
        assert "mean train loss" in log
    assert "remat='dots'" in (tmp_path / "ck" / "dots" / "run.log").read_text()
    for k, v in runs["plain"].items():
        assert torch.equal(v, runs["dots"][k]), k


def test_two_ranks_dots_give_the_bits_of_false(tmp_path):
    mesh.spawn(torch_remat_ranks.rank_remat, (str(tmp_path),), 2, "cpu")
    ranks = [torch.load(tmp_path / f"rank{r}.pt", weights_only=False)
             for r in range(2)]
    for out in ranks:
        plain, dots = out["False"], out["dots"]
        assert plain["items"] == dots["items"]
        assert_same_bits(plain["grads"], dots["grads"])
        assert_same_bits(plain["after"], dots["after"])
    assert_same_bits(ranks[0]["dots"]["after"], ranks[1]["dots"]["after"])
