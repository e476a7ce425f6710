"""Port parity: data-parallel training and evaluation of ``cmflow_tpu_torch``
(two ranks, one process each, gloo on the CPU, met through a file store)
against the JAX package's ``shard_map`` steps on two of the fake CPU devices
(``parallel.mesh.make_mesh(num_devices=2)``), and against the port in one
process on the same global batch.  Full width, B=4 (2 rows a rank), N=48;
what each rank computes is ``tests/torch_dp_ranks.py``.  This file holds
the pieces, the CMFlow step and the eval;
``tests/test_torch_parallel_families.py`` the RaFlow and CMFlow_T steps.

Bars:
* ``BatchNorm(group=)`` against flax ``BatchNorm(axis_name=)``: output and
  running statistics atol 1e-5, the input gradient within 1e-5 of its
  largest magnitude;
* ``motion_seg_loss`` (``_global_ratio``'s data-parallel form): each rank's
  term and gradient against the JAX device's, rtol 1e-5;
* the CMFlow and RaFlow pair steps and CMFlow_T's T=1 clip step against
  JAX's 2-device steps: loss items rtol 1e-4, BatchNorm statistics atol
  1e-5, parameters after Adam atol 5e-3 (tests/test_train.py:187-195);
  CMFlow_T at T=2 finite (tests/test_train.py:207-248);
* gradients before Adam, the pmean over the ranks, at the train bars
  (relative L2 3e-2 a leaf, 1e-2 whole; tests/test_torch_train.py): against
  the JAX package's 2-device gradients (CMFlow), and against the port's
  one-process step on the global batch (all three families);
* the parameters and statistics after a step bit-identical on both ranks;
* the sharded eval, each rank's rows on the module and the fused route,
  against one process: atol 1e-5 (tests/test_train.py:250-272).

The input.  On ``make_train_batch(s, 4, 48)`` for seeds 1-3 every pair of
CMFlow gradients (JAX on one device and on two, the port in one process
and on two ranks) lies within the train bars.  On seed 0 float32 rounding
flips kinks of the loss: the port's one-process gradient already lies
1.1e-2 (whole) from JAX's 1-device one, with no data parallelism involved,
and which side of a kink each lands on moves with the summation order (JAX's
own 2-device gradient lies 5.3e-4 from its 1-device one as ``jax.grad``
jits it, 1.6e-2 as ``value_and_grad`` does).  So the steps take seed 1
(``torch_dp_ranks.BATCH_SEED``); ``JAX_PLATFORMS=cpu PYTHONPATH=.:tests
python tests/test_torch_parallel.py`` prints every pair on seeds 0-3
(``measure_dp_gradients``; ROADMAP Queue 3).
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn
from flax.core import unfreeze
from jax import lax
from jax.sharding import PartitionSpec as PS

import torch_dp_ranks as R
from cmflow_tpu.losses import radar_loss as jrl
from cmflow_tpu.models import build_model as jax_build_model
from cmflow_tpu.parallel import mesh as meshlib
from cmflow_tpu.train import steps as jsteps
from cmflow_tpu.train.state import TrainState as JaxTrainState
from cmflow_tpu.train.state import make_optimizer as jax_make_optimizer
from cmflow_tpu_torch.models import build_model
from cmflow_tpu_torch.models.convert import export_flax_variables
from cmflow_tpu_torch.parallel import mesh
from cmflow_tpu_torch.utils import config

AXIS = meshlib.DATA_AXIS


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def leaves(tree, prefix=""):
    """``{path: array}`` of a nested dict of arrays."""
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            out.update(leaves(value, f"{prefix}{key}/"))
        else:
            out[prefix + key] = np.asarray(value)
    return out


def numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, unfreeze(tree))


def gradient_errors(got, want):
    """Each leaf's relative L2 error, the whole gradient's, and the leaves
    whose reference is exactly zero (as the GRU's from a zero carry)."""
    got, want = leaves(got), leaves(want)
    assert sorted(got) == sorted(want)
    zero = {k for k in want if not want[k].any()}
    rel = {k: float(np.linalg.norm(got[k] - want[k]) / np.linalg.norm(want[k]))
           for k in want if k not in zero}
    whole = float(np.sqrt(sum(np.sum((got[k] - want[k]) ** 2) for k in want)
                          / sum(np.sum(want[k] ** 2) for k in want)))
    return rel, whole, {k: got[k] for k in zero}


def assert_train_bars(got, want):
    """Each leaf within a relative L2 error of 3e-2, the whole gradient
    within 1e-2, a leaf exactly zero in ``want`` exactly zero in ``got``."""
    rel, whole, zero = gradient_errors(got, want)
    for k, v in zero.items():
        np.testing.assert_array_equal(v, 0.0, err_msg=k)
    bad = {k: v for k, v in rel.items() if not v <= 3e-2}
    assert not bad, bad
    assert whole <= 1e-2, whole


def spawn_ranks(out, part):
    """What each of two ranks computed (``torch_dp_ranks.run_cases``)."""
    mesh.spawn(R.rank_cases, (str(out), part), 2, "cpu")
    return [torch.load(out / f"rank{r}.pt", weights_only=False)
            for r in range(2)]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return spawn_ranks(tmp_path_factory.mktemp("ranks"), "pieces")


@pytest.fixture(scope="module")
def one():
    """The same cases in this process on the whole batch."""
    return R.run_cases(None, "pieces")


@pytest.fixture(scope="module")
def jmesh():
    return meshlib.make_mesh(num_devices=2)


def rows_of(ranks, case, key):
    return np.concatenate([r[case][key] for r in ranks])


# --------------------------------------------------------------------------
# the pieces: cross-replica BatchNorm and the global-batch loss ratio

def test_batchnorm_against_flax_axis_name(ranks, jmesh):
    x, r, scale, bias, mean, var = R.bn_inputs()
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5,
                       axis_name=AXIS)
    v = {"params": {"scale": scale, "bias": bias},
         "batch_stats": {"mean": mean, "var": var}}

    def f(v, x, r):
        def loss(x):
            y, mut = bn.apply(v, x, mutable=["batch_stats"])
            return jnp.sum(y * r), (y, mut["batch_stats"])

        (_, (y, stats)), dx = jax.value_and_grad(loss, has_aux=True)(x)
        return y, stats, dx

    y, stats, dx = jax.jit(jax.shard_map(
        f, mesh=jmesh, in_specs=(PS(), PS(AXIS), PS(AXIS)),
        out_specs=(PS(AXIS), PS(), PS(AXIS)), check_vma=False))(v, x, r)
    np.testing.assert_allclose(rows_of(ranks, "batchnorm", "y"),
                               np.asarray(y), rtol=0, atol=1e-5)
    for rank in ranks:
        for key in ("mean", "var"):
            np.testing.assert_allclose(rank["batchnorm"][key],
                                       np.asarray(stats[key]), rtol=0,
                                       atol=1e-5, err_msg=key)
    dx = np.asarray(dx)
    err = np.abs(rows_of(ranks, "batchnorm", "dx") - dx).max()
    assert err <= 1e-5 * np.abs(dx).max(), err


def test_global_ratio_against_jax(ranks, one, jmesh):
    """``G * num_local / max(sum of den over the ranks, 1)`` on each rank,
    as the JAX device computes it; their mean the global ratio."""
    num, den = R.global_ratio_inputs()

    def f(n, d):
        return jrl._global_ratio(jnp.sum(n), jnp.sum(d), AXIS)[None]

    want = jax.jit(jax.shard_map(
        f, mesh=jmesh, in_specs=(PS(AXIS), PS(AXIS)), out_specs=PS(AXIS),
        check_vma=False))(num, den)
    got = np.array([r["global_ratio"] for r in ranks])
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-6)
    np.testing.assert_allclose(got.mean(), one["global_ratio"], rtol=1e-6)
    np.testing.assert_allclose(one["global_ratio"], num.sum() / den.sum(),
                               rtol=1e-6)


def test_motion_seg_loss_against_jax(ranks, one, jmesh):
    pre, gt = R.loss_inputs()

    def f(p, y):
        loss, g = jax.value_and_grad(
            lambda p: jrl.motion_seg_loss(p, y, AXIS))(p)
        return loss[None], g

    loss, grad = jax.jit(jax.shard_map(
        f, mesh=jmesh, in_specs=(PS(AXIS), PS(AXIS)),
        out_specs=(PS(AXIS), PS(AXIS)), check_vma=False))(pre, gt)
    got = np.array([r["motion_seg"]["loss"] for r in ranks])
    np.testing.assert_allclose(got, np.asarray(loss), rtol=1e-5)
    np.testing.assert_allclose(rows_of(ranks, "motion_seg", "grad"),
                               np.asarray(grad), rtol=1e-5, atol=1e-9)
    # the ranks' mean is the global batch's loss, and so is its gradient
    np.testing.assert_allclose(got.mean(), one["motion_seg"]["loss"],
                               rtol=1e-5)
    np.testing.assert_allclose(rows_of(ranks, "motion_seg", "grad") / 2,
                               one["motion_seg"]["grad"], rtol=1e-5,
                               atol=1e-9)


# --------------------------------------------------------------------------
# the steps against JAX's 2-device steps

def jax_state(variables, lr=1e-3):
    tx = jax_make_optimizer(lr=lr, steps_per_epoch=R.STEPS_PER_EPOCH)
    return JaxTrainState(step=jnp.zeros((), jnp.int32),
                         params=variables["params"],
                         batch_stats=variables["batch_stats"],
                         opt_state=tx.init(variables["params"]), tx=tx)


def jax_dp_step(name, jmesh):
    """The JAX package's 2-device step of ``name`` from the port's seeded
    weights (CMFlow_T: its T=1 clip step): items and variables after."""
    variables = export_flax_variables(
        build_model(name, device="cpu", seed=R.MODEL_SEED[name]))
    model = jax_build_model(name, axis_name=AXIS)
    if name == "cmflow_t":
        batch = R.clip(1)
        step = jsteps.make_train_step_seq(model, R.P, R.TCR, mesh=jmesh)
    else:
        batch = R.train_batch()
        step = jsteps.make_train_step(name, model, R.P, R.TCR, mesh=jmesh)
    state = meshlib.replicate(jmesh, jax_state(variables))
    state, items = step(state, meshlib.shard_batch(jmesh, batch))
    return dict(items={k: float(v) for k, v in items.items()},
                after=numpy_tree({"params": state.params,
                                  "batch_stats": state.batch_stats}))


def jax_gradients(name, batch, axis_mesh=None):
    """``jax.value_and_grad`` of the JAX package's ``_frame_loss`` from the
    port's seeded weights: on one device, or under ``shard_map`` over
    ``axis_mesh`` with the gradients ``pmean``-ed as its train step does."""
    variables = export_flax_variables(
        build_model(name, device="cpu", seed=R.MODEL_SEED[name]))
    axis = None if axis_mesh is None else AXIS
    model = jax_build_model(name, axis_name=axis)

    def f(params, stats, b):
        def loss(p):
            return jsteps._frame_loss(name, model, p, stats, b,
                                      jnp.asarray(R.P), jnp.asarray(R.TCR),
                                      0.3, axis_name=axis)

        grads = jax.grad(lambda p: loss(p)[0])(params)
        return grads if axis is None else lax.pmean(grads, axis)

    if axis_mesh is not None:
        f = jax.shard_map(f, mesh=axis_mesh, in_specs=(PS(), PS(), PS(AXIS)),
                          out_specs=PS(), check_vma=False)
    return numpy_tree(jax.jit(f)(variables["params"],
                                 variables["batch_stats"], batch))


def assert_step_matches(ranks, case, want):
    """Every rank's step against the JAX package's 2-device step: items
    rtol 1e-4, statistics atol 1e-5, parameters atol 5e-3."""
    for rank in ranks:
        got = rank[case]
        assert sorted(got["items"]) == sorted(want["items"])
        for k, v in want["items"].items():
            np.testing.assert_allclose(got["items"][k], v, rtol=1e-4,
                                       err_msg=k)
        g, w = leaves(got["after"]), leaves(want["after"])
        assert sorted(g) == sorted(w)
        for k in w:
            np.testing.assert_allclose(
                g[k], w[k], rtol=0,
                atol=1e-5 if k.startswith("batch_stats") else 5e-3,
                err_msg=k)


def assert_same_bits(ranks, case):
    """The variables after the step, the items and the step count
    bit-identical on both ranks."""
    a, b = (leaves(r[case]["after"]) for r in ranks)
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert ranks[0][case]["items"] == ranks[1][case]["items"]
    assert ranks[0][case]["step"] == ranks[1][case]["step"]


def test_cmflow_step_against_jax_2_devices(ranks, jmesh):
    assert_step_matches(ranks, "cmflow", jax_dp_step("cmflow", jmesh))


def test_cmflow_gradients_against_jax_2_devices(ranks, jmesh):
    want = jax_gradients("cmflow", R.train_batch(), jmesh)
    assert_train_bars(ranks[0]["cmflow"]["grads"], want)


def test_cmflow_gradients_against_one_process(ranks, one):
    """The gradients the ranks apply (their mean over the ranks, before
    Adam) against the port's one-process step on the whole batch: a
    gradient off by the number of ranks, or missing the path through the
    shared BatchNorm statistics, misses these bars by far."""
    assert_train_bars(ranks[0]["cmflow"]["grads"], one["cmflow"]["grads"])


def test_cmflow_ranks_hold_the_same_bits(ranks):
    assert_same_bits(ranks, "cmflow")


# --------------------------------------------------------------------------
# the sharded eval

@pytest.mark.parametrize("fused", ["off", "on"])
def test_sharded_eval_against_one_process(ranks, one, fused):
    want = one["serve"][fused]
    for i, w in enumerate(want):
        got = np.concatenate([r["serve"][fused][i] for r in ranks])
        np.testing.assert_allclose(got, w, rtol=0, atol=1e-5,
                                   err_msg=f"output {i}")


# --------------------------------------------------------------------------
# the group's set-up

def test_unequal_rows_raise_on_every_rank(ranks):
    assert [r["unequal_rows_raised"] for r in ranks] == [True, True]


def test_shard_rows_without_a_group():
    x = np.arange(12).reshape(6, 2)
    np.testing.assert_array_equal(mesh.shard_rows(x, None), x)
    np.testing.assert_array_equal(mesh.shard_batch({"x": x}, None)["x"], x)


@pytest.mark.parametrize("platform,local_world,cards,want", [
    ("cpu", 2, 0, ("gloo", "cpu")),
    ("auto", 2, 2, ("nccl", "cuda:1")),
    ("auto", 2, 1, ("gloo", "cuda:0")),
    ("auto", 1, 1, ("nccl", "cuda:0")),
])
def test_backend_and_device(monkeypatch, platform, local_world, cards, want):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    backend, device = mesh.backend_and_device(platform, local_world, 1)
    assert (backend, str(device)) == want


def test_no_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh.backend_and_device("auto", 2, 0)


def test_config_device_under_a_launcher(monkeypatch):
    """``data_parallel`` with more cards than one no longer raises; the
    launcher's environment is read as ``(rank, world, local rank)``."""
    for key, value in (("RANK", "1"), ("WORLD_SIZE", "2"),
                       ("LOCAL_RANK", "1")):
        monkeypatch.setenv(key, value)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    cfg = config.Config()
    assert cfg.data_parallel
    assert config.config_device(cfg).type == "cuda"
    assert mesh.launcher_env() == (1, 2, 1)
    monkeypatch.delenv("RANK")
    assert mesh.launcher_env() is None


# --------------------------------------------------------------------------
# measurement (python tests/test_torch_parallel.py)

def measure_dp_gradients(seeds=range(4)):
    """How far each pair of CMFlow gradients lies on the batches
    ``make_train_batch(seed, 4, 48)``: the JAX package's on one device and
    on two, the port's in one process and on two ranks."""
    import os
    import tempfile

    # run as a script, without conftest: its eight CPU devices, set before
    # the first backend use (the device count moves XLA's float32 rounding,
    # and with it which side of the kink seed 0's 1-device gradient takes)
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") + " "
                               "--xla_force_host_platform_device_count=8")
    jax.config.update("jax_platforms", "cpu")
    jmesh_ = meshlib.make_mesh(num_devices=2)
    torch.set_num_threads(1)
    for seed in seeds:
        batch = R.train_batch(seed)
        out = tempfile.mkdtemp()
        mesh.spawn(R.rank_step, (out, "cmflow", seed), 2, "cpu")
        grads = {"jax_1": jax_gradients("cmflow", batch),
                 "jax_2": jax_gradients("cmflow", batch, jmesh_),
                 "port_1": R.train_one("cmflow", batch)["grads"],
                 "port_2": torch.load(f"{out}/rank0.pt",
                                      weights_only=False)["grads"]}
        for a, b in (("jax_2", "jax_1"), ("port_1", "jax_1"),
                     ("port_2", "port_1"), ("port_2", "jax_2")):
            rel, whole, _ = gradient_errors(grads[a], grads[b])
            print(f"seed {seed}: {a} vs {b}: whole {whole:.3e}, worst leaf "
                  f"{max(rel.values()):.3e}, median leaf "
                  f"{np.median(list(rel.values())):.3e}")


if __name__ == "__main__":
    sys.exit(measure_dp_gradients())
