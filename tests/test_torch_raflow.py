"""Port parity: RaFlow of ``cmflow_tpu_torch`` against the JAX package on the
CPU, at full width.

Weights: a port ``RaFlow`` drawn from a seed, its BatchNorm statistics made
real by one train-mode forward on the request, carried to the JAX package
by ``export_flax_variables``.  Two sets: ``blend`` (momentum 0.5, half the
batch's statistics: flows of ~0.1 m) and ``batch`` (momentum 0, the batch's
own statistics: flows of ~5 m).

* Serving, at B=2 on the padded 128 bucket (valid masks on both frames, one
  valid point with ``v_r == 0``), at the serving bars
  (tests/test_torch_serving.py): flow atol 1e-4, ``pre_trans`` atol 5e-4,
  inlier masks agreeing on >= 99% of the valid points.
  ``RaFlow.forward(train=False)`` and ``raflow_infer`` are held to
  ``RaFlow.apply`` on both sets, and ``raflow_infer`` to the JAX engine
  (``raflow_infer(interpret=True)``) on ``blend``: the JAX engine gathers
  through bf16 hi/lo splits, exact to about 2^-16 relative, so at flows of
  ~5 m it lies ~4e-4 from its own module.
* One train step at B=2, N=64 against ``make_train_step("raflow")``: loss
  items rtol 1e-4, BatchNorm statistics atol 1e-5, parameters after the
  step atol 5e-3, gradients within a relative L2 of 3e-2 per leaf and 1e-2
  overall (tests/test_torch_train.py).  Batch element 1 has ``v_r == 0``
  everywhere, so no point is an inlier: its re-fit Kabsch takes all-zero
  weights and a zero cotangent, and the gradients must stay finite.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import unfreeze

from cmflow_tpu.models import build_model as jax_build_model
from cmflow_tpu.models.inference import raflow_infer as jax_raflow_infer
from cmflow_tpu.train import steps as jsteps
from cmflow_tpu.train.state import TrainState as JaxTrainState
from cmflow_tpu.train.state import make_optimizer as jax_make_optimizer
from cmflow_tpu_torch.data import schema, synthetic
from cmflow_tpu_torch.data.vod import VOD_CAMERA_PROJECTION, VOD_T_CAMERA_RADAR
from cmflow_tpu_torch.losses import LOSS_ITEMS
from cmflow_tpu_torch.models import RaFlow, build_model
from cmflow_tpu_torch.models.convert import (
    export_flax_variables,
    load_flax_variables,
)
from cmflow_tpu_torch.models.inference import raflow_infer, raflow_infer_many
from cmflow_tpu_torch.nn.blocks import BatchNorm
from cmflow_tpu_torch.train.state import create_train_state
from cmflow_tpu_torch.train.steps import make_eval_step, make_train_step

P, TCR = VOD_CAMERA_PROJECTION, VOD_T_CAMERA_RADAR
BARS = {"flow": 1e-4, "trans": 5e-4, "agree": 0.99}
KEYS = ("pc1", "pc2", "ft1", "ft2", "interval", "valid1", "valid2")
STEPS_PER_EPOCH = 10


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def padded_request(seed: int, b: int, n_range, bucket: int) -> dict:
    """``b`` synthetic val frames of ``n_range`` points, padded to
    ``bucket`` and collated."""
    rng = np.random.default_rng(seed)
    samples = []
    for _ in range(b):
        n1, n2 = (int(x) for x in rng.integers(*n_range, size=2))
        s = synthetic.decode_sample(synthetic.make_scene(rng, n1=n1, n2=n2),
                                    "val", eval_mode=True, num_points=256)
        samples.append(schema.pad_to(s, bucket))
    return schema.collate(samples)


# BatchNorm momentum of the one train-mode forward that sets the statistics
STATS = {"blend": 0.5, "batch": 0.0}


def real_batchnorm(model: torch.nn.Module, forward, momentum: float) -> None:
    """Each BatchNorm's running statistics move from their initial values to
    those of its input on one train-mode ``forward()`` at ``momentum``."""
    bns = [m for m in model.modules() if isinstance(m, BatchNorm)]
    for bn in bns:
        bn.MOMENTUM = momentum
    with torch.no_grad():
        forward()
    for bn in bns:
        del bn.MOMENTUM


def jax_tree(model):
    return jax.tree_util.tree_map(jnp.asarray, export_flax_variables(model))


def numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, unfreeze(tree))


def leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(a)
            for p, a in jax.tree_util.tree_flatten_with_path(tree)[0]}


def inputs(batch, keys=KEYS):
    return [torch.as_tensor(batch[k]) for k in keys]


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def request_():
    batch = padded_request(0, 2, (90, 128), 128)
    assert not batch["valid1"].all() and not batch["valid2"].all()
    batch["ft1"][0, 5, 0] = 0.0  # a valid point with v_r == 0
    assert batch["valid1"][0, 5]
    return batch


@pytest.fixture(scope="module")
def served(request_):
    """For each set of statistics, the port model on its weights and the
    JAX module's outputs from the same weights; on ``blend`` also the JAX
    engine's."""
    x = inputs(request_)
    args = [jnp.asarray(request_[k]) for k in KEYS]
    jmodel = jax_build_model("raflow")
    out = {}
    for name, momentum in STATS.items():
        model = build_model("raflow", device="cpu", seed=1)
        real_batchnorm(model, lambda: model(*x[:5], True, *x[5:]), momentum)
        v = jax_tree(model)
        module = jmodel.apply(v, *args[:5], False, *args[5:])
        engine = (jax_raflow_infer(v, *args, interpret=True)
                  if name == "blend" else ())
        out[name] = (model, [np.asarray(o) for o in module],
                     [np.asarray(o) for o in engine])
    return out


def assert_within_bars(got, want, valid):
    """``(coarse, sf_agg, pre_trans, mask_s)`` on the valid points."""
    (gout, gsf, gtrans, gmask), (out, sf, trans, mask) = got, want
    assert gmask.dtype == np.bool_ and gsf.shape == sf.shape
    np.testing.assert_allclose(gout[valid], out[valid], atol=BARS["flow"])
    np.testing.assert_allclose(gtrans, trans, atol=BARS["trans"])
    assert (gmask == mask)[valid].mean() >= BARS["agree"]
    same = (gmask == mask) & valid
    np.testing.assert_allclose(gsf[same], sf[same], atol=BARS["flow"])


def numpy(out):
    return [o.detach().numpy() for o in out]


@pytest.mark.parametrize("stats", sorted(STATS))
def test_module_route_matches_jax(request_, served, stats):
    model, want, _ = served[stats]
    x = inputs(request_)
    with torch.no_grad():
        got = numpy(model(*x[:5], False, *x[5:]))
    valid = request_["valid1"]
    assert want[3][valid].any() and not want[3][0, 5]  # v_r == 0: no inlier
    assert not got[3][0, 5]
    assert np.abs(want[1][valid]).max() > 0.05  # not degenerate
    assert_within_bars(got, want, valid)


@pytest.mark.parametrize("stats", sorted(STATS))
def test_raflow_infer_matches_jax_module(request_, served, stats):
    model, want, _ = served[stats]
    got = numpy(raflow_infer(model, *inputs(request_)))
    assert_within_bars(got, want, request_["valid1"])


def test_raflow_infer_matches_jax_engine(request_, served):
    model, _, want = served["blend"]
    got = numpy(raflow_infer(model, *inputs(request_)))
    assert_within_bars(got, want, request_["valid1"])


def test_eval_step_routes(request_, served):
    """``make_eval_step("raflow")``: the fused route is ``raflow_infer``,
    the module route ``forward``, both as ``(sf_agg, mask_s as float,
    pre_trans, mask_s)``; the CPU takes the module route by default."""
    model, _, _ = served["blend"]
    x = inputs(request_)
    fused = make_eval_step("raflow", model, fused="on")
    assert fused.fused and not make_eval_step("raflow", model).fused
    sf, cls, trans, mask = numpy(fused(request_))
    _, wsf, wtrans, wmask = numpy(raflow_infer(model, *x))
    for a, b in ((sf, wsf), (trans, wtrans), (mask, wmask)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(cls, wmask.astype(np.float32))
    module = numpy(make_eval_step("raflow", model)(request_))
    with torch.no_grad():
        _, msf, mtrans, mmask = numpy(model(*x[:5], False, *x[5:]))
    for a, b in zip(module, (msf, mmask.astype(np.float32), mtrans, mmask)):
        np.testing.assert_array_equal(a, b)


def test_infer_many_matches_per_batch(served):
    model, _, _ = served["blend"]
    reqs = [padded_request(s, 1, (60, 64), 64) for s in (3, 4)]
    stacked = [torch.stack([torch.as_tensor(r[k]) for r in reqs])
               for k in KEYS]
    many = numpy(raflow_infer_many(model, *stacked))
    for i, r in enumerate(reqs):
        for a, b in zip(numpy(raflow_infer(model, *inputs(r))), many):
            np.testing.assert_array_equal(a, b[i])


def test_build_model_and_convert_round_trip(served):
    model, _, _ = served["blend"]
    assert isinstance(model, RaFlow) and not hasattr(model, "mp")
    assert build_model("raflow", "cpu", rigid_thres=0.3).rigid_thres == 0.3
    assert model.rigid_thres == 0.15 and model.rigid_pcs == 0.25
    tree = export_flax_variables(model)
    assert sorted(tree["params"]) == ["fp", "trunk"]
    other = build_model("raflow", "cpu", seed=9)
    load_flax_variables(other, tree)
    for (k, a), b in zip(model.state_dict().items(),
                         other.state_dict().values()):
        assert torch.equal(a, b), k


# ---------------------------------------------------------------------------
# one train step
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def train_batch():
    batch = synthetic.make_train_batch(0, 2, 64)
    batch["ft1"][1, :, 0] = 0.0  # element 1: v_r == 0, so no inlier
    return batch


@pytest.fixture(scope="module")
def jax_step(train_batch):
    """The JAX package's gradients and loss items of ``_frame_loss``, and
    its state after one ``make_train_step("raflow")``, from the port's
    initial weights."""
    port = build_model("raflow", device="cpu", seed=3)
    variables = export_flax_variables(port)
    jb = {k: jnp.asarray(v) for k, v in train_batch.items()}
    model = jax_build_model("raflow")

    def loss(params):
        return jsteps._frame_loss("raflow", model, params,
                                  variables["batch_stats"], jb,
                                  jnp.asarray(P), jnp.asarray(TCR), 0.3)

    (_, (items, _, _)), grads = jax.jit(jax.value_and_grad(
        loss, has_aux=True))(variables["params"])
    tx = jax_make_optimizer(lr=1e-3, steps_per_epoch=STEPS_PER_EPOCH)
    state = JaxTrainState(step=jnp.zeros((), jnp.int32),
                          params=variables["params"],
                          batch_stats=variables["batch_stats"],
                          opt_state=tx.init(variables["params"]), tx=tx)
    state, _ = jsteps.make_train_step("raflow", model, P, TCR)(state, jb)
    return dict(variables=variables, grads=numpy_tree(grads),
                items={k: float(v) for k, v in items.items()},
                after=numpy_tree({"params": state.params,
                                  "batch_stats": state.batch_stats}))


@pytest.fixture(scope="module")
def port_step(train_batch, jax_step):
    model = build_model("raflow", device="cpu", seed=3)
    state = create_train_state(model, steps_per_epoch=STEPS_PER_EPOCH)
    x = {k: torch.as_tensor(train_batch[k]) for k in ("pc1", "pc2", "ft1",
                                                      "ft2", "interval")}
    with torch.no_grad():
        _, _, _, mask_s = model(*x.values(), False)
    step = make_train_step("raflow", model, P, TCR)
    items = step(state, train_batch)
    return dict(items={k: float(v) for k, v in items.items()}, mask_s=mask_s,
                grads=export_flax_variables(model, grads=True)["params"],
                after=export_flax_variables(model), state=state, step=step)


def test_train_batch_has_an_element_without_inliers(port_step):
    frac = port_step["mask_s"].float().mean(dim=1)
    assert frac[0] > 0.25 and frac[1] == 0  # re-fit taken on 0, not on 1


def test_train_loss_items(jax_step, port_step):
    assert sorted(port_step["items"]) == sorted(LOSS_ITEMS["raflow"])
    for k, want in jax_step["items"].items():
        np.testing.assert_allclose(port_step["items"][k], want, rtol=1e-4,
                                   err_msg=k)


def test_train_gradients_finite_and_within_bars(jax_step, port_step):
    got, want = leaves(port_step["grads"]), leaves(jax_step["grads"])
    assert sorted(got) == sorted(want)
    assert all(np.isfinite(g).all() for g in got.values())
    rel = {k: float(np.linalg.norm(got[k] - want[k])
                    / np.linalg.norm(want[k])) for k in want}
    bad = {k: v for k, v in rel.items() if not v <= 3e-2}
    assert not bad, bad
    whole = np.sqrt(sum(np.sum((got[k] - want[k]) ** 2) for k in want)
                    / sum(np.sum(want[k] ** 2) for k in want))
    assert whole <= 1e-2, whole


def test_train_stats_and_params_after_the_step(jax_step, port_step):
    got, want = port_step["after"], jax_step["after"]
    g, w = leaves(got["batch_stats"]), leaves(want["batch_stats"])
    assert sorted(g) == sorted(w)
    for k in w:
        np.testing.assert_allclose(g[k], w[k], rtol=0, atol=1e-5, err_msg=k)
    g, w = leaves(got["params"]), leaves(want["params"])
    before = leaves(jax_step["variables"]["params"])
    for k in w:
        np.testing.assert_allclose(g[k], w[k], rtol=0, atol=5e-3, err_msg=k)
    assert all(np.any(w[k] != before[k]) for k in w)
    assert port_step["state"].step == 1


def test_training_lowers_the_loss(train_batch, port_step):
    first = port_step["items"]["Loss"]
    for _ in range(5):
        items = port_step["step"](port_step["state"], train_batch)
        assert all(np.isfinite(float(v)) for v in items.values())
    assert float(items["Loss"]) < first
    assert port_step["state"].step == 6
