"""Port parity: the CMFlow train step of ``cmflow_tpu_torch`` against the
JAX package's on the CPU, at B=2, N=64 and full width, from the same flax
weights and the same synthetic batch.

Bars, as the JAX package holds its own data-parallel step
(tests/test_train.py:188-195): loss items rtol 1e-4; BatchNorm running
statistics atol 1e-5; parameters after one Adam step atol 5e-3 (Adam's first
step is about lr * sign(g)).

Gradients.  Where the forward makes no discrete choice that float32 rounding
can flip, each gradient leaf is held to ``max|d| <= 1e-3 max|g_jax|``: the
train-mode PointwiseMLP, the sa encoder's K=4 and K=8 scales, the cost
volume and the heads of the whole step.  Across the whole step that bar cannot hold for any float32
implementation: a max over neighbours picks another row when rounding moves
a near tie, and some leaves (the BatchNorm bias before a max-pool whose
output feeds a train-mode BatchNorm) have an exact gradient of zero, so
their largest entry is rounding noise (scripts/profile_torch_grad_jitter.py
moves the inputs of one propagation-encoder scale by 1e-6 of their size and
prints how far each leaf moves).  There every leaf is held to a relative L2
error of 3e-2 and the whole gradient to 1e-2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as fnn
from flax.core import unfreeze

from cmflow_tpu.models import build_model as jax_build_model
from cmflow_tpu.nn import blocks as jblocks
from cmflow_tpu.train import steps as jsteps
from cmflow_tpu.train.state import TrainState as JaxTrainState
from cmflow_tpu.train.state import make_optimizer as jax_make_optimizer
from cmflow_tpu_torch.data.synthetic import make_train_batch
from cmflow_tpu_torch.data.vod import VOD_CAMERA_PROJECTION, VOD_T_CAMERA_RADAR
from cmflow_tpu_torch.losses import LOSS_ITEMS
from cmflow_tpu_torch.models import build_model
from cmflow_tpu_torch.models.convert import (
    export_flax_variables,
    load_flax_variables,
)
from cmflow_tpu_torch.nn import blocks
from cmflow_tpu_torch.train.state import create_train_state, make_optimizer
from cmflow_tpu_torch.train.steps import make_train_step

P, TCR = VOD_CAMERA_PROJECTION, VOD_T_CAMERA_RADAR
STEPS_PER_EPOCH = 10


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def t(x, grad=False):
    out = torch.from_numpy(np.array(x))
    return out.requires_grad_(True) if grad else out


def numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, unfreeze(tree))


def leaves(tree):
    """``{path: array}`` of a nested dict."""
    return {jax.tree_util.keystr(p): np.asarray(a)
            for p, a in jax.tree_util.tree_flatten_with_path(tree)[0]}


def assert_leaves_close(got, want, bar=1e-3):
    """Every leaf: ``max|got - want| <= bar * max|want|``."""
    got, want = leaves(got), leaves(want)
    assert sorted(got) == sorted(want)
    bad = {k: float(np.abs(got[k] - want[k]).max() / np.abs(want[k]).max())
           for k in want}
    bad = {k: v for k, v in bad.items() if not v <= bar}
    assert not bad, bad


@pytest.fixture(scope="module")
def jax_step():
    """The JAX package's step on one batch: the initial variables, the
    gradients and loss items of ``_frame_loss``, and the state after one
    ``make_train_step``."""
    batch = make_train_batch(0, 2, 64)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    model = jax_build_model("cmflow")
    inputs = [jb[k] for k in ("pc1", "pc2", "ft1", "ft2", "mask")]
    variables = numpy_tree(jax.jit(
        lambda key: model.init({"params": key}, *inputs, True))(
            jax.random.PRNGKey(0)))

    def loss(params):
        return jsteps._frame_loss("cmflow", model, params,
                                  variables["batch_stats"], jb,
                                  jnp.asarray(P), jnp.asarray(TCR), 0.3)

    (_, (items, _, _)), grads = jax.jit(jax.value_and_grad(
        loss, has_aux=True))(variables["params"])
    tx = jax_make_optimizer(lr=1e-3, steps_per_epoch=STEPS_PER_EPOCH)
    state = JaxTrainState(step=jnp.zeros((), jnp.int32),
                          params=variables["params"],
                          batch_stats=variables["batch_stats"],
                          opt_state=tx.init(variables["params"]), tx=tx)
    state, step_items = jsteps.make_train_step("cmflow", model, P, TCR)(
        state, jb)
    return dict(batch=batch, variables=variables, grads=numpy_tree(grads),
                items={k: float(v) for k, v in items.items()},
                step_items={k: float(v) for k, v in step_items.items()},
                after=numpy_tree({"params": state.params,
                                  "batch_stats": state.batch_stats}))


@pytest.fixture(scope="module")
def port_step(jax_step):
    """The port's ``make_train_step`` from the same weights and batch:
    loss items, gradients and the variables after the step."""
    model = build_model("cmflow", device="cpu", seed=3)
    load_flax_variables(model, jax_step["variables"])
    state = create_train_state(model, steps_per_epoch=STEPS_PER_EPOCH)
    step = make_train_step("cmflow", model, P, TCR)
    items = step(state, jax_step["batch"])
    return dict(items={k: float(v) for k, v in items.items()},
                grads=export_flax_variables(model, grads=True)["params"],
                after=export_flax_variables(model), state=state, step=step)


class TestTrainModeBlocks:
    def test_batchnorm(self):
        rs = np.random.RandomState(1)
        x = (rs.randn(2, 32, 8, 16) * 3 + 5).astype(np.float32)
        bn = fnn.BatchNorm(use_running_average=False, momentum=0.9,
                           epsilon=1e-5)
        v = unfreeze(bn.init(jax.random.PRNGKey(0), jnp.asarray(x)))
        v["params"]["scale"] = jnp.asarray(rs.uniform(0.5, 1.5, 16),
                                           jnp.float32)
        v["batch_stats"]["mean"] = jnp.asarray(rs.randn(16), jnp.float32)
        want, mut = bn.apply(v, jnp.asarray(x), mutable=["batch_stats"])
        port = blocks.BatchNorm(16)
        load_flax_variables(port, numpy_tree(v))
        got = port(t(x), True)
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   atol=1e-5)
        for name, key in (("running_mean", "mean"), ("running_var", "var")):
            np.testing.assert_allclose(getattr(port, name).numpy(),
                                       np.asarray(mut["batch_stats"][key]),
                                       rtol=0, atol=1e-5)
        # eval mode leaves the statistics alone
        before = port.running_var.clone()
        port(t(x), False)
        assert torch.equal(port.running_var, before)

    def test_pointwise_mlp_outputs_stats_and_grads(self):
        rs = np.random.RandomState(2)
        x = rs.randn(2, 16, 8, 12).astype(np.float32)
        r = rs.randn(2, 16, 8, 8).astype(np.float32)
        mod = jblocks.PointwiseMLP((16, 8))
        v = numpy_tree(mod.init(jax.random.PRNGKey(2), jnp.asarray(x), True))

        def f(params):
            y, mut = mod.apply({"params": params,
                                "batch_stats": v["batch_stats"]},
                               jnp.asarray(x), True, mutable=["batch_stats"])
            return jnp.sum(y * r), (y, mut)

        (_, (want, mut)), g = jax.value_and_grad(f, has_aux=True)(v["params"])
        port = blocks.PointwiseMLP(12, (16, 8))
        load_flax_variables(port, v)
        got = port(t(x), True)
        (got * t(r)).sum().backward()
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   atol=1e-5)
        after = export_flax_variables(port)
        np.testing.assert_allclose(
            np.concatenate([a.ravel() for a in leaves(after["batch_stats"])
                            .values()]),
            np.concatenate([a.ravel() for a in leaves(numpy_tree(
                mut["batch_stats"])).values()]), atol=1e-5)
        assert_leaves_close(export_flax_variables(port, grads=True)["params"],
                            numpy_tree(g))

    @pytest.mark.parametrize("kind", ["sa_k4", "sa_k8", "cost_volume"])
    def test_module_gradients(self, kind):
        """Train-mode gradients of the sa encoder's narrow scales on these
        inputs, where no max over neighbours is near a tie, and of the cost
        volume, which sums over its neighbours."""
        rs = np.random.RandomState(3)
        b = make_train_batch(1, 2, 64)
        xyz, xyz2 = b["pc1"], b["pc2"]
        if kind == "cost_volume":
            jmod = jblocks.FeatureCorrelator(8, (64, 64))
            feats = [rs.randn(2, 64, 32).astype(np.float32) for _ in range(2)]
            args = (xyz, xyz2, *feats)
            port = blocks.FeatureCorrelator(8, 32, 32, (64, 64))
            out_c = 64
        else:
            radius, k, c_in, mlp, mlp2 = {
                "sa_k4": (2.0, 4, 3, (32, 32, 64), (64, 64, 64)),
                "sa_k8": (4.0, 8, 3, (32, 32, 64), (64, 64, 64)),
            }[kind]
            jmod = jblocks.PointLocalFeature(radius, k, mlp, mlp2)
            args = (xyz, rs.randn(2, 64, c_in).astype(np.float32))
            port = blocks.PointLocalFeature(radius, k, c_in, mlp, mlp2)
            out_c = mlp2[-1]
        r = rs.randn(2, 64, out_c).astype(np.float32)
        v = numpy_tree(jmod.init(jax.random.PRNGKey(4),
                                 *map(jnp.asarray, args), True))

        def f(params):
            y, _ = jmod.apply({"params": params,
                               "batch_stats": v.get("batch_stats", {})},
                              *map(jnp.asarray, args), True,
                              mutable=["batch_stats"])
            return jnp.sum(y * r)

        g = jax.grad(f)(v["params"])
        load_flax_variables(port, v)
        (port(*map(t, args), True) * t(r)).sum().backward()
        assert_leaves_close(export_flax_variables(port, grads=True)["params"],
                            numpy_tree(g))


class TestOneStep:
    def test_loss_items(self, jax_step, port_step):
        assert sorted(port_step["items"]) == sorted(LOSS_ITEMS["cmflow"])
        for k, want in jax_step["items"].items():
            np.testing.assert_allclose(port_step["items"][k], want,
                                       rtol=1e-4, err_msg=k)
            np.testing.assert_allclose(jax_step["step_items"][k], want,
                                       rtol=1e-5, err_msg=k)

    def test_gradients(self, jax_step, port_step):
        got, want = leaves(port_step["grads"]), leaves(jax_step["grads"])
        assert sorted(got) == sorted(want)
        rel = {k: float(np.linalg.norm(got[k] - want[k])
                        / np.linalg.norm(want[k])) for k in want}
        bad = {k: v for k, v in rel.items() if not v <= 3e-2}
        assert not bad, bad
        whole = np.sqrt(sum(np.sum((got[k] - want[k]) ** 2) for k in want)
                        / sum(np.sum(want[k] ** 2) for k in want))
        assert whole <= 1e-2, whole
        # the heads, after the last max over neighbours: the strict bar
        for head in ("fp", "mp"):
            assert_leaves_close(port_step["grads"][head],
                                jax_step["grads"][head])

    def test_batch_stats_and_params_after_the_step(self, jax_step, port_step):
        got, want = port_step["after"], jax_step["after"]
        g, w = leaves(got["batch_stats"]), leaves(want["batch_stats"])
        assert sorted(g) == sorted(w)
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=0, atol=1e-5,
                                       err_msg=k)
        g, w = leaves(got["params"]), leaves(want["params"])
        assert sorted(g) == sorted(w)
        moved = 0
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=0, atol=5e-3,
                                       err_msg=k)
            moved += int(np.any(w[k] != leaves(
                jax_step["variables"]["params"])[k]))
        assert moved == len(w)  # every parameter took the step
        assert port_step["state"].step == 1

    def test_training_lowers_the_loss(self, jax_step, port_step):
        """Further steps on the same batch: finite items, falling loss
        (tests/test_train.py:55-72)."""
        first = port_step["items"]["Loss"]
        for _ in range(8):
            items = port_step["step"](port_step["state"], jax_step["batch"])
            assert all(np.isfinite(float(v)) for v in items.values())
        assert float(items["Loss"]) < first
        assert port_step["state"].step == 9


class TestOptimizerAndApi:
    def test_schedule_and_adam_match_optax(self):
        rs = np.random.RandomState(5)
        w0 = rs.randn(4, 3).astype(np.float32)
        grads = rs.randn(25, 4, 3).astype(np.float32)
        tx = jax_make_optimizer(lr=1e-2, decay_rate=0.5, steps_per_epoch=4)
        params = {"w": jnp.asarray(w0)}
        opt_state = tx.init(params)
        lin = torch.nn.Linear(3, 4, bias=False)
        with torch.no_grad():
            lin.weight.copy_(t(w0))
        opt, sched = make_optimizer(lin, lr=1e-2, decay_rate=0.5,
                                    steps_per_epoch=4)
        for i, g in enumerate(grads):
            assert sched.get_last_lr()[0] == pytest.approx(
                1e-2 * 0.5 ** (i // 4))
            upd, opt_state = tx.update({"w": jnp.asarray(g)}, opt_state,
                                       params)
            params = optax.apply_updates(params, upd)
            lin.weight.grad = t(g)
            opt.step()
            sched.step()
            np.testing.assert_allclose(lin.weight.detach().numpy(),
                                       np.asarray(params["w"]), rtol=0,
                                       atol=1e-6)
        opt, constant = make_optimizer(lin, lr=3e-4)
        for _ in range(30):
            opt.step()
            constant.step()
        assert constant.get_last_lr()[0] == pytest.approx(3e-4)

    def test_export_round_trip(self, jax_step):
        model = build_model("cmflow", device="cpu", seed=4)
        load_flax_variables(model, jax_step["variables"])
        tree = export_flax_variables(model)
        got, want = leaves(tree), leaves(jax_step["variables"])
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
        other = build_model("cmflow", device="cpu", seed=5)
        load_flax_variables(other, tree)
        for a, b in zip(model.state_dict().values(),
                        other.state_dict().values()):
            assert torch.equal(a, b)
        # no gradients yet: zeros in the params tree's shape
        grads = leaves(export_flax_variables(model, grads=True)["params"])
        params = leaves(jax_step["variables"]["params"])
        assert sorted(grads) == sorted(params)
        assert all(not grads[k].any() and grads[k].shape == params[k].shape
                   for k in params)

    def test_step_api(self):
        model = build_model("cmflow", device="cpu")
        assert callable(make_train_step("raflow", model, P, TCR))
        with pytest.raises(ValueError, match="make_train_step_seq"):
            make_train_step("cmflow_t", model, P, TCR)
        with pytest.raises(ValueError, match="unknown model"):
            make_train_step("flownet", model, P, TCR)
        step = make_train_step("cmflow", model, P, TCR)
        with pytest.raises(ValueError, match="another model"):
            step(create_train_state(build_model("cmflow", device="cpu")),
                 make_train_batch(0, 1, 32))
