"""Port parity: CMFlow_T of ``cmflow_tpu_torch`` against the JAX package on
the CPU, at full width.

Weights: a port ``CMFlowT`` drawn from a seed, its BatchNorm statistics made
real by one train-mode forward on the request, carried to the JAX package
by ``export_flax_variables``: ``blend`` (momentum 0.5, half the batch's
statistics) and ``batch`` (momentum 0, the batch's own), as in
tests/test_torch_raflow.py.  The GRU carry going in is seeded random.

* Serving, at B=2 on the padded 128 bucket: ``CMFlowT.forward(train=False)``
  and ``cmflow_t_infer`` against ``CMFlowT.apply`` on both sets and
  ``cmflow_t_infer`` against the JAX engine in interpret mode on ``blend``,
  at the serving bars: ``sf_agg``, ``stat_cls`` and ``gfeat_new`` atol 1e-4,
  ``pre_trans`` atol 5e-4, masks agreeing on >= 99% of the valid points.
  ``cmflow_t_infer_seq``'s resets against a frame-by-frame replay.
* The GRU: flax ``GRUCell`` parameters through ``load_flax_variables`` and
  back, its forward against flax's (atol 1e-6), and its initialisers.
* The train gradients at B=2, N=64 (model seed 4, frames 0 and 1 of the
  synthetic train set) against ``jax.value_and_grad`` of the JAX package's
  ``_frame_loss("cmflow_t")`` from the same weights, at the train bars (each
  leaf's relative L2 error 3e-2, the whole gradient's 1e-2; a leaf whose
  JAX gradient is exactly zero, as the GRU's recurrent kernels from a zero
  carry, exactly zero), with the loss items (rtol 1e-4) and the new carry
  (atol 1e-4): the port's ``_frame_loss`` from a zero carry and from a
  seeded one, and ``make_train_step_seq`` at lr 0 on frame 0 alone (T=1)
  and on frame 0 twice (T=2: the second frame's gradients, from the carry
  the first left, through the GRU at a non-zero carry).  On two distinct
  frames the second frame's gradients are held at the median leaf only
  (3e-2): there float32 rounding alone moves the whole gradient by ~1e-2,
  the port's on one CPU thread against two, and JAX's float32 against its
  float64 (``measure_gradients`` below; ROADMAP Queue 3).
* ``make_train_step_seq`` at B=2, N=64, T=2 against the JAX package's, with
  the staircase schedule at one clip batch per epoch, so the learning rate
  decays after every per-frame update, on one clip of two frames.  At lr 0,
  where the second frame sees the first frame's weights on both sides: the
  loss items (means over T, rtol 1e-4) and the BatchNorm running means
  after both frames (atol 1e-5).  At lr 1e-3: the parameters after both
  updates (atol 5e-3; two Adam steps move each by about 2e-3 whatever the
  gradient, so this holds the optimizer, the gradient tests above hold the
  gradients), two optimizer updates, and the learning rate after them
  equal to the JAX package's schedule at its update count.  What does not
  meet the bars,
  measured by ``measure_seq_step`` below (run this file with Python;
  ROADMAP Queue 3): the running variances after two frames, whose largest
  (~20, the sa encoder's K=32 scale) differ by ~2e-6 of their size,
  float32 summation order over 4096 rows; at lr 1e-3 the second frame's
  items and statistics, since Adam's first step moves every parameter by
  about lr * sign(g) and a gradient entry whose sign float32 rounding
  flips moves 2e-3 apart (the JAX package's own data-parallel test holds
  its T=2 step to finiteness only, tests/test_train.py:207-248).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as fnn

from cmflow_tpu.models import build_model as jax_build_model
from cmflow_tpu.models.inference import cmflow_t_infer as jax_cmflow_t_infer
from cmflow_tpu.train import steps as jsteps
from cmflow_tpu.train.state import TrainState as JaxTrainState
from cmflow_tpu.train.state import make_optimizer as jax_make_optimizer
from cmflow_tpu_torch.data import synthetic
from cmflow_tpu_torch.data.vod import VOD_CAMERA_PROJECTION, VOD_T_CAMERA_RADAR
from cmflow_tpu_torch.losses import LOSS_ITEMS
from cmflow_tpu_torch.models import CMFlowT, build_model
from cmflow_tpu_torch.models.convert import (
    export_flax_variables,
    load_flax_variables,
)
from cmflow_tpu_torch.models.inference import (
    cmflow_t_infer,
    cmflow_t_infer_seq,
)
from cmflow_tpu_torch.nn.blocks import GRUCell, init_parameters
from cmflow_tpu_torch.train.state import create_train_state
from cmflow_tpu_torch.train.steps import (
    _frame_loss,
    make_eval_step,
    make_train_step,
    make_train_step_seq,
)
from test_torch_raflow import (
    STATS,
    jax_tree,
    leaves,
    numpy,
    numpy_tree,
    padded_request,
    real_batchnorm,
)

P, TCR = VOD_CAMERA_PROJECTION, VOD_T_CAMERA_RADAR
BARS = {"flow": 1e-4, "cls": 1e-4, "gfeat": 1e-4, "trans": 5e-4,
        "agree": 0.99}
KEYS = ("pc1", "pc2", "ft1", "ft2")
C = 256  # prop_width, the GRU's width


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def inputs(batch):
    return [torch.as_tensor(batch[k]) for k in KEYS]


def masks(batch):
    return [torch.as_tensor(batch[k]) for k in ("valid1", "valid2")]


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def request_():
    batch = padded_request(5, 2, (90, 128), 128)
    batch["gfeat"] = np.tanh(np.random.default_rng(6).standard_normal(
        (2, C))).astype(np.float32)
    return batch


@pytest.fixture(scope="module")
def served(request_):
    """For each set of statistics, the port model and the JAX module's
    outputs from the same weights; on ``blend`` also the JAX engine's."""
    x, v12 = inputs(request_), masks(request_)
    g = torch.as_tensor(request_["gfeat"])
    args = [jnp.asarray(request_[k]) for k in KEYS]
    jv12 = [jnp.asarray(request_[k]) for k in ("valid1", "valid2")]
    jg = jnp.asarray(request_["gfeat"])
    jmodel = jax_build_model("cmflow_t")
    out = {}
    for name, momentum in STATS.items():
        model = build_model("cmflow_t", device="cpu", seed=7)
        real_batchnorm(model, lambda: model(*x, None, True, g, *v12),
                       momentum)
        v = jax_tree(model)
        module = jmodel.apply(v, *args, None, False, jg, *jv12)
        engine = (jax_cmflow_t_infer(v, *args, jg, *jv12, interpret=True)
                  if name == "blend" else ())
        out[name] = (model, [np.asarray(o) for o in module],
                     [np.asarray(o) for o in engine])
    return out


def assert_within_bars(got, want, valid):
    """``(sf_agg, stat_cls, pre_trans, mask, gfeat_new)``."""
    (gsf, gcls, gtrans, gmask, gg), (sf, cls, trans, mask, g) = got, want
    assert gmask.dtype == np.bool_ and gsf.shape == sf.shape
    np.testing.assert_allclose(gcls[valid], cls[valid], atol=BARS["cls"])
    np.testing.assert_allclose(gg, g, atol=BARS["gfeat"])
    np.testing.assert_allclose(gtrans, trans, atol=BARS["trans"])
    assert (gmask == mask)[valid].mean() >= BARS["agree"]
    same = (gmask == mask) & valid
    np.testing.assert_allclose(gsf[same], sf[same], atol=BARS["flow"])


@pytest.mark.parametrize("stats", sorted(STATS))
def test_module_route_matches_jax(request_, served, stats):
    model, want, _ = served[stats]
    with torch.no_grad():
        got = numpy(model(*inputs(request_), None, False,
                          torch.as_tensor(request_["gfeat"]),
                          *masks(request_)))
    valid = request_["valid1"]
    assert np.abs(want[4] - request_["gfeat"]).max() > 0.05  # GRU moved
    if stats == "batch":  # blend's stat_cls sits within 0.01 of 0.5
        assert 0 < want[3][valid].mean() < 1  # both classes
    assert_within_bars(got, want, valid)


@pytest.mark.parametrize("stats", sorted(STATS))
def test_cmflow_t_infer_matches_jax_module(request_, served, stats):
    model, want, _ = served[stats]
    got = numpy(cmflow_t_infer(model, *inputs(request_),
                               torch.as_tensor(request_["gfeat"]),
                               *masks(request_)))
    assert_within_bars(got, want, request_["valid1"])


def test_cmflow_t_infer_matches_jax_engine(request_, served):
    model, _, want = served["blend"]
    got = numpy(cmflow_t_infer(model, *inputs(request_),
                               torch.as_tensor(request_["gfeat"]),
                               *masks(request_)))
    assert_within_bars(got, want, request_["valid1"])


def test_eval_step_routes(request_, served):
    """``make_eval_step("cmflow_t")`` takes ``(batch, gfeat)``: the fused
    route is ``cmflow_t_infer``, the module route ``forward``; the CPU takes
    the module route by default."""
    model, _, _ = served["blend"]
    g = torch.as_tensor(request_["gfeat"])
    fused = make_eval_step("cmflow_t", model, fused="on")
    module = make_eval_step("cmflow_t", model)
    assert fused.fused and not module.fused
    for a, b in zip(numpy(fused(request_, g)),
                    numpy(cmflow_t_infer(model, *inputs(request_), g,
                                         *masks(request_)))):
        np.testing.assert_array_equal(a, b)
    with torch.no_grad():
        want = numpy(model(*inputs(request_), None, False, g,
                           *masks(request_)))
    for a, b in zip(numpy(module(request_, g)), want):
        np.testing.assert_array_equal(a, b)


def test_infer_seq_reset_semantics(served):
    """Lane 0 resets at frames 0 and 2, lane 1 at frame 0 only; the
    sequence equals a frame-by-frame replay with the same resets, and a
    reset drops whatever carry came before (tests/test_fused.py:211-250)."""
    model, _, _ = served["blend"]
    reqs = [padded_request(10 + t, 2, (50, 64), 64) for t in range(3)]
    stacked = {k: torch.stack([torch.as_tensor(r[k]) for r in reqs])
               for k in KEYS + ("valid1", "valid2")}
    reset = torch.zeros((3, 2), dtype=torch.bool)
    reset[0] = True
    reset[2, 0] = True
    g0 = torch.full((2, C), 7.0)
    args = [stacked[k] for k in KEYS]
    outs, gfinal = cmflow_t_infer_seq(model, *args, g0, reset,
                                      stacked["valid1"], stacked["valid2"])
    g = torch.zeros((2, C))
    for t in range(3):
        g = torch.where(reset[t][:, None], 0.0, g)
        *want, g = cmflow_t_infer(model, *(a[t] for a in args), g,
                                  stacked["valid1"][t], stacked["valid2"][t])
        for o, w in zip(outs, want):
            np.testing.assert_array_equal(o[t].numpy(), w.numpy())
    np.testing.assert_array_equal(gfinal.numpy(), g.numpy())
    # without the reset at frame 2, lane 0 carries on from frame 1
    reset[2, 0] = False
    other, _ = cmflow_t_infer_seq(model, *args, g0, reset,
                                  stacked["valid1"], stacked["valid2"])
    assert not torch.equal(other[1][2, 0], outs[1][2, 0])
    assert torch.equal(other[1][2, 1], outs[1][2, 1])


# ---------------------------------------------------------------------------
# the GRU
# ---------------------------------------------------------------------------

def test_gru_matches_flax_and_round_trips():
    rs = np.random.RandomState(3)
    h, x = (rs.randn(4, C).astype(np.float32) for _ in range(2))
    cell = fnn.GRUCell(features=C)
    v = numpy_tree(cell.init(jax.random.PRNGKey(1), jnp.asarray(h),
                             jnp.asarray(x)))
    # non-zero biases, so that each one's place shows
    for name in ("ir", "iz", "in", "hn"):
        v["params"][name]["bias"] = rs.randn(C).astype(np.float32)
    want, _ = cell.apply(v, jnp.asarray(h), jnp.asarray(x))
    port = GRUCell(C)
    load_flax_variables(port, v)
    got = port(torch.from_numpy(h), torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=1e-6)
    back = export_flax_variables(port)
    assert sorted(back["params"]) == ["hn", "hr", "hz", "in", "ir", "iz"]
    assert "bias" not in back["params"]["hr"]
    got_l, want_l = leaves(back["params"]), leaves(v["params"])
    assert sorted(got_l) == sorted(want_l)
    for k in want_l:
        np.testing.assert_array_equal(got_l[k], want_l[k], err_msg=k)


def test_model_tree_and_gru_init():
    """The whole model's tree round-trips with its ``gru``, and the GRU
    starts as flax's does: lecun-normal input kernels, orthogonal recurrent
    kernels, zero biases."""
    model = build_model("cmflow_t", device="cpu", seed=2)
    assert isinstance(model, CMFlowT) and model.stat_thres == 0.5
    tree = export_flax_variables(model)
    assert sorted(tree["params"]) == ["fp", "gru", "mp", "trunk"]
    other = build_model("cmflow_t", device="cpu", seed=8)
    load_flax_variables(other, tree)
    for (k, a), b in zip(model.state_dict().items(),
                         other.state_dict().values()):
        assert torch.equal(a, b), k
    gru = model.gru
    eye = torch.eye(C)
    for lin in (gru.hr, gru.hz, gru.hn):
        w = lin.weight.detach()
        torch.testing.assert_close(w @ w.T, eye, atol=1e-5, rtol=0)
    for name in ("ir", "iz", "in"):
        w = getattr(gru, name).weight.detach()
        assert abs(float(w.std()) * C ** 0.5 - 1.0) < 0.05
        assert float(w.abs().max()) <= 2.0 / 0.8796 / C ** 0.5 + 1e-6
        assert not getattr(gru, name).bias.any()
    assert not gru.hn.bias.any()
    # the draw is the seed's
    again = CMFlowT()
    init_parameters(again, torch.Generator().manual_seed(2))
    for (k, a), b in zip(model.state_dict().items(),
                         again.state_dict().values()):
        assert torch.equal(a, b), k


# ---------------------------------------------------------------------------
# the mini-clip train step
# ---------------------------------------------------------------------------

LRS = {"lr0": 0.0, "lr1e-3": 1e-3}
MODEL_SEED = 4
# a GRU carry going into frame 0 (``seeded``)
SEEDED = np.tanh(np.random.default_rng(6).standard_normal(
    (2, C))).astype(np.float32)


@pytest.fixture(scope="module")
def frames():
    """Frames 0 and 1 of the synthetic train set, B=2, N=64."""
    return [synthetic.make_train_batch(s, 2, 64) for s in (0, 1)]


def stack(*frames):
    return {k: np.stack([f[k] for f in frames], axis=1) for k in frames[0]}


@pytest.fixture(scope="module")
def seq_steps(frames):
    """The JAX package's and the port's ``make_train_step_seq`` at each
    learning rate of ``LRS``, on the clip of frames 0 and 1 from the same
    weights, one clip batch per epoch (the schedule decays 0.9 per
    optimizer update).  The port's gradients left after the step are the
    second frame's."""
    clip = stack(*frames)
    jclip = {k: jnp.asarray(v) for k, v in clip.items()}
    variables = export_flax_variables(
        build_model("cmflow_t", device="cpu", seed=MODEL_SEED))
    jstep = jsteps.make_train_step_seq(jax_build_model("cmflow_t"), P, TCR)
    out = {"before": variables}
    for name, lr in LRS.items():
        tx = jax_make_optimizer(lr=lr, steps_per_epoch=1)
        jstate = JaxTrainState(step=jnp.zeros((), jnp.int32),
                               params=variables["params"],
                               batch_stats=variables["batch_stats"],
                               opt_state=tx.init(variables["params"]), tx=tx)
        jstate, jitems = jstep(jstate, jclip)
        port = build_model("cmflow_t", device="cpu", seed=MODEL_SEED)
        state = create_train_state(port, steps_per_epoch=1, lr=lr)
        items = make_train_step_seq(port, P, TCR)(state, clip)
        out[name] = dict(
            jax_items={k: float(v) for k, v in jitems.items()},
            jax_after=numpy_tree({"params": jstate.params,
                                  "batch_stats": jstate.batch_stats}),
            jax_count=int(jstate.opt_state[1][0].count),
            items={k: float(v) for k, v in items.items()},
            after=export_flax_variables(port), state=state,
            grads=leaves(export_flax_variables(port, grads=True)["params"]))
    return out


def test_seq_step_items_and_stats_at_lr0(seq_steps):
    run = seq_steps["lr0"]
    assert sorted(run["items"]) == sorted(LOSS_ITEMS["cmflow_t"])
    for k, want in run["jax_items"].items():
        np.testing.assert_allclose(run["items"][k], want, rtol=1e-4,
                                   err_msg=k)
    g = leaves(run["after"]["batch_stats"])
    w = leaves(run["jax_after"]["batch_stats"])
    before = leaves(seq_steps["before"]["batch_stats"])
    assert sorted(g) == sorted(w)
    for k in w:
        if k.endswith("['mean']"):
            np.testing.assert_allclose(g[k], w[k], rtol=0, atol=1e-5,
                                       err_msg=k)
    assert all(np.any(w[k] != before[k]) for k in w)
    # at lr 0 the weights stay put on both sides
    g, w = leaves(run["after"]["params"]), leaves(run["jax_after"]["params"])
    for k in w:
        np.testing.assert_array_equal(w[k], leaves(
            seq_steps["before"]["params"])[k], err_msg=k)
        np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_seq_step_params_and_schedule_at_lr1e3(seq_steps):
    """The parameters after both updates within the bar (atol 5e-3) of
    JAX's; two Adam steps move each by about 2e-3 whatever the gradient,
    so this holds the optimizer and the schedule, not the gradients (the
    tests below hold those)."""
    run = seq_steps["lr1e-3"]
    g, w = leaves(run["after"]["params"]), leaves(run["jax_after"]["params"])
    before = leaves(seq_steps["before"]["params"])
    assert sorted(g) == sorted(w)
    for k in w:
        np.testing.assert_allclose(g[k], w[k], rtol=0, atol=5e-3, err_msg=k)
    assert all(np.any(w[k] != before[k]) for k in w)
    assert all(np.isfinite(v) for v in run["items"].values())
    # one optimizer and one schedule step per frame: two updates, and the
    # staircase at one clip batch per epoch has decayed twice
    state = run["state"]
    assert state.step == 2 == run["jax_count"]
    assert all(float(s["step"]) == 2.0
               for s in state.optimizer.state.values())
    # the JAX package's schedule (train/state.py:56-61) at its count
    schedule = optax.exponential_decay(1e-3, 1, 0.9, staircase=True)
    lr = state.scheduler.get_last_lr()[0]
    assert lr == pytest.approx(1e-3 * 0.9 ** 2)
    assert float(schedule(run["jax_count"])) == pytest.approx(lr)


# ---------------------------------------------------------------------------
# the train gradients
# ---------------------------------------------------------------------------

def gradient_errors(got: dict, want: dict) -> dict:
    """Each leaf's relative L2 error (of those whose JAX gradient is not
    exactly zero), the leaves exactly zero in JAX's, and the whole
    gradient's relative L2 error."""
    assert sorted(got) == sorted(want)
    assert all(np.isfinite(g).all() for g in got.values())
    zero = sorted(k for k, w in want.items() if not w.any())
    leaf = {k: float(np.linalg.norm(got[k] - w) / np.linalg.norm(w))
            for k, w in want.items() if k not in zero}
    whole = np.sqrt(sum(np.sum((got[k] - w) ** 2) for k, w in want.items())
                    / sum(np.sum(w ** 2) for w in want.values()))
    return dict(leaf=leaf, zero=zero, whole=float(whole))


def assert_gradients_within_bars(got: dict, want: dict) -> None:
    err = gradient_errors(got, want)
    for k in err["zero"]:
        np.testing.assert_array_equal(got[k], 0.0, err_msg=k)
    bad = {k: v for k, v in err["leaf"].items() if not v <= 3e-2}
    assert not bad, bad
    assert err["whole"] <= 1e-2, err["whole"]


@pytest.fixture(scope="module")
def jax_grads(seq_steps, frames):
    """``jax.value_and_grad`` of the JAX package's ``_frame_loss`` on the
    port's weights: frame 0 from a zero and from the ``SEEDED`` carry, and
    frames 0 and 1 from the carry frame 0 leaves (the second frame of the
    clip of frame 0 twice, and of frames 0 and 1, at lr 0)."""
    variables = seq_steps["before"]
    jmodel = jax_build_model("cmflow_t")

    def loss(params, frame, gfeat):
        return jsteps._frame_loss("cmflow_t", jmodel, params,
                                  variables["batch_stats"], frame,
                                  jnp.asarray(P), jnp.asarray(TCR), 0.3,
                                  gfeat)

    value_and_grad = jax.jit(jax.value_and_grad(loss, has_aux=True))

    def run(frame, gfeat):
        (_, (items, _, gnew)), grads = value_and_grad(
            variables["params"], {k: jnp.asarray(v) for k, v in
                                  frame.items()}, jnp.asarray(gfeat))
        return dict(items={k: float(v) for k, v in items.items()},
                    gfeat=np.asarray(gnew), grads=leaves(numpy_tree(grads)))

    out = {"zero": run(frames[0], np.zeros((2, C), np.float32)),
           "seeded": run(frames[0], SEEDED)}
    carry = out["zero"]["gfeat"]
    out["first_frame_twice"] = run(frames[0], carry)
    out["two_frames"] = run(frames[1], carry)
    return out


@pytest.mark.parametrize("carry", ["zero", "seeded"])
def test_frame_loss_gradients_match_jax(frames, jax_grads, carry):
    """The port's ``_frame_loss("cmflow_t")`` and its backward from a zero
    carry (the GRU's recurrent kernels get no gradient) and from a seeded
    one (they do)."""
    want = jax_grads[carry]
    model = build_model("cmflow_t", device="cpu", seed=MODEL_SEED)
    gfeat = np.zeros((2, C), np.float32) if carry == "zero" else SEEDED
    x = {k: torch.as_tensor(v) for k, v in frames[0].items()}
    loss, items, gnew = _frame_loss("cmflow_t", model, x, torch.as_tensor(P),
                                    torch.as_tensor(TCR), 0.3,
                                    torch.as_tensor(gfeat))
    loss.backward()
    for k, w in want["items"].items():
        np.testing.assert_allclose(float(items[k].detach()), w, rtol=1e-4,
                                   err_msg=k)
    np.testing.assert_allclose(gnew.detach().numpy(), want["gfeat"], rtol=0,
                               atol=1e-4)
    got = leaves(export_flax_variables(model, grads=True)["params"])
    err = gradient_errors(got, want["grads"])
    # from a zero carry the recurrent kernels have no gradient, nor has the
    # reset gate, which scales ``W_hn h + b_hn`` (zero: b_hn starts at 0)
    at_zero = ["['gru']['hn']['kernel']", "['gru']['hr']['kernel']",
               "['gru']['hz']['kernel']", "['gru']['ir']['bias']",
               "['gru']['ir']['kernel']"]
    assert [k for k in err["zero"] if "['gru']" in k] == (
        at_zero if carry == "zero" else []), err["zero"]
    assert_gradients_within_bars(got, want["grads"])


@pytest.mark.parametrize("clip", ["one_frame", "first_frame_twice"])
def test_seq_step_gradients_match_jax(frames, jax_grads, clip):
    """``make_train_step_seq`` at lr 0 leaves its last frame's gradients:
    frame 0 from the zero carry (T=1), or frame 0 again from the carry the
    first frame left (T=2; truncated back-propagation: nothing flows into
    the first frame)."""
    model = build_model("cmflow_t", device="cpu", seed=MODEL_SEED)
    clip_ = stack(frames[0]) if clip == "one_frame" else stack(frames[0],
                                                              frames[0])
    make_train_step_seq(model, P, TCR)(
        create_train_state(model, steps_per_epoch=1, lr=0.0), clip_)
    got = leaves(export_flax_variables(model, grads=True)["params"])
    want = jax_grads["zero" if clip == "one_frame" else clip]["grads"]
    assert_gradients_within_bars(got, want)


def test_seq_step_gradients_on_two_frames(seq_steps, jax_grads):
    """The second frame's gradients on the clip of frames 0 and 1 at lr 0:
    the median leaf within the per-leaf bar.  The whole gradient is not
    held: there float32 rounding alone moves it by ~1e-2 (the port on one
    CPU thread lies 1.1e-2 from itself on two, JAX's float32 gradients
    1.4e-2 from its float64 ones; ``python tests/test_torch_cmflow_t.py
    gradients``; ROADMAP Queue 3)."""
    err = gradient_errors(seq_steps["lr0"]["grads"],
                          jax_grads["two_frames"]["grads"])
    assert not err["zero"]
    assert np.median(list(err["leaf"].values())) <= 3e-2, err


def test_seq_step_api():
    model = build_model("cmflow_t", device="cpu")
    with pytest.raises(ValueError, match="make_train_step_seq"):
        make_train_step("cmflow_t", model, P, TCR)
    step = make_train_step_seq(model, P, TCR)
    with pytest.raises(ValueError, match="another model"):
        step(create_train_state(build_model("cmflow_t", device="cpu")),
             {k: v[:, None] for k, v in synthetic.make_train_batch(
                 0, 1, 32).items()})


# ---------------------------------------------------------------------------
# what does not meet the bars, measured
# ---------------------------------------------------------------------------

def measure_seq_step() -> None:
    """How far the port's T=2 mini-clip step lies from the JAX package's
    at B=2, N=64, full width, one clip batch an epoch: for each learning
    rate (0, 1e-3) and clip (one frame twice, two frames) one JSON line with
    the loss items' largest relative error, the BatchNorm running means'
    and variances' largest absolute error (and the largest variance), and
    the parameters' largest absolute error after both updates.  The tests
    above hold what meets the bars; this measures the rest (ROADMAP
    Queue 3).  Run ``JAX_PLATFORMS=cpu PYTHONPATH=. python
    tests/test_torch_cmflow_t.py`` from the repository root."""
    variables = export_flax_variables(build_model("cmflow_t", "cpu", seed=4))
    jmodel = jax_build_model("cmflow_t")
    step = jsteps.make_train_step_seq(jmodel, P, TCR)
    for lr in (0.0, 1e-3):
        for seeds in ((0, 0), (0, 1)):
            frames = [synthetic.make_train_batch(s, 2, 64) for s in seeds]
            clip = {k: np.stack([f[k] for f in frames], 1) for k in frames[0]}
            tx = jax_make_optimizer(lr=lr, steps_per_epoch=1)
            jstate = JaxTrainState(
                step=jnp.zeros((), jnp.int32), params=variables["params"],
                batch_stats=variables["batch_stats"],
                opt_state=tx.init(variables["params"]), tx=tx)
            jstate, jitems = step(jstate, {k: jnp.asarray(v)
                                           for k, v in clip.items()})
            port = build_model("cmflow_t", "cpu", seed=4)
            items = make_train_step_seq(port, P, TCR)(
                create_train_state(port, steps_per_epoch=1, lr=lr), clip)
            got = leaves(export_flax_variables(port))
            want = leaves({"params": jstate.params,
                           "batch_stats": jstate.batch_stats})

            def worst(suffix, prefix=""):
                return max(float(np.abs(got[k] - w).max())
                           for k, w in want.items()
                           if k.startswith(prefix) and k.endswith(suffix))

            print(json.dumps(dict(
                lr=lr, frames=list(seeds),
                items_max_rel_err=max(
                    abs(float(items[k]) - float(v)) / abs(float(v))
                    for k, v in jitems.items()),
                bn_mean_max_abs_err=worst("['mean']"),
                bn_var_max_abs_err=worst("['var']"),
                bn_var_max=max(float(w.max()) for k, w in want.items()
                               if k.endswith("['var']")),
                params_max_abs_err=worst("", "['params']"))), flush=True)


def second_frame_grads(port_or_variables, clips, scale: float = 0.0,
                       float64: bool = False) -> dict:
    """The second frame's gradients of the lr-0 mini-clip step on each clip
    of ``clips`` (pairs of train-set frame seeds, B=2, N=64), every
    frame's features moved by ``scale`` of their size (seeded noise): from
    the port's ``make_train_step_seq`` when given a model seed, from
    ``jax.value_and_grad`` of the JAX package's ``_frame_loss`` (frame 0
    from a zero carry, frame 1 from the carry frame 0 left) when given
    flax variables, in float64 (``jax.enable_x64``) when ``float64``."""
    rs = np.random.RandomState(0)
    out = {}
    for seeds in clips:
        frames = [synthetic.make_train_batch(s, 2, 64) for s in seeds]
        for f in frames:
            f["ft1"] = (f["ft1"] * (1 + scale * rs.standard_normal(
                f["ft1"].shape))).astype(np.float32)
        if isinstance(port_or_variables, int):
            port = build_model("cmflow_t", "cpu", seed=port_or_variables)
            make_train_step_seq(port, P, TCR)(
                create_train_state(port, steps_per_epoch=1, lr=0.0),
                stack(*frames))
            out[seeds] = leaves(export_flax_variables(port,
                                                      grads=True)["params"])
            continue
        dtype = jnp.float64 if float64 else jnp.float32
        with jax.enable_x64(float64):
            cast = lambda t: jax.tree_util.tree_map(  # noqa: E731
                lambda a: jnp.asarray(a, dtype)
                if np.asarray(a).dtype.kind == "f" else jnp.asarray(a), t)
            v, jmodel = cast(port_or_variables), jax_build_model("cmflow_t")
            vg = jax.jit(jax.value_and_grad(
                lambda p_, f_, g_: jsteps._frame_loss(
                    "cmflow_t", jmodel, p_, v["batch_stats"], f_,
                    jnp.asarray(P, dtype), jnp.asarray(TCR, dtype), 0.3, g_),
                has_aux=True))
            gfeat = jnp.zeros((2, C), dtype)
            for f in frames:
                (_, (_, _, gfeat)), grads = vg(v["params"], cast(f), gfeat)
            out[seeds] = leaves(numpy_tree(grads))
    return out


def on_threads(n: int, fn, *args):
    before = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        return fn(*args)
    finally:
        torch.set_num_threads(before)


def measure_gradients(card_npz=None) -> None:
    """The second frame's gradients of the lr-0 T=2 step (model seed 4,
    B=2, N=64) on the first frame twice and on two frames: one JSON line
    per pair compared (worst leaf, median leaf and whole gradient's relative
    L2 errors): the port on the CPU (one thread, and two) and the JAX
    package in float32 against the JAX package in float64 and against each
    other; the port on two threads against itself on one; each of the
    float32 runs against itself with the features moved by 1e-7 of their
    size; and,
    given the ``.npz`` that ``scripts/profile_torch_seq_grad_jitter.py
    --case --save`` writes on a GPU from :func:`write_case`'s file, that
    card's against JAX in float64 and float32 and against this CPU's
    port."""
    clips = ((0, 0), (0, 1))
    variables = export_flax_variables(build_model("cmflow_t", "cpu",
                                                  seed=MODEL_SEED))
    runs = {"jax float64": second_frame_grads(variables, clips,
                                              float64=True),
            "jax": second_frame_grads(variables, clips),
            "port": second_frame_grads(MODEL_SEED, clips),
            "port on 2 threads": on_threads(2, second_frame_grads,
                                            MODEL_SEED, clips),
            "jax moved 1e-7": second_frame_grads(variables, clips, 1e-7),
            "port moved 1e-7": second_frame_grads(MODEL_SEED, clips, 1e-7)}
    pairs = [("port", "jax float64"), ("port on 2 threads", "jax float64"),
             ("jax", "jax float64"), ("port", "jax"),
             ("port on 2 threads", "port"), ("jax moved 1e-7", "jax"),
             ("port moved 1e-7", "port")]
    if card_npz:
        saved = np.load(card_npz)
        runs["card"] = {c: {k.split("|")[2]: saved[k] for k in saved.files
                            if k.startswith(f"card|{c[0]},{c[1]}|")}
                        for c in clips}
        pairs += [("card", "jax float64"), ("card", "jax"), ("card", "port"),
                  ("card", "port on 2 threads")]
    for got, want in pairs:
        for c in clips:
            err = gradient_errors(runs[got][c], runs[want][c])
            worst = max(err["leaf"], key=err["leaf"].get)
            print(json.dumps(dict(
                frames=list(c), got=got, want=want, worst_leaf=worst,
                worst_leaf_rel_l2=err["leaf"][worst],
                median_leaf_rel_l2=float(np.median(list(
                    err["leaf"].values()))),
                whole_rel_l2=err["whole"])), flush=True)


def write_case(path: str) -> None:
    """The case ``measure_gradients`` measures, for
    ``scripts/profile_torch_seq_grad_jitter.py --case``: the port's weights
    from ``MODEL_SEED`` (``state|<name>``) and train-set frames 0 and 1
    (``frame<i>|<field>``)."""
    state = build_model("cmflow_t", "cpu", seed=MODEL_SEED).state_dict()
    out = {f"state|{k}": v.numpy() for k, v in state.items()}
    for i in (0, 1):
        out.update({f"frame{i}|{k}": v for k, v in
                    synthetic.make_train_batch(i, 2, 64).items()})
    np.savez(path, **out)


if __name__ == "__main__":
    # JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_cmflow_t.py
    #   [steps | gradients [CARD.npz] | case CASE.npz]
    import sys

    jax.config.update("jax_platforms", "cpu")
    torch.set_num_threads(1)
    if sys.argv[1:2] == ["gradients"]:
        measure_gradients(*sys.argv[2:3])
    elif sys.argv[1:2] == ["case"]:
        write_case(sys.argv[2])
    else:
        measure_seq_step()
