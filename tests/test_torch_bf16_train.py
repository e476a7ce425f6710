"""Port parity: bf16 training (``compute_dtype: bfloat16``) against the JAX
package on the CPU, at B=2, N=64 and full width.

The port's bf16 chain (``cmflow_tpu_torch/nn/blocks.py``) follows the JAX
package's "auto" arm: bf16 Dense products summed in float32, BatchNorm in
float32, a bf16 re-round after each BN'd activation but the train-mode
pre-pool one, pre-rounded gather bases.  Its bf16 gathers take the bf16
arms of K6 and K7; on CPU tensors their wrappers run the plain versions.

* K6 bf16's plain version against ``mxu_group_points`` on bf16 points in
  interpret mode: bit for bit (each row an exact copy), indices outside
  ``[0, N)`` included.
* K7 bf16's plain version against the same kernel's VJP on a bf16
  cotangent: within one bf16 ulp of each element (both sum in float32, in
  another order, and round once), bf16 out.
* The bf16 module forward of each family against the JAX package's bf16
  ``model.apply`` from the same weights, in eval and in train mode, at the
  JAX package's own bf16 bars (``tests/test_models.py:189-193``): stat_cls
  and pre_trans atol 2e-2; and nearer JAX's bf16 than JAX's float32 is
  (root mean square), which shows that the port rounds where JAX does.
* One bf16 ``make_train_step`` (CMFlow, RaFlow) and one bf16
  ``make_train_step_seq`` (CMFlow_T, T=2, learning rate 0) against the JAX
  package's bf16 frame loss (``_frame_loss``, the body of its steps; at
  learning rate 0 the clip step is its two frames in turn): loss items,
  BatchNorm statistics and gradients (relative L2, per leaf and whole).
  The bars (``TRAIN_BARS``) stand beside the distance JAX's own bf16 step
  lies from its float32 step on the same batch (``JAX_BF16_FROM_F32``;
  ``JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_bf16_train.py``
  prints both distances).  On the CPU the JAX package gathers with XLA,
  whose transpose sums bf16 cotangents in bf16; the port's K7 sums them in
  float32, as the JAX package's Pallas kernel does on the TPU.
* The structural guards of ``tests/test_models.py:160-280``: parameters,
  gradients, Adam's moments and BatchNorm statistics stay float32; every
  BatchNorm emits float32 in train mode; the last BN'd layer of each chain
  (the pre-pool boundary) emits float32 in train mode and bf16 in eval.
* ``Config(compute_dtype="bfloat16")``, ``--compute_dtype bfloat16``
  through the CLI for one epoch, and a bf16 checkpoint's round trip and
  resume, bit for bit.
"""

import copy
import json
import os
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import unfreeze

from cmflow_tpu.models import build_model as jax_build_model
from cmflow_tpu.nn import blocks as jblocks
from cmflow_tpu.ops import pointops as jpointops
from cmflow_tpu.ops.fused import mxu_group_points
from cmflow_tpu.train import steps as jsteps
from cmflow_tpu_torch.cli import main as climain
from cmflow_tpu_torch.data.synthetic import (
    make_train_batch,
    write_synthetic_dataset,
)
from cmflow_tpu_torch.data.vod import VOD_CAMERA_PROJECTION, VOD_T_CAMERA_RADAR
from cmflow_tpu_torch.losses import LOSS_ITEMS
from cmflow_tpu_torch.models import build_model
from cmflow_tpu_torch.models.convert import (
    export_flax_variables,
    load_flax_variables,
)
from cmflow_tpu_torch.nn.blocks import (
    BatchNorm,
    FeatureCorrelator,
    PointLocalFeature,
    PointwiseMLP,
)
from cmflow_tpu_torch.ops import fused, pointops
from cmflow_tpu_torch.train import loop, steps
from cmflow_tpu_torch.train.state import create_train_state
from cmflow_tpu_torch.utils import config

P, TCR = VOD_CAMERA_PROJECTION, VOD_T_CAMERA_RADAR
BF16 = torch.bfloat16
FAMILIES = ("cmflow", "raflow", "cmflow_t")
MODEL_SEED = 11
C = 256  # CMFlow_T's prop_width, the GRU's width
# the JAX package's bf16 forward bars (tests/test_models.py:189-193)
FORWARD_BARS = {"cls": 2e-2, "trans": 2e-2}
# one bf16 train step of the port against JAX's bf16 step: loss items
# (the largest relative error), BatchNorm running statistics (the largest
# absolute error), gradients (the median leaf's relative L2 error, and the
# whole gradient's).  On random weights bf16's rounding flips maxima over
# neighbours, masks and inlier sets through the whole step, so two bf16
# implementations, or bf16 and float32, give gradients ~70% apart: JAX's
# own bf16 step lies this far from its float32 step on the same weights and
# batch (``JAX_BF16_FROM_F32``, printed by running this file); the port's
# lies within the bars below (measured items 0.016-0.067, statistics
# 0.0037-0.0084, median leaf 0.62-0.69, whole 0.71-0.72), at or below
# JAX's own distance in each but CMFlow's items.  The blocks' test above
# is the close one.
TRAIN_BARS = {"items_rtol": 0.1, "stats_atol": 1e-2,
              "grad_leaf_l2_median": 0.75, "grad_l2": 0.75}
JAX_BF16_FROM_F32 = {
    "cmflow": {"items_rtol": 0.046, "stats_atol": 0.023,
               "grad_leaf_l2_median": 0.69, "grad_l2": 0.73},
    "raflow": {"items_rtol": 0.26, "stats_atol": 0.023,
               "grad_leaf_l2_median": 0.80, "grad_l2": 0.85},
    "cmflow_t": {"items_rtol": 0.031, "stats_atol": 0.039,
                 "grad_leaf_l2_median": 0.72, "grad_l2": 0.80},
}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, unfreeze(tree))


def leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(a)
            for p, a in jax.tree_util.tree_flatten_with_path(tree)[0]}


def f32(x) -> np.ndarray:
    """A bf16 or float32 array or tensor as float32 numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def bf16_ulp(x: np.ndarray) -> np.ndarray:
    """One bf16 ulp at each magnitude (8 significant bits)."""
    _, e = np.frexp(np.abs(x))
    return np.ldexp(1.0, e - 8)


# ---------------------------------------------------------------------------
# K6 and K7, the bf16 arms' plain versions
# ---------------------------------------------------------------------------

def gather_case(c: int, seed: int = 0):
    """bf16 points ``[2, 64, c]``, indices ``[2, 64, 8]`` with some outside
    ``[0, 64)``, and a bf16 cotangent ``[2, 64, 8, c]``."""
    rng = np.random.default_rng(seed)
    b, n, s, k = 2, 64, 64, 8
    pts = (rng.standard_normal((b, n, c)) * 4).astype(np.float32)
    idx = rng.integers(0, n, (b, s, k)).astype(np.int32)
    idx[0, 3, 2], idx[1, 7, 0], idx[1, 9, 5] = -1, n, n + 40
    cot = rng.standard_normal((b, s, k, c)).astype(np.float32)
    return (jnp.asarray(pts, jnp.bfloat16), idx,
            jnp.asarray(cot, jnp.bfloat16))


def to_torch_bf16(x) -> torch.Tensor:
    return torch.from_numpy(f32(x)).to(BF16)


@pytest.mark.parametrize("c", [5, 32, 512])
def test_gather_bf16_plain_matches_jax_bit_for_bit(c):
    pts, idx, _ = gather_case(c)
    want = mxu_group_points(pts, jnp.asarray(idx), True)
    assert want.dtype == jnp.bfloat16
    b, s, k = idx.shape
    got = fused.gather_rows_plain(to_torch_bf16(pts),
                                  torch.from_numpy(idx.reshape(b, s * k)))
    assert got.dtype == BF16
    np.testing.assert_array_equal(f32(got).reshape(b, s, k, c), f32(want))
    # the wrapper on CPU tensors is the plain version, through autograd too
    grouped = pointops.group_points(to_torch_bf16(pts), torch.from_numpy(idx))
    assert grouped.dtype == BF16
    np.testing.assert_array_equal(f32(grouped), f32(want))


@pytest.mark.parametrize("c", [5, 32, 512])
def test_gather_backward_bf16_plain_within_one_ulp_of_jax(c):
    pts, idx, cot = gather_case(c, seed=1)
    _, vjp = jax.vjp(lambda p: mxu_group_points(p, jnp.asarray(idx), True),
                     pts)
    (want,) = vjp(cot)
    assert want.dtype == jnp.bfloat16
    b, s, k = idx.shape
    got = fused.gather_rows_backward_plain(
        to_torch_bf16(cot).reshape(b, s * k, c),
        torch.from_numpy(idx.reshape(b, s * k)), pts.shape[1])
    assert got.dtype == BF16
    g, w = f32(got), f32(want)
    assert np.all(np.abs(g - w) <= bf16_ulp(np.maximum(np.abs(g),
                                                       np.abs(w))))
    assert (g == w).mean() >= 0.9
    # autograd hands the bf16 gather a bf16 cotangent and gets bf16 back
    p = to_torch_bf16(pts).requires_grad_(True)
    out = pointops.group_points(p, torch.from_numpy(idx))
    out.backward(to_torch_bf16(cot))
    assert p.grad.dtype == BF16
    np.testing.assert_array_equal(f32(p.grad), g)


def test_gather_wrappers_take_float32_and_bf16_only():
    idx = torch.zeros((1, 4), dtype=torch.int32)
    for dtype in (torch.float16, torch.float64):
        with pytest.raises(TypeError):
            fused.gather_rows(torch.zeros((1, 3, 8), dtype=dtype), idx)
        with pytest.raises(TypeError):
            fused.gather_rows_backward(torch.zeros((1, 4, 8), dtype=dtype),
                                       idx, 3)
    # float32 keeps its float32 result
    g = torch.ones((1, 4, 8))
    assert fused.gather_rows_backward(g, idx, 3).dtype == torch.float32


# ---------------------------------------------------------------------------
# the blocks, in train mode: forward and gradients
# ---------------------------------------------------------------------------

def block_case(kind: str):
    """A JAX block in bf16 and in float32, the port's bf16 counterpart and
    its inputs (B=2, N=64)."""
    rs = np.random.RandomState(3)
    bf = jnp.bfloat16
    if kind in ("mlp", "mlp_leaky"):
        kw = (dict(use_bn=False, use_bias=True, negative_slope=0.1)
              if kind == "mlp_leaky" else {})
        args = (rs.randn(2, 32, 8, 12).astype(np.float32),)
        return (jblocks.PointwiseMLP((32, 16), dtype=bf, **kw),
                jblocks.PointwiseMLP((32, 16), **kw),
                PointwiseMLP(12, (32, 16), dtype=BF16, **kw), args)
    batch = make_train_batch(1, 2, 64)
    if kind == "sa_k8":
        args = (batch["pc1"], rs.randn(2, 64, 3).astype(np.float32))
        mlp = ((32, 32, 64), (64, 64, 64))
        return (jblocks.PointLocalFeature(4.0, 8, *mlp, dtype=bf),
                jblocks.PointLocalFeature(4.0, 8, *mlp),
                PointLocalFeature(4.0, 8, 3, *mlp, dtype=BF16), args)
    args = (batch["pc1"], batch["pc2"],
            *(rs.randn(2, 64, 32).astype(np.float32) for _ in range(2)))
    return (jblocks.FeatureCorrelator(8, (64, 64), dtype=bf),
            jblocks.FeatureCorrelator(8, (64, 64)),
            FeatureCorrelator(8, 32, 32, (64, 64), dtype=BF16), args)


def rms(a, b) -> float:
    return float(np.sqrt(np.mean((a - b) ** 2)))


def rel_l2(a, b) -> float:
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


# a block's port bf16 result against JAX's bf16, over JAX's float32 against
# JAX's bf16: the output's root mean square (measured 0.00-0.09), each
# gradient leaf's relative L2 (0.00-0.14), a Dense bias's (0.09-1.19).  A
# Dense bias's gradient is a sum of bf16 cotangents over every row, which
# the port adds in float32 (as the TPU does) and XLA's CPU backend in its
# own way: there the two lie about as far apart as JAX's bf16 and float32.
BLOCK_NEARER = {"output": 0.25, "grad": 0.5, "dense_bias": 1.5}


@pytest.mark.parametrize("kind", ["mlp", "mlp_leaky", "sa_k8",
                                  "cost_volume"])
def test_block_matches_jax_bf16_in_train_mode(kind, monkeypatch):
    """Each block of the bf16 chain in train mode, from the same weights and
    inputs: the port's output and parameter gradients lie several times
    nearer JAX's bf16 than JAX's float32 does, so it rounds where JAX does
    (a missed or extra rounding shows at float32's distance).  The JAX
    blocks gather through ``mxu_group_points`` in interpret mode, the
    Pallas kernels the JAX package runs on the TPU (K6, K7), whose bf16
    transpose sums in float32 as the port's does."""
    monkeypatch.setattr(jpointops, "group_points",
                        lambda p, i: mxu_group_points(p, i, True))
    j16, j32, port, args = block_case(kind)
    jargs = [jnp.asarray(a) for a in args]
    v = numpy_tree(j16.init(jax.random.PRNGKey(4), *jargs, True))
    r = np.random.RandomState(5).randn(
        *np.asarray(j32.apply(v, *jargs, True, mutable=["batch_stats"])[0])
        .shape).astype(np.float32)

    def run(mod):
        def f(params):
            y, _ = mod.apply({"params": params,
                              "batch_stats": v.get("batch_stats", {})},
                             *jargs, True, mutable=["batch_stats"])
            return jnp.sum(y.astype(jnp.float32) * r), y
        (_, y), g = jax.value_and_grad(f, has_aux=True)(v["params"])
        return f32(y), leaves(numpy_tree(g))

    y16, g16 = run(j16)
    y32, g32 = run(j32)
    load_flax_variables(port, v)
    y = port(*(torch.as_tensor(a) for a in args), True)
    (y.float() * torch.as_tensor(r)).sum().backward()
    gp = leaves(export_flax_variables(port, grads=True)["params"])
    assert sorted(gp) == sorted(g16)
    assert rms(f32(y), y16) <= BLOCK_NEARER["output"] * rms(y32, y16)
    for k, w in g16.items():
        bar = BLOCK_NEARER["dense_bias" if "['dense_" in k
                           and k.endswith("['bias']") else "grad"]
        assert rel_l2(gp[k], w) <= bar * rel_l2(g32[k], w), k


# ---------------------------------------------------------------------------
# the module forward
# ---------------------------------------------------------------------------

def jax_model(family: str, dtype: str):
    return jax_build_model(family,
                           types.SimpleNamespace(compute_dtype=dtype))


def port_model(family: str) -> torch.nn.Module:
    return build_model(family, "cpu", seed=MODEL_SEED,
                       compute_dtype="bfloat16")


def forward_args(family: str, batch: dict, train: bool, lib):
    """The forward's arguments after ``pc1, pc2, ft1, ft2``: CMFlow's
    ``label_m`` (None), RaFlow's ``interval``, CMFlow_T's also a seeded
    carry."""
    conv = jnp.asarray if lib == "jax" else torch.as_tensor
    if family == "raflow":
        return (conv(batch["interval"]), train)
    if family == "cmflow":
        return (None, train)
    return (None, train, conv(np.tanh(np.random.default_rng(6)
                                      .standard_normal((2, C)))
                              .astype(np.float32)))


# each family's continuous outputs: CMFlow's (sf_agg, stat_cls, pre_trans),
# RaFlow's (coarse flow, sf_agg, pre_trans), CMFlow_T's also its carry
CONTINUOUS = {"cmflow": (0, 1, 2), "raflow": (0, 1, 2),
              "cmflow_t": (0, 1, 2, 4)}
CLS = {"cmflow": 1, "raflow": None, "cmflow_t": 1}


@pytest.fixture(scope="module", params=FAMILIES)
def forwards(request):
    """Each family's outputs from the port's seeded weights: ``unit``, eval
    mode at the initial statistics (mean 0, variance 1), the JAX package's
    own bf16 test's setting; ``eval``, eval mode at the statistics of one
    train-mode forward of the batch; ``train``.  For each, the port's bf16
    model, JAX's bf16 ``model.apply`` and (but ``unit``) JAX's float32 one;
    and the dtypes each port BatchNorm and each BN'd PointwiseMLP emitted."""
    family = request.param
    batch = make_train_batch(0, 2, 64)
    model = port_model(family)
    targs = [torch.as_tensor(batch[k]) for k in ("pc1", "pc2", "ft1", "ft2")]
    jargs = [jnp.asarray(batch[k]) for k in ("pc1", "pc2", "ft1", "ft2")]
    models = {"unit": copy.deepcopy(model)}
    for bn in model.modules():  # running statistics of the batch
        if isinstance(bn, BatchNorm):
            bn.MOMENTUM = 0.0
    with torch.no_grad():
        model(*targs, *forward_args(family, batch, True, "torch"))
    for bn in model.modules():
        if isinstance(bn, BatchNorm):
            del bn.MOMENTUM
    models["eval"] = models["train"] = model
    out = {"family": family}
    fns = {}
    for dtype in ("bfloat16", "float32"):
        m = jax_model(family, dtype)
        for train in (False, True):
            fns[dtype, train] = jax.jit(lambda v, m=m, train=train: m.apply(
                v, *jargs, *forward_args(family, batch, train, "jax"),
                mutable=["batch_stats"] if train else False))
    for mode, train in (("unit", False), ("eval", False), ("train", True)):
        variables = jax.tree_util.tree_map(
            jnp.asarray, export_flax_variables(models[mode]))
        res = {}
        for dtype in ("bfloat16", "float32")[:1 if mode == "unit" else 2]:
            o = fns[dtype, train](variables)
            res[dtype] = [f32(x) for x in (o[0] if train else o)]
        port = copy.deepcopy(models[mode])
        dtypes = {"bn": [], "mlp": []}
        hooks = [m.register_forward_hook(
            lambda mod, args, o, key=key: dtypes[key].append(o.dtype))
            for key, kind in (("bn", BatchNorm), ("mlp", PointwiseMLP))
            for m in port.modules() if isinstance(m, kind)
            and (kind is BatchNorm or m.use_bn)]
        with torch.no_grad():
            o = port(*targs, *forward_args(family, batch, train, "torch"))
        for h in hooks:
            h.remove()
        res["port"] = [f32(x) for x in o]
        res["dtypes"] = dtypes
        out[mode] = res
    return out


def test_module_forward_matches_jax_bf16(forwards):
    """Eval mode at the initial statistics, where the JAX package holds its
    own bf16 forward to its float32 one: the JAX bars, stat_cls and
    pre_trans atol 2e-2."""
    family, res = forwards["family"], forwards["unit"]
    got, want = res["port"], res["bfloat16"]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape and np.isfinite(g).all()
    np.testing.assert_allclose(got[2], want[2], atol=FORWARD_BARS["trans"])
    if CLS[family] is not None:
        np.testing.assert_allclose(got[CLS[family]], want[CLS[family]],
                                   atol=FORWARD_BARS["cls"])


@pytest.mark.parametrize("mode", ["eval", "train"])
def test_module_forward_nearer_jax_bf16_than_float32(forwards, mode):
    """At the batch's statistics, in eval and in train mode, random weights
    carry bf16's rounding far through the trunk's max-pools and the masks:
    JAX's own bf16 forward lies up to 0.42 from its float32 one in
    pre_trans and 0.13 in stat_cls here (ROADMAP Queue 3), past the JAX
    bars.  The port's bf16 forward lies nearer JAX's bf16 than JAX's
    float32 does: the root mean square distance of each continuous output
    over JAX float32's, averaged over the outputs, below 1, and none above
    1.25."""
    family, res = forwards["family"], forwards[mode]
    ratios = [rms(res["port"][i], res["bfloat16"][i])
              / rms(res["float32"][i], res["bfloat16"][i])
              for i in CONTINUOUS[family]]
    assert np.mean(ratios) < 1.0 and max(ratios) <= 1.25, ratios
    for g in res["port"]:
        assert np.isfinite(g).all()


def test_batchnorm_emits_float32_in_train_mode(forwards):
    bn = forwards["train"]["dtypes"]["bn"]
    assert bn and all(d == torch.float32 for d in bn)


def test_prepool_boundary_float32_in_train_bf16_in_eval(forwards):
    train = forwards["train"]["dtypes"]["mlp"]
    evald = forwards["eval"]["dtypes"]["mlp"]
    assert train and all(d == torch.float32 for d in train)
    assert evald and all(d == BF16 for d in evald)

# ---------------------------------------------------------------------------
# the train steps
# ---------------------------------------------------------------------------

def jax_frame_losses(family: str, dtype: str, variables, frames):
    """The JAX package's ``_frame_loss`` over ``frames`` in turn, each from
    the BatchNorm statistics and the carry the last one left, at fixed
    parameters (a clip step at learning rate 0): each frame's items, the
    statistics after the last, and the last frame's gradients."""
    m = jax_model(family, dtype)
    model_name = family

    def loss(params, stats, frame, gfeat):
        return jsteps._frame_loss(model_name, m, params, stats, frame,
                                  jnp.asarray(P), jnp.asarray(TCR), 0.3,
                                  gfeat)

    fn = jax.jit(jax.value_and_grad(loss, has_aux=True))
    stats = variables["batch_stats"]
    gfeat = (jnp.zeros((2, C), jnp.float32) if family == "cmflow_t"
             else None)
    items = []
    for frame in frames:
        (_, (it, stats, gnew)), grads = fn(
            variables["params"], stats,
            {k: jnp.asarray(v) for k, v in frame.items()}, gfeat)
        items.append({k: float(v) for k, v in it.items()})
        gfeat = gnew
    return dict(items={k: float(np.mean([i[k] for i in items]))
                       for k in items[0]},
                stats=leaves(numpy_tree(stats)),
                grads=leaves(numpy_tree(grads)))


def frames_of(family: str):
    return [make_train_batch(s, 2, 64)
            for s in ((0, 1) if family == "cmflow_t" else (0,))]


def port_step(family: str, frames):
    """The port's bf16 step from the seeded weights: ``make_train_step``,
    or for CMFlow_T ``make_train_step_seq`` at learning rate 0 on the clip
    of its frames.  The gradients left are the last frame's."""
    model = port_model(family)
    before = export_flax_variables(model)
    if family == "cmflow_t":
        state = create_train_state(model, steps_per_epoch=1, lr=0.0)
        clip = {k: np.stack([f[k] for f in frames], axis=1)
                for k in frames[0]}
        items = steps.make_train_step_seq(model, P, TCR)(state, clip)
    else:
        state = create_train_state(model, steps_per_epoch=10)
        items = steps.make_train_step(family, model, P, TCR)(state,
                                                             frames[0])
    return dict(before=before, state=state,
                items={k: float(v) for k, v in items.items()},
                stats=leaves(export_flax_variables(model)["batch_stats"]),
                grads=leaves(export_flax_variables(model,
                                                   grads=True)["params"]))


def distances(got: dict, want: dict) -> dict:
    """The four numbers of ``TRAIN_BARS`` between two steps' results."""
    items = max(abs(got["items"][k] - w) / max(abs(w), 1e-12)
                for k, w in want["items"].items())
    stats = max(float(np.abs(got["stats"][k] - w).max())
                for k, w in want["stats"].items())
    gw, gg = want["grads"], got["grads"]
    leaf = np.median([float(np.linalg.norm(gg[k] - w) / np.linalg.norm(w))
                      for k, w in gw.items() if w.any()])
    whole = float(np.sqrt(sum(np.sum((gg[k] - w) ** 2) for k, w in gw.items())
                          / sum(np.sum(w ** 2) for w in gw.values())))
    return dict(items_rtol=items, stats_atol=stats,
                grad_leaf_l2_median=float(leaf), grad_l2=whole)


@pytest.fixture(scope="module", params=FAMILIES)
def train_steps(request):
    family = request.param
    frames = frames_of(family)
    port = port_step(family, frames)
    variables = jax.tree_util.tree_map(jnp.asarray, port["before"])
    return dict(family=family, port=port,
                jax=jax_frame_losses(family, "bfloat16", variables, frames))


def test_train_step_matches_jax_bf16(train_steps):
    family, port, want = (train_steps[k] for k in ("family", "port", "jax"))
    assert sorted(port["items"]) == sorted(LOSS_ITEMS[family])
    assert sorted(port["stats"]) == sorted(want["stats"])
    assert sorted(port["grads"]) == sorted(want["grads"])
    assert all(np.isfinite(g).all() for g in port["grads"].values())
    err = distances(port, want)
    bad = {k: (v, TRAIN_BARS[k]) for k, v in err.items()
           if not v <= TRAIN_BARS[k]}
    assert not bad, (family, bad)


def test_bf16_step_keeps_float32_state(train_steps):
    """Parameters, their gradients, Adam's moments and the BatchNorm
    statistics stay float32 after a bf16 step."""
    state = train_steps["port"]["state"]
    model = state.model
    assert model.dtype == BF16
    assert all(v.dtype == torch.float32
               for v in model.state_dict().values())
    assert all(p.grad.dtype == torch.float32 for p in model.parameters())
    moments = [v for s in state.optimizer.state.values() for k, v in s.items()
               if k != "step"]
    assert moments and all(v.dtype == torch.float32 for v in moments)
    # the same parameter tree as the float32 model's
    ref = build_model(train_steps["family"], "cpu", seed=MODEL_SEED)
    assert [(k, v.shape) for k, v in ref.state_dict().items()] == [
        (k, v.shape) for k, v in model.state_dict().items()]


# ---------------------------------------------------------------------------
# config, CLI and checkpoints
# ---------------------------------------------------------------------------

def test_config_builds_a_bf16_model():
    cfg = config.Config(compute_dtype="bfloat16", platform="cpu")
    model = loop._build_model(cfg, torch.device("cpu"))
    assert model.dtype == BF16
    assert loop._build_model(config.Config(platform="cpu"),
                             torch.device("cpu")).dtype is None
    with pytest.raises(ValueError, match="compute_dtype"):
        config.Config(compute_dtype="float16")
    with pytest.raises(ValueError, match="compute_dtype"):
        build_model("cmflow", "cpu", compute_dtype="float16")


def test_cli_trains_bf16_one_epoch(tmp_path, monkeypatch, capsys):
    tree = str(tmp_path / "tree")
    write_synthetic_dataset(tree, {"train": 4, "val": 2, "test": 2},
                            clips_per_partition=1, seed=1, n_range=(90, 130))
    cfg_path = tmp_path / "tiny.yaml"
    cfg_path.write_text("model: cmflow\nnum_points: 64\n"
                        "eval_pad_multiple: 64\ndata_parallel: false\n")
    models = []
    real = steps.make_train_step

    def spying(name, model, *a, **kw):
        models.append(model)
        return real(name, model, *a, **kw)

    monkeypatch.setattr(steps, "make_train_step", spying)
    assert climain.main([
        "--config", str(cfg_path), "--platform", "cpu", "--dataset_path",
        tree, "--checkpoints_dir", str(tmp_path / "ck"), "--num_workers",
        "0", "--eval_batch_size", "2", "--exp_name", "bf", "--epochs", "1",
        "--batch_size", "2", "--compute_dtype", "bfloat16"]) == 0
    assert [m.dtype for m in models] == [BF16]
    exp = tmp_path / "ck" / "bf"
    rows = [json.loads(line) for line in open(exp / "metrics.jsonl")]
    assert [r["phase"] for r in rows] == ["train", "val"]
    assert np.isfinite(rows[0]["Loss"]) and np.isfinite(rows[1]["rne"])
    assert os.path.isfile(exp / "models" / "last")
    assert capsys.readouterr().out.rstrip().endswith("FINISH")


def snapshot(state) -> dict:
    opt = state.optimizer.state_dict()
    return dict(model={k: v.clone() for k, v in
                       state.model.state_dict().items()},
                moments={(i, k): v.clone() for i, s in opt["state"].items()
                         for k, v in s.items()},
                step=state.step, lr=state.optimizer.param_groups[0]["lr"])


def assert_same_bits(a: dict, b: dict) -> None:
    assert a["step"] == b["step"] and a["lr"] == b["lr"]
    for part in ("model", "moments"):
        assert sorted(a[part]) == sorted(b[part])
        for k in a[part]:
            assert a[part][k].dtype == b[part][k].dtype, k
            assert torch.equal(a[part][k], b[part][k]), k


def test_bf16_checkpoint_round_trip_and_resume(tmp_path):
    def new_state(seed):
        model = build_model("cmflow", "cpu", seed=seed,
                            compute_dtype="bfloat16")
        return create_train_state(model, steps_per_epoch=2, lr=1e-3,
                                  decay_rate=0.5)

    batches = [make_train_batch(s, 2, 64) for s in range(3)]
    state = new_state(0)
    step = steps.make_train_step("cmflow", state.model, P, TCR)
    for batch in batches[:2]:
        step(state, batch)
    path = str(tmp_path / "last")
    loop.save_checkpoint(path, state)
    saved = snapshot(state)
    assert all(v.dtype == torch.float32 for v in saved["model"].values())
    step(state, batches[2])
    after = snapshot(state)

    restored = loop.restore_checkpoint(path, new_state(9))
    assert restored.model.dtype == BF16
    assert_same_bits(snapshot(restored), saved)
    steps.make_train_step("cmflow", restored.model, P, TCR)(restored,
                                                            batches[2])
    assert_same_bits(snapshot(restored), after)


# ---------------------------------------------------------------------------
# the distances of the train bars, printed
# ---------------------------------------------------------------------------

def main() -> None:
    """Print, for each family, how far JAX's bf16 step lies from JAX's
    float32 step (``JAX_BF16_FROM_F32``) and the port's bf16 step from
    JAX's bf16 step (held to ``TRAIN_BARS``)."""
    torch.set_num_threads(1)
    for family in FAMILIES:
        frames = frames_of(family)
        port = port_step(family, frames)
        variables = jax.tree_util.tree_map(jnp.asarray, port["before"])
        j16 = jax_frame_losses(family, "bfloat16", variables, frames)
        j32 = jax_frame_losses(family, "float32", variables, frames)
        print(json.dumps(dict(family=family,
                              jax_bf16_from_f32=distances(j16, j32),
                              port_from_jax_bf16=distances(port, j16),
                              port_from_jax_f32=distances(port, j32))),
              flush=True)


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    sys.exit(main())
