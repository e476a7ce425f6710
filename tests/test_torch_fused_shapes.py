"""Port parity: the fused serving engines at backbone configurations whose
shapes the tuned CUDA kernels were not written for.

Two ``BackboneConfig``\\ s, each with seeded weights:

* ``A`` (K past the tuned kernels' old limits, default widths):
  ``sa_nsamples=(8, 16, 32, 64)``, ``fc_nsample=64``; on the card the
  tuned arms of K3, K4a, K4b and K5 at K=64.
* ``B`` (other widths): three radii, ``sa_nsamples=(16, 32, 64)``,
  ``sa_mlp=(64, 64, 128)``, ``sa_mlp2=(128, 128, 128)``, ``fc_nsample=16``:
  ``fc_inch`` 768 and ``ep_mlp`` (768, 384, 96); on the card the generic
  kernel (``csrc/chain.cu``) for K3, K4a, K4b and K5.

The weights are drawn with numpy into the JAX model's flax variable tree
(its shapes from ``jax.eval_shape``) and loaded into the port's model by
``models/convert.py::load_flax_variables``; the BatchNorm statistics move
halfway to those of one train-mode forward of the port, and the JAX engines
take the result through ``export_flax_variables``.  At B=2 on a padded
128-point bucket (JAX's kernels take N <= 128 or a multiple of 128), the
port's CMFlow, RaFlow and CMFlow_T engines on the CPU (every kernel's plain
version) are held to the JAX package's engines in interpret mode at the
float32 serving bars of tests/test_torch_fused_serving.py (``stat_cls``
and ``sf_agg`` atol 1e-4, ``pre_trans`` 5e-4, masks agreeing on >= 99% of
the valid points), and the port's bf16 CMFlow engine to JAX's bf16 engine
at the bars of tests/test_torch_bf16_serving.py (``stat_cls`` 3e-2,
``pre_trans`` 1e-2, masks >= 99%, ``sf_agg`` within 0.05 of max(|sf|,
1)).  Each wrapper's choice between its tuned kernel and the generic one
is a host function of the shapes alone, tested here at the shapes each
config gives it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmflow_tpu.models import cmflow as jcmflow
from cmflow_tpu.models import cmflow_t as jcmflow_t
from cmflow_tpu.models import inference as jinf
from cmflow_tpu.models import raflow as jraflow
from cmflow_tpu.models.backbone import BackboneConfig as JaxConfig
from cmflow_tpu_torch.data import schema, synthetic
from cmflow_tpu_torch.models import CMFlow, CMFlowT, RaFlow, inference
from cmflow_tpu_torch.models.backbone import BackboneConfig
from cmflow_tpu_torch.models.convert import (
    export_flax_variables,
    load_flax_variables,
)
from cmflow_tpu_torch.nn.blocks import BatchNorm
from cmflow_tpu_torch.ops import fused
from cmflow_tpu_torch.train.steps import make_eval_step

CONFIGS = {
    "A": dict(sa_nsamples=(8, 16, 32, 64), fc_nsample=64),
    "B": dict(sa_radii=(2.0, 4.0, 8.0), sa_nsamples=(16, 32, 64),
              sa_mlp=(64, 64, 128), sa_mlp2=(128, 128, 128), fc_nsample=16),
}
BARS = {"flow": 1e-4, "cls": 1e-4, "trans": 5e-4, "agree": 0.99}
BF16_BARS = {"cls": 3e-2, "trans": 1e-2, "agree": 0.99, "flow": 0.05}
KEYS = ("pc1", "pc2", "ft1", "ft2", "valid1", "valid2")
FAMILIES = {"cmflow": (jcmflow.CMFlow, CMFlow, jinf.cmflow_infer,
                       inference.cmflow_infer),
            "raflow": (jraflow.RaFlow, RaFlow, jinf.raflow_infer,
                       inference.raflow_infer),
            "cmflow_t": (jcmflow_t.CMFlowT, CMFlowT, jinf.cmflow_t_infer,
                         inference.cmflow_t_infer)}
# per family: the slots of the engines' outputs holding sf_agg, stat_cls
# (RaFlow has none), pre_trans and the mask
OUTPUTS = {"cmflow": (0, 1, 2, 3), "raflow": (1, None, 2, 3),
           "cmflow_t": (0, 1, 2, 3)}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def request_():
    """B=2 synthetic val frames of 90-127 points padded to a 128-point
    bucket, with an interval (RaFlow)."""
    rng = np.random.default_rng(5)
    samples = []
    for _ in range(2):
        n1, n2 = (int(x) for x in rng.integers(90, 128, size=2))
        s = synthetic.decode_sample(synthetic.make_scene(rng, n1=n1, n2=n2),
                                    "val", eval_mode=True, num_points=256)
        samples.append(schema.pad_to(s, 128))
    req = schema.collate(samples)
    req["interval"] = np.full((2,), 0.1, np.float32)
    return req


def numpy_variables(shapes, seed: int) -> dict:
    """A flax variable tree of ``shapes`` (``jax.eval_shape`` of ``init``)
    drawn with numpy: Dense kernels N(0, 1/fan_in), biases and BatchNorm
    shifts U(-0.1, 0.1), BatchNorm scales U(0.8, 1.2), running means
    U(-0.1, 0.1) and variances U(0.5, 2)."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = path[-1].key
        if name == "kernel" or name == "w0":
            return (rng.standard_normal(leaf.shape)
                    / np.sqrt(leaf.shape[0])).astype(np.float32)
        lo, hi = {"scale": (0.8, 1.2), "var": (0.5, 2.0)}.get(
            name, (-0.1, 0.1))
        return rng.uniform(lo, hi, leaf.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def blend_batchnorm(model, name, req, extra) -> None:
    """Move ``model``'s BatchNorm statistics halfway to those of one
    train-mode forward on ``req`` (flows of ~0.1 m rather than the
    hundreds of metres that the drawn statistics give), then eval mode."""
    bns = [m for m in model.modules() if isinstance(m, BatchNorm)]
    for bn in bns:
        bn.MOMENTUM = 0.5
    x = port_inputs(req)
    extra = [torch.as_tensor(e) for e in extra]
    with torch.no_grad():
        model(*x[:4], *train_args(name, extra), *x[4:])
    for bn in bns:
        del bn.MOMENTUM
    model.eval()


def train_args(name, extra):
    """A family's forward arguments between the features and the masks:
    RaFlow's interval, CMFlow's and CMFlow_T's (absent) labels, ``train``,
    CMFlow_T's carry."""
    if name == "raflow":
        return (extra[0], True)
    return (None, True, *extra)


def family_args(name, req, cfg):
    """The engines' inputs after ``(pc1, pc2, ft1, ft2)`` and before the
    masks: RaFlow's interval, CMFlow_T's GRU carry."""
    if name == "raflow":
        return (req["interval"],)
    if name == "cmflow_t":
        return (np.tanh(np.random.default_rng(6).standard_normal(
            (2, cfg.prop_width))).astype(np.float32),)
    return ()


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def engines(request, request_):
    """Per config and family: the port model on the numpy weights, its
    inputs, and the JAX engine's outputs (float32; CMFlow also bf16)."""
    cfg_name = request.param
    jcfg, pcfg = JaxConfig(**CONFIGS[cfg_name]), BackboneConfig(
        **CONFIGS[cfg_name])
    req = request_
    x = [jnp.asarray(req[k]) for k in KEYS]
    out = {}
    for seed, (name, (jcls, pcls, jengine, _)) in enumerate(FAMILIES.items()):
        extra = family_args(name, req, pcfg)
        jx = [jnp.asarray(e) for e in extra]
        jmodel = jcls(cfg=jcfg)
        shapes = jax.eval_shape(
            lambda: jmodel.init({"params": jax.random.PRNGKey(0)}, *x[:4],
                                *train_args(name, jx)))
        port = pcls(cfg=pcfg)
        load_flax_variables(port, numpy_variables(shapes, 40 + seed))
        blend_batchnorm(port, name, req, extra)
        jv = jax.tree_util.tree_map(jnp.asarray, export_flax_variables(port))
        want = {dt: [np.asarray(o) for o in jengine(
            jv, *x[:4], *jx, *x[4:], cfg=jcfg, interpret=True,
            compute_dtype=dt)]
            for dt in ((jnp.float32, jnp.bfloat16) if name == "cmflow"
                       else (jnp.float32,))}
        out[name] = dict(model=port, extra=[torch.as_tensor(e)
                                            for e in extra], want=want)
    return cfg_name, pcfg, req, out


def port_inputs(req):
    return [torch.as_tensor(req[k]) for k in KEYS]


def run_port(name, e, req, dtype=torch.float32):
    x = port_inputs(req)
    got = FAMILIES[name][3](e["model"], *x[:4], *e["extra"], *x[4:],
                            compute_dtype=dtype)
    return [o.numpy() for o in got]


def assert_f32_bars(name, got, want, valid):
    i_sf, i_cls, i_trans, i_mask = OUTPUTS[name]
    assert np.abs(want[i_sf][valid]).max() > 1e-3  # not degenerate
    if i_cls is not None:
        np.testing.assert_allclose(got[i_cls][valid], want[i_cls][valid],
                                   atol=BARS["cls"])
    np.testing.assert_allclose(got[i_trans], want[i_trans],
                               atol=BARS["trans"])
    agree = got[i_mask] == want[i_mask]
    assert agree[valid].mean() >= BARS["agree"]
    same = agree & valid
    np.testing.assert_allclose(got[i_sf][same], want[i_sf][same],
                               atol=BARS["flow"])
    if name == "cmflow_t":  # the new GRU carry
        np.testing.assert_allclose(got[4], want[4], atol=BARS["cls"])


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_engine_matches_jax(engines, name):
    _, _, req, out = engines
    e = out[name]
    assert_f32_bars(name, run_port(name, e, req), e["want"][jnp.float32],
                    req["valid1"])


def test_eval_step_on_is_the_engine(engines):
    """``make_eval_step(..., fused="on")`` serves these configs through the
    fused engine (on the CPU, the plain versions) with its outputs."""
    _, _, req, out = engines
    model = out["cmflow"]["model"]
    step = make_eval_step("cmflow", model, fused="on")
    assert step.fused
    for a, b in zip(step(req), run_port("cmflow", out["cmflow"], req)):
        np.testing.assert_array_equal(a.numpy(), b)


def test_engine_bf16_matches_jax_bf16(engines):
    _, _, req, out = engines
    e = out["cmflow"]
    got = run_port("cmflow", e, req, torch.bfloat16)
    want = e["want"][jnp.bfloat16]
    valid = req["valid1"]
    assert np.abs(got[1] - want[1])[valid].max() <= BF16_BARS["cls"]
    assert np.abs(got[2] - want[2]).max() <= BF16_BARS["trans"]
    assert (got[3] == want[3])[valid].mean() >= BF16_BARS["agree"]
    sf, jsf = got[0][valid], want[0][valid]
    assert np.abs(sf - jsf).max() < BF16_BARS["flow"] * max(
        np.abs(jsf).max(), 1.0)


def test_arm_choice(engines):
    """Each wrapper's arm at the shapes the config gives it, by shape
    alone: config A keeps every tuned kernel (at K=64), config B takes the
    generic kernel in all four."""
    cfg_name, cfg, req, out = engines
    trunk = out["cmflow"]["model"].trunk
    packed, _ = fused.mse_narrow_params_from_variables(trunk.mse_layer)
    w1, w2 = packed[4], packed[7]
    chain, _, _ = fused.plf_params_from_variables(trunk.mse_layer2.scale_0)
    dense = fused.cv_params_from_variables(trunk.fc_layer)[0]
    arms = (fused.mse_arm((w1.shape[1], w1.shape[2], w2.shape[2]),
                          len(cfg.sa_radii), 3),
            fused.plf_arm((chain[0].shape[1],)
                          + tuple(w.shape[1] for w in chain[3::3])),
            fused.cv_p2p_arm((dense[0].shape[1], dense[2].shape[1],
                              dense[4].shape[1])),
            fused.cv_agg_arm(dense[4].shape[1]))
    want = fused.TUNED if cfg_name == "A" else fused.GENERIC
    assert arms == (want,) * 4


@pytest.mark.parametrize("case", [
    ("mse", ((32, 32, 64), 4, 3), fused.TUNED),
    ("mse", ((32, 32, 64), 8, 5), fused.TUNED),
    ("mse", ((32, 32, 64), 9, 3), fused.GENERIC),
    ("mse", ((32, 32, 64), 4, 6), fused.GENERIC),
    ("mse", ((24, 40, 56), 4, 3), fused.GENERIC),
    ("plf", ((512, 256, 64),), fused.TUNED),
    ("plf", ((512, 256),), fused.GENERIC),
    ("plf", ((512, 256, 64, 64),), fused.GENERIC),
    ("plf", ((768, 384, 96),), fused.GENERIC),
    ("cv", ((512, 512, 512),), fused.TUNED),
    ("cv", ((512, 512, 256),), fused.GENERIC),
    ("cv", ((100, 100, 100),), fused.GENERIC),
    ("agg", (512,), fused.TUNED),
    ("agg", (511,), fused.GENERIC),
])
def test_arm_choice_by_shape(case):
    """The host functions that pick an arm, at the edges of what the tuned
    kernels take: K3's widths, scales (8) and features (5), K5's chain, K4a's
    three widths, K4b's width."""
    kind, args, want = case
    fn = {"mse": fused.mse_arm, "plf": fused.plf_arm,
          "cv": fused.cv_p2p_arm, "agg": fused.cv_agg_arm}[kind]
    assert fn(*args) == want


def test_narrow_path_needs_three_layers():
    """The narrow (K3) path packs a 3-layer sa mlp, as the JAX package's
    does; any other depth raises, in the port as in JAX."""
    from cmflow_tpu_torch.nn import blocks

    mse = blocks.MultiScaleEncoder((2.0, 4.0), (4, 8), 3, (32, 64),
                                   (64, 64, 64))
    with pytest.raises(ValueError, match="3-layer"):
        fused.mse_narrow_params_from_variables(mse)
