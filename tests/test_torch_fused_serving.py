"""Port parity: the fused CMFlow serving engine as a whole.

One JAX ``cmflow_infer(..., interpret=True)`` at B=2 on the padded 256
bucket (``synthetic.make_request(0, 2, (200, 256))``, valid masks on both
frames) is the reference.  The port's ``cmflow_infer``, on a model filled by
``load_flax_variables``, is held to it; ``make_eval_step(..., fused="on")``
is held to ``cmflow_infer``; and the port's fused route to its own module
route on the same weights.  On the CPU the kernels' plain versions run.

Bars are those of tests/test_torch_serving.py, compared on valid rows:
``stat_cls`` and ``sf_agg`` atol 1e-4, ``pre_trans`` atol 5e-4, motion masks
agreeing on at least 99% of the valid points.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import unfreeze

from cmflow_tpu.models import build_model as jax_build_model
from cmflow_tpu.models.inference import cmflow_infer as jax_cmflow_infer
from cmflow_tpu_torch.data import synthetic
from cmflow_tpu_torch.models import build_model
from cmflow_tpu_torch.models.convert import load_flax_variables
from cmflow_tpu_torch.models.inference import cmflow_infer, cmflow_infer_many
from cmflow_tpu_torch.ops import fused, neighbors
from cmflow_tpu_torch.train.steps import make_eval_step

BARS = {"flow": 1e-4, "cls": 1e-4, "trans": 5e-4, "agree": 0.99}
KEYS = ("pc1", "pc2", "ft1", "ft2", "valid1", "valid2")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def batch():
    return synthetic.make_request(0, 2, (200, 256))


@pytest.fixture(scope="module")
def engines(batch):
    """The JAX fused engine's outputs, and the port model on its weights."""
    model = jax_build_model("cmflow")
    args = [jnp.asarray(batch[k]) for k in KEYS]
    v = unfreeze(model.init({"params": jax.random.PRNGKey(0)}, *args[:4],
                            None, True))
    _, mut = model.apply(v, *args[:4], None, True, mutable=["batch_stats"])
    v["batch_stats"] = mut["batch_stats"]
    want = jax_cmflow_infer(v, *args, interpret=True)
    port = build_model("cmflow", device="cpu")
    load_flax_variables(port, jax.tree_util.tree_map(np.asarray, v))
    return [np.asarray(x) for x in want], port


def inputs(batch):
    return [torch.as_tensor(batch[k]) for k in KEYS]


def numpy(out):
    return [x.numpy() for x in out]


def assert_within_bars(got, want, valid):
    (sf, cls, trans, mask), (gsf, gcls, gtrans, gmask) = want, got
    assert gsf.shape == sf.shape and gmask.dtype == np.bool_
    np.testing.assert_allclose(gcls[valid], cls[valid], atol=BARS["cls"])
    np.testing.assert_allclose(gtrans, trans, atol=BARS["trans"])
    assert (gmask == mask)[valid].mean() >= BARS["agree"]
    same = (gmask == mask) & valid
    np.testing.assert_allclose(gsf[same], sf[same], atol=BARS["flow"])


def test_batch_is_padded(batch):
    assert batch["pc1"].shape == (2, 256, 3)
    assert not batch["valid1"].all() and not batch["valid2"].all()


def test_cmflow_infer_matches_jax_engine(batch, engines):
    want, port = engines
    got = numpy(cmflow_infer(port, *inputs(batch)))
    assert np.abs(want[0][batch["valid1"]]).max() > 1e-3  # not degenerate
    assert_within_bars(got, want, batch["valid1"])


def test_eval_step_on_is_cmflow_infer(batch, engines):
    _, port = engines
    step = make_eval_step("cmflow", port, fused="on")
    assert step.fused
    for a, b in zip(numpy(step(batch)), numpy(cmflow_infer(port,
                                                           *inputs(batch)))):
        np.testing.assert_array_equal(a, b)


def test_fused_route_matches_module_route(batch, engines):
    _, port = engines
    fused_out = numpy(make_eval_step("cmflow", port, fused="on")(batch))
    module_out = numpy(make_eval_step("cmflow", port, fused="off")(batch))
    assert_within_bars(fused_out, module_out, batch["valid1"])


def test_auto_picks_module_route_on_cpu(batch, engines):
    _, port = engines
    auto = make_eval_step("cmflow", port)
    assert not auto.fused and not make_eval_step("cmflow", port,
                                                 fused="off").fused
    counters = (neighbors.ball_query_multi, neighbors.knn, fused.gather_rows,
                fused.fused_multi_scale_encoder,
                fused.fused_point_local_feature, fused.cost_volume_p2p,
                fused.cost_volume_agg)
    before = [c.launches for c in counters]
    auto(batch)
    assert [c.launches for c in counters] == before  # CPU: plain versions
    with pytest.raises(ValueError, match="fused"):
        make_eval_step("cmflow", port, fused="yes")


def test_bf16_raises(batch, engines):
    """The engines serve float32 and bfloat16
    (tests/test_torch_bf16_serving.py); any other compute dtype raises."""
    _, port = engines
    with pytest.raises(ValueError, match="compute_dtype"):
        cmflow_infer(port, *inputs(batch), compute_dtype=torch.float16)
    with pytest.raises(ValueError, match="compute_dtype"):
        cmflow_infer_many(port, *(x[None] for x in inputs(batch)),
                          compute_dtype=torch.float16)


def test_infer_many_matches_per_batch(engines):
    _, port = engines
    reqs = [synthetic.make_request(s, 1, (120, 128)) for s in (3, 4)]
    stacked = [torch.stack([torch.as_tensor(r[k]) for r in reqs])
               for k in KEYS]
    many = numpy(cmflow_infer_many(port, *stacked))
    for i, r in enumerate(reqs):
        for a, b in zip(numpy(cmflow_infer(port, *inputs(r))), many):
            np.testing.assert_array_equal(a, b[i])
