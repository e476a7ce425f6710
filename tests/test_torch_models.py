"""Port parity: SE(3) geometry, the building blocks and the CMFlow eval
forward of ``cmflow_tpu_torch`` against the JAX package on the CPU.

The CMFlow forward runs at full width with weights made by a flax ``init``
plus one train-mode apply (so the BatchNorm statistics are real), carried
across by ``load_flax_variables``.  Bars are those the JAX package holds its
own engines to (scripts/parity_tpu.py, tests/test_fused.py): ``sf_agg`` and
``stat_cls`` atol 1e-4, ``pre_trans`` atol 5e-4, motion masks agreeing on at
least 99% of the valid points.  Kabsch parity is atol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import unfreeze

from cmflow_tpu.geometry import se3 as jse3
from cmflow_tpu.models import build_model as jax_build_model
from cmflow_tpu.nn import blocks as jblocks
from cmflow_tpu_torch.geometry import se3
from cmflow_tpu_torch.models import build_model
from cmflow_tpu_torch.models.convert import (
    export_flax_variables,
    load_flax_variables,
)
from cmflow_tpu_torch.nn import blocks

BARS = {"flow": 1e-4, "cls": 1e-4, "trans": 5e-4, "agree": 0.99}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def t(x):
    return None if x is None else torch.from_numpy(np.asarray(x))


def numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, unfreeze(tree))


def frame_pair(rs, b, n):
    pc1 = (rs.randn(b, n, 3) * 5).astype(np.float32)
    pc2 = pc1 + (rs.randn(b, n, 3) * 0.3).astype(np.float32)
    ft1 = rs.randn(b, n, 3).astype(np.float32)
    ft2 = rs.randn(b, n, 3).astype(np.float32)
    return pc1, pc2, ft1, ft2


# ---------------------------------------------------------------------------
# se3
# ---------------------------------------------------------------------------

def kabsch_inputs(rs, b=4, n=64):
    a = (rs.randn(b, n, 3) * 5).astype(np.float32)
    ang = rs.uniform(-0.3, 0.3, (b, 3))
    rot = []
    for x, y, z in ang:
        cx, sx, cy, sy, cz, sz = (np.cos(x), np.sin(x), np.cos(y), np.sin(y),
                                  np.cos(z), np.sin(z))
        rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
        ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
        rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
        rot.append(rz @ ry @ rx)
    rot = np.stack(rot)
    tr = rs.randn(b, 3)
    bb = (np.einsum("bij,bnj->bni", rot, a) + tr[:, None]
          + rs.randn(b, n, 3) * 0.05).astype(np.float32)
    w = rs.rand(b, n).astype(np.float32)
    return a, bb, w


# the (centroid, reflect, solver) triples the model families use, plus the
# remaining reflect modes
KABSCH_MODES = [
    ("sum", "row", "svd"),      # CMFlow / CMFlow_T ego-motion head
    ("mean_n", "row", "svd"),   # RaFlow SFR, 0/1 mask weights
    ("norm", "row", "svd"),
    ("norm", "col", "svd"),
    ("norm", "none", "svd"),
    ("sum", "row", "polar"),    # fused serving engines
    ("norm", "none", "polar"),
]


class TestSe3:
    @pytest.mark.parametrize("centroid,reflect,solver", KABSCH_MODES)
    def test_weighted_kabsch(self, centroid, reflect, solver):
        rs = np.random.RandomState(3)
        a, b, w = kabsch_inputs(rs)
        if centroid == "sum":
            w = w / w.sum(1, keepdims=True)
        if centroid == "mean_n":
            w = (w > 0.3).astype(np.float32)
        kw = dict(centroid=centroid, reflect=reflect, solver=solver)
        got = se3.weighted_kabsch(t(a), t(b), t(w), **kw)
        want = jse3.weighted_kabsch(jnp.asarray(a), jnp.asarray(b),
                                    jnp.asarray(w), **kw)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)

    def test_mean_n_with_n_override(self):
        rs = np.random.RandomState(4)
        a, b, w = kabsch_inputs(rs)
        w = (w > 0.5).astype(np.float32)
        n_real = np.array([64, 50, 40, 30], np.float32)
        got = se3.weighted_kabsch(t(a), t(b), t(w), centroid="mean_n",
                                  n_override=t(n_real))
        want = jse3.weighted_kabsch(jnp.asarray(a), jnp.asarray(b),
                                    jnp.asarray(w), centroid="mean_n",
                                    n_override=jnp.asarray(n_real))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)

    def test_reflection_and_singular_h(self):
        # a mirrored target forces det < 0; an all-zero weight row makes H
        # singular, where the polar value is rejected by its guard
        rs = np.random.RandomState(5)
        a, _, w = kabsch_inputs(rs)
        b = a * np.array([1.0, 1.0, -1.0], np.float32)
        w[1] = 0.0
        for reflect in ("row", "none"):
            got = se3.weighted_kabsch(t(a), t(b), t(w), reflect=reflect)
            want = jse3.weighted_kabsch(jnp.asarray(a), jnp.asarray(b),
                                        jnp.asarray(w), reflect=reflect)
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       atol=1e-5)

    def test_polar3_and_transforms(self):
        rs = np.random.RandomState(6)
        h = rs.randn(8, 3, 3).astype(np.float32)
        np.testing.assert_allclose(se3.polar3(t(h)).numpy(),
                                   np.asarray(jse3.polar3(jnp.asarray(h))),
                                   atol=1e-5)
        np.testing.assert_allclose(se3._cof3(t(h)).numpy(),
                                   np.asarray(jse3._cof3(jnp.asarray(h))),
                                   atol=1e-5)
        r = rs.randn(8, 3, 3).astype(np.float32)
        tr = rs.randn(8, 3).astype(np.float32)
        trans = se3.make_transform(t(r), t(tr))
        np.testing.assert_array_equal(
            trans.numpy(), np.asarray(jse3.make_transform(jnp.asarray(r),
                                                          jnp.asarray(tr))))
        pc = rs.randn(8, 32, 3).astype(np.float32)
        np.testing.assert_allclose(
            se3.rigid_to_flow(t(pc), trans).numpy(),
            np.asarray(jse3.rigid_to_flow(jnp.asarray(pc),
                                          jnp.asarray(trans.numpy()))),
            atol=1e-5)


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

class TestBlocks:
    def test_masked_global_max(self):
        rs = np.random.RandomState(8)
        f = rs.randn(2, 16, 5).astype(np.float32)
        valid = rs.rand(2, 16) > 0.5
        np.testing.assert_array_equal(
            blocks.masked_global_max(t(f), t(valid)).numpy(),
            np.asarray(jblocks.masked_global_max(jnp.asarray(f),
                                                 jnp.asarray(valid))))

    def test_weightnet(self):
        rs = np.random.RandomState(9)
        x = rs.randn(2, 16, 8, 3).astype(np.float32)
        mod = jblocks.WeightNet(32)
        v = numpy_tree(mod.init(jax.random.PRNGKey(1), jnp.asarray(x)))
        port = blocks.WeightNet(32)
        load_flax_variables(port, v)
        np.testing.assert_allclose(
            port(t(x)).detach().numpy(),
            np.asarray(mod.apply(v, jnp.asarray(x))), atol=1e-5)

    def test_pointwise_mlp_with_bn(self):
        rs = np.random.RandomState(10)
        x = rs.randn(2, 16, 8, 12).astype(np.float32)
        mod = jblocks.PointwiseMLP((16, 8))
        v = unfreeze(mod.init(jax.random.PRNGKey(2), jnp.asarray(x), False))
        _, mut = mod.apply(v, jnp.asarray(x), True, mutable=["batch_stats"])
        v["batch_stats"] = mut["batch_stats"]
        port = blocks.PointwiseMLP(12, (16, 8))
        load_flax_variables(port, numpy_tree(v))
        np.testing.assert_allclose(
            port(t(x), False).detach().numpy(),
            np.asarray(mod.apply(v, jnp.asarray(x), False)), atol=1e-5)


# ---------------------------------------------------------------------------
# CMFlow eval forward
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_cmflow():
    """Full-width flax CMFlow with real BN statistics (init + one train
    apply at B=2, N=128); the weights do not depend on N."""
    rs = np.random.RandomState(11)
    args = frame_pair(rs, 2, 128)
    model = jax_build_model("cmflow")
    v = unfreeze(model.init({"params": jax.random.PRNGKey(0)}, *args, None,
                            True))
    _, mut = model.apply(v, *args, None, True, mutable=["batch_stats"])
    v["batch_stats"] = mut["batch_stats"]
    return model, v


@pytest.fixture(scope="module")
def port_cmflow(jax_cmflow):
    model = build_model("cmflow", device="cpu", seed=1)
    load_flax_variables(model, numpy_tree(jax_cmflow[1]))
    return model


def padded_pair(rs, n, n1, n2):
    pc1, pc2, ft1, ft2 = frame_pair(rs, 1, n)
    valid1 = np.arange(n)[None] < n1
    valid2 = np.arange(n)[None] < n2
    for x, v in ((pc1, valid1), (ft1, valid1), (pc2, valid2), (ft2, valid2)):
        x[~v] = 0.0
    return (pc1, pc2, ft1, ft2), valid1, valid2


CASES = {
    "b2_n128": lambda rs: (frame_pair(rs, 2, 128), None, None),
    "b1_n256_padded": lambda rs: padded_pair(rs, 256, 201, 229),
}


class TestCMFlowForward:
    @pytest.mark.parametrize("case", sorted(CASES))
    def test_matches_flax(self, jax_cmflow, port_cmflow, case):
        args, valid1, valid2 = CASES[case](np.random.RandomState(12))
        model, v = jax_cmflow
        want = model.apply(v, *map(jnp.asarray, args), None, False,
                           None if valid1 is None else jnp.asarray(valid1),
                           None if valid2 is None else jnp.asarray(valid2))
        sf, cls, trans, mask = (np.asarray(x) for x in want)
        with torch.inference_mode():
            got = port_cmflow(*map(t, args), None, False, t(valid1), t(valid2))
        gsf, gcls, gtrans, gmask = (x.numpy() for x in got)

        assert np.abs(sf).max() > 1e-3  # not degenerate
        np.testing.assert_allclose(gcls, cls, atol=BARS["cls"])
        np.testing.assert_allclose(gtrans, trans, atol=BARS["trans"])
        valid = np.ones(mask.shape, bool) if valid1 is None else valid1
        agree = (gmask == mask)[valid].mean()
        assert agree >= BARS["agree"], agree
        same = gmask == mask
        np.testing.assert_allclose(gsf[same], sf[same], atol=BARS["flow"])

    def test_train_mode_matches_flax(self, jax_cmflow):
        """The train-mode forward (batch statistics, the pseudo label as the
        ego-motion scores) and the BatchNorm statistics it leaves."""
        rs = np.random.RandomState(13)
        args = frame_pair(rs, 2, 128)
        label_m = (rs.rand(2, 128) > 0.3).astype(np.float32)
        model, v = jax_cmflow
        want, mut = model.apply(v, *map(jnp.asarray, args),
                                jnp.asarray(label_m), True,
                                mutable=["batch_stats"])
        sf, cls, trans, mask = (np.asarray(x) for x in want)
        port = build_model("cmflow", device="cpu", seed=2)
        load_flax_variables(port, numpy_tree(v))
        with torch.no_grad():
            got = port(*map(t, args), t(label_m), True)
        gsf, gcls, gtrans, gmask = (x.numpy() for x in got)
        np.testing.assert_array_equal(gmask, label_m > 0.5)
        np.testing.assert_array_equal(gmask, mask)
        np.testing.assert_allclose(gcls, cls, atol=BARS["cls"])
        np.testing.assert_allclose(gtrans, trans, atol=BARS["trans"])
        np.testing.assert_allclose(gsf, sf, atol=BARS["flow"])
        stats = export_flax_variables(port)["batch_stats"]
        want_stats = numpy_tree(mut["batch_stats"])
        for path, a in jax.tree_util.tree_flatten_with_path(want_stats)[0]:
            got_leaf = stats
            for key in path:
                got_leaf = got_leaf[key.key]
            np.testing.assert_allclose(got_leaf, a, rtol=0, atol=1e-5,
                                       err_msg=jax.tree_util.keystr(path))

    def test_convert_rejects_unknown_and_missing_keys(self, jax_cmflow):
        v = numpy_tree(jax_cmflow[1])
        model = build_model("cmflow", device="cpu")
        bad = numpy_tree(jax_cmflow[1])
        bad["params"]["fp"]["extra"] = {"kernel": np.zeros((2, 2), np.float32)}
        with pytest.raises(KeyError, match="extra"):
            load_flax_variables(model, bad)
        partial = {"params": v["params"], "batch_stats": {}}
        with pytest.raises(KeyError, match="unfilled"):
            load_flax_variables(model, partial)

    def test_unported_models_raise(self):
        """All three families are ported; only an unknown name raises."""
        from cmflow_tpu_torch.models import MODEL_REGISTRY

        for name, cls in MODEL_REGISTRY.items():
            assert type(build_model(name, device="cpu")) is cls
        with pytest.raises(KeyError, match="unknown model"):
            build_model("flownet", device="cpu")
