"""Port parity: farthest-point sampling, the rest of the point ops and the
PointNet++ modules (``cmflow_tpu_torch.ops.pointops``,
``cmflow_tpu_torch.nn.extras``) against the JAX package on the CPU.

On CPU tensors the port's wrappers run their kernels' plain versions: FPS a
loop over the samples with each squared distance as ((dx*dx + dy*dy) +
dz*dz), held bit for bit to the JAX package's ``lax.fori_loop``; the ball
query, kNN and the gather to JAX's XLA references.

Bars.  Indices and gathered rows: bit-identical.  ``three_nn``'s distances,
``interpolation_weights`` and ``three_interpolate``: atol 1e-6 (a square
root and a three-term sum in another order).  The modules, on JAX's
``init`` variables: outputs atol 1e-4, BatchNorm statistics atol 1e-5,
gradients at the train step's bars (relative L2 3e-2 a leaf, 1e-2 the
whole gradient; a max over neighbours makes single entries jump with
float32 rounding, tests/test_torch_train.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import unfreeze

from cmflow_tpu import ops as jops
from cmflow_tpu.nn import extras as jextras
from cmflow_tpu.ops import pointops as jpo
from cmflow_tpu_torch import ops
from cmflow_tpu_torch.models.convert import (
    export_flax_variables,
    load_flax_variables,
)
from cmflow_tpu_torch.nn import extras
from cmflow_tpu_torch.ops import pointops, sampling


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def t(x):
    return torch.from_numpy(np.array(x))


def numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, unfreeze(tree))


def leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(a)
            for p, a in jax.tree_util.tree_flatten_with_path(tree)[0]}


def assert_grads_close(got, want):
    got, want = leaves(got), leaves(want)
    assert sorted(got) == sorted(want)
    rel = {k: float(np.linalg.norm(got[k] - want[k])
                    / max(np.linalg.norm(want[k]), 1e-30)) for k in want}
    bad = {k: v for k, v in rel.items() if not v <= 3e-2}
    assert not bad, bad
    whole = np.sqrt(sum(np.sum((got[k] - want[k]) ** 2) for k in want)
                    / sum(np.sum(want[k] ** 2) for k in want))
    assert whole <= 1e-2, whole


def unit_sphere(rs, b, n):
    x = rs.randn(b, n, 3)
    return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)


# --------------------------------------------------------------------------
# ops

def test_exports_match_jax():
    assert sorted(ops.__all__) == sorted(jops.__all__)
    for name in ops.__all__:
        assert callable(getattr(ops, name))


@pytest.mark.parametrize("n", [50, 1024])
@pytest.mark.parametrize("npoint", [8, 128])
def test_farthest_point_sample_matches_jax(n, npoint):
    rs = np.random.RandomState(n + npoint)
    xyz = (rs.rand(2, n, 3) * 10).astype(np.float32)
    want = np.asarray(jpo.farthest_point_sample(jnp.asarray(xyz), npoint))
    got = ops.farthest_point_sample(t(xyz), npoint)
    assert got.dtype == torch.int32 and got.shape == (2, npoint)
    np.testing.assert_array_equal(got.numpy(), want)
    if npoint <= n:  # every sample a distinct point
        assert all(len(set(row)) == npoint for row in want.tolist())


def test_farthest_point_sample_ties_and_duplicates():
    """Duplicated points and equal distances: ties go to the lowest index,
    as jnp.argmax breaks them."""
    xyz = np.zeros((1, 12, 3), np.float32)
    xyz[0, 3:6] = [1.0, 0.0, 0.0]  # three copies at distance 1 of index 0
    xyz[0, 8:12] = [-1.0, 0.0, 0.0]  # four more at the same distance
    want = np.asarray(jpo.farthest_point_sample(jnp.asarray(xyz), 6))
    got = ops.farthest_point_sample(t(xyz), 6)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[0, 1] == 3


# N from one point up past a warp's 32 lanes and past the card kernel's
# register capacity of a 4-warp block (1,024), npoint past N (index 0
# repeats), on clouds with duplicated points
@pytest.mark.parametrize("n,npoint", [(1, 3), (31, 33), (300, 302),
                                      (2049, 96)])
def test_farthest_point_sample_any_n_matches_jax(n, npoint):
    rs = np.random.RandomState(n)
    xyz = unit_sphere(rs, 2, n)
    if n > 8:
        xyz[:, n // 2:n // 2 + 4] = xyz[:, 1:5]  # exact ties
    want = np.asarray(jpo.farthest_point_sample(jnp.asarray(xyz), npoint))
    got = ops.farthest_point_sample(t(xyz), npoint)
    np.testing.assert_array_equal(got.numpy(), want)
    if npoint > n:
        assert (want[:, n:] == 0).all()


def test_farthest_point_sample_rejects():
    with pytest.raises(ValueError):
        ops.farthest_point_sample(torch.zeros(2, 5, 2), 3)
    with pytest.raises(TypeError):
        ops.farthest_point_sample(torch.zeros(2, 5, 3, dtype=torch.float64), 3)
    with pytest.raises(ValueError):
        ops.farthest_point_sample(torch.zeros(2, 5, 3), 0)
    assert sampling.farthest_point_sample.launches == 0  # CPU: no kernel


@pytest.mark.parametrize("with_features", [False, True])
def test_query_and_group_and_gather_points(with_features):
    rs = np.random.RandomState(3)
    xyz = unit_sphere(rs, 2, 96)
    new_xyz = xyz[:, :24]
    feats = rs.randn(2, 96, 5).astype(np.float32) if with_features else None
    want = np.asarray(jpo.query_and_group(
        0.4, 12, jnp.asarray(xyz), jnp.asarray(new_xyz),
        None if feats is None else jnp.asarray(feats)))
    got = ops.query_and_group(0.4, 12, t(xyz), t(new_xyz),
                              None if feats is None else t(feats))
    assert got.shape == want.shape == (2, 24, 12, 3 + (5 if feats is not None
                                                       else 0))
    np.testing.assert_array_equal(got.numpy(), want)

    idx = rs.randint(0, 96, (2, 40)).astype(np.int32)
    np.testing.assert_array_equal(
        ops.gather_points(t(xyz), t(idx)).numpy(),
        np.asarray(jpo.gather_points(jnp.asarray(xyz), jnp.asarray(idx))))


def test_large_k_and_nsample_match_jax():
    """``knn_with_dists`` past k = 64 and ``query_and_group`` past 64
    samples a ball, bit for bit."""
    rs = np.random.RandomState(5)
    xyz = unit_sphere(rs, 2, 160)
    xyz[:, 100:120] = xyz[:, 10:30]  # exact ties
    q = xyz[:, :40]
    d, idx = ops.knn_with_dists(100, t(q), t(xyz))
    jd, jidx = jpo.knn_with_dists(100, jnp.asarray(q), jnp.asarray(xyz))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
    got = ops.query_and_group(1.0, 80, t(xyz), t(q))
    want = jpo.query_and_group(1.0, 80, jnp.asarray(xyz), jnp.asarray(q))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_sqrt_rn_is_correctly_rounded():
    """``sqrt_rn`` equals numpy's (correctly rounded) float32 square root
    bit for bit: every seventh float32 of two binades (an even and an odd
    exponent), small magnitudes, zero, a subnormal, the largest float."""
    x = np.concatenate([
        np.arange(2 ** 23, 2 ** 25, dtype=np.uint32).view(np.float32)[::7],
        np.random.RandomState(5).rand(100_000).astype(np.float32) * 1e-30,
        np.array([0.0, 1e-45, 1.0, 4.0, 3.4028235e38], np.float32)])
    np.testing.assert_array_equal(pointops.sqrt_rn(t(x)).numpy(), np.sqrt(x))


@pytest.mark.parametrize("masked", [False, True])
def test_three_nn_weights_and_interpolate(masked):
    rs = np.random.RandomState(4)
    query = (rs.rand(2, 64, 3) * 4).astype(np.float32)
    points = (rs.rand(2, 20, 3) * 4).astype(np.float32)
    valid = (rs.rand(2, 20) > 0.3) if masked else None
    jd, jidx = jpo.three_nn(jnp.asarray(query), jnp.asarray(points),
                            None if valid is None else jnp.asarray(valid))
    d, idx = ops.three_nn(t(query), t(points),
                          None if valid is None else t(valid))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    # the same squared distances and both square roots correctly rounded
    np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
    # the squared distances are the ones knn_with_dists sorts, bit for bit
    d2, kidx = pointops.knn_with_dists(3, t(query), t(points),
                                       None if valid is None else t(valid))
    np.testing.assert_array_equal(kidx.numpy(), idx.numpy())
    np.testing.assert_array_equal(
        pointops.sqrt_rn(torch.clamp_min(d2, 0.0)).numpy(), d.numpy())

    w = ops.interpolation_weights(d)
    jw = jpo.interpolation_weights(jd)
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=0, atol=1e-6)
    feats = rs.randn(2, 20, 7).astype(np.float32)
    got = ops.three_interpolate(t(feats), idx, w)
    want = jpo.three_interpolate(jnp.asarray(feats), jidx, jw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)


# --------------------------------------------------------------------------
# modules

SA_CASES = {
    # name: (npoint, radius, nsample, mlp, use_xyz, feature channels)
    "npoint": (24, 0.5, 16, (16, 32), True, 4),
    "npoint_no_features": (24, 0.5, 16, (16, 32), True, 0),
    "group_all": (None, None, None, (16, 32), True, 4),
    "no_xyz": (24, 0.5, 16, (16, 32), False, 4),
}


def run_module(jmod, port, args, r):
    """JAX and the port on the same inputs from JAX's ``init`` variables:
    (eval outputs, train outputs, BatchNorm statistics after the train
    forward, gradients of sum(out * r)) for each side."""
    jargs = [None if a is None else jnp.asarray(a) for a in args]
    v = numpy_tree(jmod.init(jax.random.PRNGKey(5), *jargs, True))
    load_flax_variables(port, v)
    targs = [None if a is None else t(a) for a in args]

    want_eval = jmod.apply(v, *jargs, False)

    def f(params):
        out, mut = jmod.apply({"params": params,
                               "batch_stats": v["batch_stats"]}, *jargs, True,
                              mutable=["batch_stats"])
        feats = out[1] if isinstance(out, tuple) else out
        return jnp.sum(feats * r), (out, mut)

    (_, (want_train, mut)), g = jax.value_and_grad(f, has_aux=True)(
        v["params"])
    with torch.no_grad():
        got_eval = port(*targs, False)
    got_train = port(*targs, True)
    feats = got_train[1] if isinstance(got_train, tuple) else got_train
    (feats * t(r)).sum().backward()
    return dict(
        eval=(got_eval, want_eval), train=(got_train, want_train),
        stats=(export_flax_variables(port)["batch_stats"],
               numpy_tree(mut["batch_stats"])),
        grads=(export_flax_variables(port, grads=True)["params"],
               numpy_tree(g)))


def assert_module_parity(res):
    for key in ("eval", "train"):
        got, want = res[key]
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        for a, b in zip(got, want):
            assert a.shape == b.shape
            np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                       rtol=0, atol=1e-4, err_msg=key)
    got, want = (leaves(x) for x in res["stats"])
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-5,
                                   err_msg=k)
    assert_grads_close(*res["grads"])


@pytest.mark.parametrize("case", sorted(SA_CASES))
def test_set_abstraction(case):
    npoint, radius, nsample, mlp, use_xyz, c = SA_CASES[case]
    rs = np.random.RandomState(11)
    xyz = unit_sphere(rs, 2, 128)
    feats = rs.randn(2, 128, c).astype(np.float32) if c else None
    jmod = jextras.SetAbstraction(npoint, radius, nsample, mlp,
                                  use_xyz=use_xyz)
    port = extras.SetAbstraction(npoint, radius, nsample, c, mlp,
                                 use_xyz=use_xyz)
    s = 1 if npoint is None else npoint
    r = rs.randn(2, s, mlp[-1]).astype(np.float32)
    res = run_module(jmod, port, (xyz, feats), r)
    new_xyz, want_xyz = res["train"][0][0], res["train"][1][0]
    np.testing.assert_array_equal(new_xyz.numpy(), np.asarray(want_xyz))
    assert res["train"][0][1].shape == (2, s, mlp[-1])
    assert_module_parity(res)


@pytest.mark.parametrize("skip", [False, True])
def test_feature_propagation(skip):
    rs = np.random.RandomState(12)
    unknown = unit_sphere(rs, 2, 64)
    known = unknown[:, ::4].copy()
    known_feats = rs.randn(2, 16, 8).astype(np.float32)
    unknown_feats = rs.randn(2, 64, 4).astype(np.float32) if skip else None
    jmod = jextras.FeaturePropagation((32, 16))
    port = extras.FeaturePropagation(8 + (4 if skip else 0), (32, 16))
    r = rs.randn(2, 64, 16).astype(np.float32)
    res = run_module(jmod, port, (unknown, known, unknown_feats, known_feats),
                     r)
    assert res["train"][0].shape == (2, 64, 16)
    assert_module_parity(res)


def test_module_widths_checked():
    with pytest.raises(ValueError):
        extras.SetAbstraction(None, None, None, 0, (8,), use_xyz=False)
    sa = extras.SetAbstraction(8, 0.5, 4, 3, (8,))
    with pytest.raises(ValueError, match="channels"):
        sa(torch.zeros(1, 16, 3), torch.zeros(1, 16, 5))
