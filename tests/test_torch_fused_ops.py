"""Port parity: the fused serving kernels and their parameter packers
(``cmflow_tpu_torch.ops.fused``, ``models/inference.py`` helpers) against the
JAX package on the CPU.

On CPU tensors the port's wrappers run their kernels' plain versions.  They
are held to the Pallas kernels in interpret mode (``_mse_kernel``,
``_plf_kernel``, ``_cv_kernel`` + ``_cv_agg_kernel``) on the same inputs,
made from a numpy seed, with weights from a flax ``init`` plus one train
apply (real BatchNorm statistics) carried across by ``load_flax_variables``.

Tolerance rtol 1e-4, atol 1e-4: the JAX kernels gather through a hi/lo bf16
split, exact to about 2^-16 relative (``cmflow_tpu/ops/fused.py:511-516``),
where the port gathers exactly, and both sides sum their float32 products
in different orders.  The packers agree to float32 rounding (rtol 1e-6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import unfreeze
from jax.scipy.linalg import block_diag

from cmflow_tpu.models import inference as jinf
from cmflow_tpu.nn import blocks as jblocks
from cmflow_tpu.ops import fused as jfused
from cmflow_tpu.ops import pointops as jpo
from cmflow_tpu_torch.models import inference
from cmflow_tpu_torch.models.convert import load_flax_variables
from cmflow_tpu_torch.nn import blocks
from cmflow_tpu_torch.ops import fused

TOL = dict(rtol=1e-4, atol=1e-4)
PACK_TOL = dict(rtol=1e-6, atol=1e-7)
RADII = (2.0, 4.0, 8.0, 16.0)
KS = (4, 8, 16, 32)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def t(x):
    return None if x is None else torch.from_numpy(np.array(x))


def j(x):
    return None if x is None else jnp.asarray(x)


def close(got, want, **tol):
    got, want = (x.detach().numpy() if isinstance(x, torch.Tensor) else
                 np.asarray(x) for x in (got, want))
    np.testing.assert_allclose(got, want, **(tol or TOL))


def flax_vars(module, *args):
    """``init`` plus one train-mode apply, so BatchNorm statistics are
    real; returned as numpy trees."""
    v = unfreeze(module.init({"params": jax.random.PRNGKey(0)}, *args))
    _, mut = module.apply(v, *args, mutable=["batch_stats"])
    if "batch_stats" in mut:
        v["batch_stats"] = mut["batch_stats"]
    return jax.tree_util.tree_map(np.asarray, v)


def cloud(rs, b, n, scale=5.0):
    return (rs.randn(b, n, 3) * scale).astype(np.float32)


def valid_mask(rs, b, n):
    """Random holes plus an all-invalid tail, as padding gives."""
    real = np.array([n - n // 4 - 3 * i for i in range(b)])
    return (rs.rand(b, n) > 0.1) & (np.arange(n)[None, :] < real[:, None])


# ---------------------------------------------------------------------------
# K3: the sa encoder (narrow MultiScaleEncoder)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def sa_encoder():
    """The sa encoder at its real widths (mlp 32,32,64, mlp2 64,64,64),
    B=1, N=128, with a padding mask; flax and port with the same weights."""
    rs = np.random.RandomState(31)
    xyz, feats = cloud(rs, 1, 128), rs.randn(1, 128, 3).astype(np.float32)
    valid = valid_mask(rs, 1, 128)
    mod = jblocks.MultiScaleEncoder(RADII, KS, (32, 32, 64), (64, 64, 64))
    v = flax_vars(mod, j(xyz), j(feats), True, j(valid))
    port = blocks.MultiScaleEncoder(RADII, KS, 3, (32, 32, 64), (64, 64, 64))
    load_flax_variables(port, v)
    idx = [jpo.ball_query(r, k, j(xyz), j(xyz), j(valid))
           for r, k in zip(RADII, KS)]
    return dict(xyz=xyz, feats=feats, valid=valid, mod=mod, v=v, port=port,
                idx=idx)


def test_mse_kernel_matches_pallas(sa_encoder):
    e = sa_encoder
    packed, _ = jfused.mse_narrow_params_from_variables(
        e["v"]["params"], e["v"]["batch_stats"], len(RADII))
    want = jfused.fused_multi_scale_encoder(
        j(e["feats"]), e["idx"], j(e["xyz"]), packed, KS, True, 64)
    ppacked, _ = fused.mse_narrow_params_from_variables(e["port"])
    before = fused.fused_multi_scale_encoder.launches
    got = fused.fused_multi_scale_encoder(
        t(e["feats"]), [t(i) for i in e["idx"]], t(e["xyz"]), ppacked)
    assert fused.fused_multi_scale_encoder.launches == before  # CPU: plain
    assert got.shape == (1, 128, 256) and np.abs(np.asarray(want)).max() > 0.1
    close(got, want)


def test_mse_packer_matches_jax(sa_encoder):
    e = sa_encoder
    packed, mlp2 = jfused.mse_narrow_params_from_variables(
        e["v"]["params"], e["v"]["batch_stats"], len(RADII))
    ppacked, pmlp2 = fused.mse_narrow_params_from_variables(e["port"])
    for a, b in zip(ppacked[0] + ppacked[1], packed[0] + packed[1]):
        close(a, b, rtol=0, atol=0)  # raw first-layer blocks
    for slot in (2, 3, 5, 6, 8, 9):  # folded affines
        close(ppacked[slot], packed[slot], **PACK_TOL)
    for slot in (4, 7):  # stacked per scale here, block-diagonal in JAX
        close(block_diag(*ppacked[slot].detach().numpy()), packed[slot],
              rtol=0, atol=0)
    assert len(pmlp2) == len(mlp2)
    for got, want in zip(pmlp2, mlp2):
        for a, b in zip(got, want):
            close(a, b, **PACK_TOL)


def test_mse_fused_matches_jax_and_module(sa_encoder):
    """The narrow branch of ``_mse_fused`` (K3 plus the block-diagonal mlp2
    tail) against the JAX engine's and against the port's module route."""
    e = sa_encoder
    want = jinf._mse_fused(e["v"]["params"], e["v"]["batch_stats"], RADII,
                           KS, j(e["xyz"]), j(e["feats"]), j(e["valid"]),
                           True)
    got = inference._mse_fused(e["port"], t(e["xyz"]), t(e["feats"]),
                               t(e["valid"]))
    close(got, want)
    with torch.no_grad():
        ref = e["port"](t(e["xyz"]), t(e["feats"]), False, t(e["valid"]))
    close(got, ref.numpy())


# ---------------------------------------------------------------------------
# K5: one propagation-encoder scale (PointLocalFeature)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def plf_scale():
    """A PointLocalFeature at narrow widths (C1=64, mlp 64,32,32, K=16), as
    tests/test_fused.py:31-50 runs the Pallas kernel, with a padding mask."""
    rs = np.random.RandomState(32)
    xyz, feats = cloud(rs, 2, 128), rs.randn(2, 128, 35).astype(np.float32)
    valid = valid_mask(rs, 2, 128)
    mod = jblocks.PointLocalFeature(radius=4.0, nsample=16, mlp=(64, 32, 32),
                                    mlp2=(32, 32, 32))
    v = flax_vars(mod, j(xyz), j(feats), True, j(valid))
    port = blocks.PointLocalFeature(4.0, 16, 35, (64, 32, 32), (32, 32, 32))
    load_flax_variables(port, v)
    idx = jpo.ball_query(4.0, 16, j(xyz), j(xyz), j(valid))
    return dict(xyz=xyz, feats=feats, valid=valid, mod=mod, v=v, port=port,
                idx=idx)


def test_plf_kernel_matches_pallas(plf_scale):
    e = plf_scale
    chain, feat_w, _ = jfused.plf_params_from_variables(
        e["v"]["params"], e["v"]["batch_stats"])
    feat_tx = j(e["feats"]) @ feat_w
    want = jfused.fused_point_local_feature(feat_tx, e["idx"], j(e["xyz"]),
                                            chain, True)
    pchain, pfeat_w, _ = fused.plf_params_from_variables(e["port"])
    before = fused.fused_point_local_feature.launches
    got = fused.fused_point_local_feature(t(e["feats"]) @ pfeat_w,
                                          t(e["idx"]), t(e["xyz"]), pchain)
    assert fused.fused_point_local_feature.launches == before
    assert got.shape == (2, 128, 32) and np.abs(np.asarray(want)).max() > 0.1
    close(got, want)


def test_plf_packer_matches_jax(plf_scale):
    e = plf_scale
    chain, feat_w, mlp2 = jfused.plf_params_from_variables(
        e["v"]["params"], e["v"]["batch_stats"])
    pchain, pfeat_w, pmlp2 = fused.plf_params_from_variables(e["port"])
    assert len(pchain) == len(chain) and len(pmlp2) == len(mlp2)
    close(pfeat_w, feat_w, rtol=0, atol=0)
    for a, b in zip(pchain, chain):
        close(a, b, **PACK_TOL)
    for got, want in zip(pmlp2, mlp2):
        for a, b in zip(got, want):
            close(a, b, **PACK_TOL)
    bn = e["port"].bn0
    s, b = fused.fold_bn_affine(bn)
    js, jb = jfused.fold_bn_affine(e["v"]["params"]["bn0"],
                                   e["v"]["batch_stats"]["bn0"])
    close(s, js, **PACK_TOL)
    close(b, jb, **PACK_TOL)


def test_plf_fused_with_tail_matches_module(plf_scale):
    """K5 plus the mlp2 tail equals the port's module forward and flax."""
    e = plf_scale
    chain, feat_w, mlp2 = fused.plf_params_from_variables(e["port"])
    h = fused.fused_point_local_feature(
        t(e["feats"]) @ feat_w, t(e["idx"]), t(e["xyz"]), chain)
    for w, s, b in mlp2:
        h = torch.relu((h @ w) * s + b)
    with torch.no_grad():
        ref = e["port"](t(e["xyz"]), t(e["feats"]), False, t(e["valid"]))
    close(h, ref.numpy())
    close(h, e["mod"].apply(e["v"], j(e["xyz"]), j(e["feats"]), False,
                            j(e["valid"])))


def test_mse_fused_wide_branch_matches_jax():
    """The wide branch of ``_mse_fused`` (K5 per scale, fan-in parts with a
    broadcast global term), at a first layer of 128 and N=128."""
    rs = np.random.RandomState(33)
    xyz = cloud(rs, 1, 128)
    local = rs.randn(1, 128, 20).astype(np.float32)
    glob = rs.randn(1, 12).astype(np.float32)
    feats = np.concatenate(
        [local, np.broadcast_to(glob[:, None], (1, 128, 12))], axis=-1)
    valid = valid_mask(rs, 1, 128)
    radii, ks = (2.0, 8.0), (8, 16)
    mod = jblocks.MultiScaleEncoder(radii, ks, (128, 64, 32), (32, 32, 32))
    v = flax_vars(mod, j(xyz), j(feats), True, j(valid))
    port = blocks.MultiScaleEncoder(radii, ks, 32, (128, 64, 32),
                                    (32, 32, 32))
    load_flax_variables(port, v)
    want = jinf._mse_fused(v["params"], v["batch_stats"], radii, ks, j(xyz),
                           (j(local), j(glob)), j(valid), True)
    got = inference._mse_fused(port, t(xyz), (t(local), t(glob)), t(valid))
    close(got, want)
    close(got, mod.apply(v, j(xyz), j(feats), False, j(valid)))


# ---------------------------------------------------------------------------
# K4a + K4b: the cost volume
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def correlator():
    """A FeatureCorrelator at C=64 (mlp 64,64,64), k=8, B=2, N=128, frame
    features 24 wide, with valid masks on both frames."""
    rs = np.random.RandomState(34)
    xyz1 = cloud(rs, 2, 128)
    xyz2 = xyz1 + (rs.randn(2, 128, 3) * 0.3).astype(np.float32)
    p1 = rs.randn(2, 128, 24).astype(np.float32)
    p2 = rs.randn(2, 128, 24).astype(np.float32)
    v1, v2 = valid_mask(rs, 2, 128), valid_mask(rs, 2, 128)
    args = (xyz1, xyz2, p1, p2)
    mod = jblocks.FeatureCorrelator(nsample=8, mlp=(64, 64, 64))
    v = flax_vars(mod, *map(j, args), True, j(v1), j(v2))
    port = blocks.FeatureCorrelator(8, 24, 24, (64, 64, 64))
    load_flax_variables(port, v)
    idx2 = jpo.knn(8, j(xyz1), j(xyz2), j(v2))
    idx1 = jpo.knn(8, j(xyz1), j(xyz1), j(v1))
    return dict(args=args, v1=v1, v2=v2, mod=mod, v=v, port=port, idx1=idx1,
                idx2=idx2)


def test_cost_volume_matches_pallas(correlator):
    e = correlator
    xyz1, xyz2, p1, p2 = e["args"]
    w0 = e["v"]["params"]["w0"]
    dense, wn1, wn2 = jfused.cv_params_from_variables(e["v"]["params"])
    want = jfused.fused_cost_volume(
        j(p1) @ w0[:24], j(p2) @ w0[24:48], e["idx2"], j(xyz1), e["idx1"],
        j(xyz2), True, dense=dense, wn1=wn1, wn2=wn2)
    pdense, pwn1, pwn2 = fused.cv_params_from_variables(e["port"])
    pw0 = e["port"].w0
    before = (fused.cost_volume_p2p.launches, fused.cost_volume_agg.launches)
    got = fused.fused_cost_volume(
        t(p1) @ pw0[:24], t(p2) @ pw0[24:48], t(e["idx2"]), t(xyz1),
        t(e["idx1"]), t(xyz2), dense=pdense, wn1=pwn1, wn2=pwn2)
    assert (fused.cost_volume_p2p.launches,
            fused.cost_volume_agg.launches) == before
    assert got.shape == (2, 128, 64) and np.abs(np.asarray(want)).max() > 0.1
    close(got, want)


@pytest.mark.parametrize("k", [1, 5, 33])
def test_cost_volume_matches_pallas_any_k(correlator, k):
    """Both halves at K other than the model's 8, past K4a's K <= 32 on the
    card too: C=64, B=2, N=64, masked clouds, against the Pallas kernels in
    interpret mode (which unroll by the largest of 8, 4, 2, 1 dividing K)."""
    e = correlator
    rs = np.random.RandomState(40 + k)
    xyz1 = cloud(rs, 2, 64)
    xyz2 = xyz1 + (rs.randn(2, 64, 3) * 0.3).astype(np.float32)
    # features of 10x the fixture's scale: at k=1 the sum has one term
    p1 = (rs.randn(2, 64, 24) * 10.0).astype(np.float32)
    p2 = (rs.randn(2, 64, 24) * 10.0).astype(np.float32)
    v1, v2 = valid_mask(rs, 2, 64), valid_mask(rs, 2, 64)
    idx2 = jpo.knn(k, j(xyz1), j(xyz2), j(v2))
    idx1 = jpo.knn(k, j(xyz1), j(xyz1), j(v1))
    w0 = e["v"]["params"]["w0"]
    dense, wn1, wn2 = jfused.cv_params_from_variables(e["v"]["params"])
    want = jfused.fused_cost_volume(
        j(p1) @ w0[:24], j(p2) @ w0[24:48], idx2, j(xyz1), idx1, j(xyz2),
        True, dense=dense, wn1=wn1, wn2=wn2)
    pdense, pwn1, pwn2 = fused.cv_params_from_variables(e["port"])
    pw0 = e["port"].w0
    with torch.no_grad():
        got = fused.fused_cost_volume(
            t(p1) @ pw0[:24], t(p2) @ pw0[24:48], t(idx2), t(xyz1), t(idx1),
            t(xyz2), dense=pdense, wn1=pwn1, wn2=pwn2)
    assert got.shape == (2, 64, 64) and np.abs(np.asarray(want)).max() > 0.1
    close(got, want)


def test_cost_volume_matches_module(correlator):
    """``_cost_volume`` (the kNN, the fan-in products and K4) against the
    port's module forward and flax."""
    e = correlator
    xyz1, xyz2, p1, p2 = e["args"]
    got = inference._cost_volume(e["port"], t(xyz1), t(xyz2), (t(p1),),
                                 (t(p2),), t(e["v1"]), t(e["v2"]))
    with torch.no_grad():
        ref = e["port"](*map(t, e["args"]), False, t(e["v1"]), t(e["v2"]))
    close(got, ref.numpy())
    close(got, e["mod"].apply(e["v"], *map(j, e["args"]), False, j(e["v1"]),
                              j(e["v2"])))


def test_cv_packer_matches_jax(correlator):
    e = correlator
    want = jfused.cv_params_from_variables(e["v"]["params"])
    got = fused.cv_params_from_variables(e["port"])
    for g, w in zip(got, want):
        assert len(g) == len(w) == 6
        for a, b in zip(g, w):
            close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("k", [1, 32, 33, 64])
def test_cost_volume_shape_checks(k):
    """K4a's and K4b's check takes any K >= 1 and any C (the tuned kernels
    at C=512, the generic one at every other); it raises only for K < 1 and
    a WeightNet whose hidden width is not 8, which the JAX package fixes
    too."""
    b, n, h = 2, 5, fused.WEIGHTNET_HIDDEN
    idx = torch.zeros((b, n, k), dtype=torch.int32)
    z = torch.zeros((b, n, h))
    for c in (64, fused.CV_WIDTH, 768):
        wn = [torch.zeros(h), torch.zeros((h, h)), torch.zeros(h),
              torch.zeros((h, c)), torch.zeros(c)]
        fused._check_cv(b, n, c, k, idx, z, wn)
        arm = fused.TUNED if c == fused.CV_WIDTH else fused.GENERIC
        assert fused.cv_agg_arm(c) == fused.cv_p2p_arm((c, c, c)) == arm
    with pytest.raises(ValueError, match="K >= 1"):
        fused._check_cv(b, n, c, 0, idx[..., :0], z, wn)
    with pytest.raises(ValueError, match=f"WeightNet {h}->{h}->C"):
        fused._check_cv(b, n, c, k, idx, torch.zeros((b, n, 4)), wn)
    with pytest.raises(ValueError, match=f"WeightNet {h}->{h}->C"):
        fused._check_cv(b, n, 64, k, idx, z, wn)


# ---------------------------------------------------------------------------
# folded bases, heads, fan-in
# ---------------------------------------------------------------------------

def test_folded_bases_match_jax():
    rs = np.random.RandomState(35)
    xyz = cloud(rs, 2, 64, scale=30.0)
    feats = rs.randn(2, 64, 5).astype(np.float32)
    wr = [rs.randn(3, 16).astype(np.float32) for _ in range(3)]
    wf = [rs.randn(5, 16).astype(np.float32) for _ in range(3)]
    # the mean is summed in another order: a few ulps of the coordinates
    close(fused.center_xyz(t(xyz)), jfused.center_xyz(j(xyz)), rtol=0,
          atol=1e-5)
    xc = np.asarray(jfused.center_xyz(j(xyz)))
    close(fused.make_plf_base(t(feats @ wf[0]), t(xc), t(wr[0])),
          jfused.make_plf_base(j(feats @ wf[0]), j(xc), j(wr[0])), **TOL)
    stacked = jfused.make_mse_base(j(feats), j(xc), [j(w) for w in wr],
                                   [j(w) for w in wf])
    # the JAX base stacks scale blocks along rows with zeros elsewhere
    want = np.asarray(stacked).reshape(2, 3, 64, 48).sum(axis=1)
    close(fused.make_mse_base(t(feats), t(xc), [t(w) for w in wr],
                              [t(w) for w in wf]), want, **TOL)


@pytest.fixture(scope="module")
def heads():
    """Flow and motion heads at the CMFlow widths (512 -> 256,128,64)."""
    rs = np.random.RandomState(36)
    x = rs.randn(2, 64, 512).astype(np.float32)
    out = {}
    for name, cls, pcls in (("fp", jblocks.FlowHead, blocks.FlowHead),
                            ("mp", jblocks.MotionHead, blocks.MotionHead)):
        mod = cls((256, 128, 64))
        v = flax_vars(mod, j(x), True)
        port = pcls(512, (256, 128, 64))
        load_flax_variables(port, v)
        out[name] = (v, port)
    return x, out


def test_heads_joint_matches_two_heads_and_jax(heads):
    x, h = heads
    (vf, fp), (vm, mp) = h["fp"], h["mp"]
    flow, logit = inference._heads_joint(fp, mp, (t(x),))
    close(flow, inference._head(fp, (t(x),)), rtol=2e-5, atol=2e-5)
    close(logit, inference._head(mp, (t(x),)), rtol=2e-5, atol=2e-5)
    jflow, jlogit = jinf._heads_joint(vf["params"], vf["batch_stats"],
                                      vm["params"], vm["batch_stats"],
                                      (j(x),))
    close(flow, jflow)
    close(logit, jlogit)


def test_fanin_dot_matches_concat(heads):
    """Concat-free fan-in: a [B,N,Ca] part and a [B,Cb] broadcast part give
    the product of the materialised concatenation."""
    x, h = heads
    fp, mp = h["fp"][1], h["mp"][1]
    rs = np.random.RandomState(37)
    g = rs.randn(2, 256).astype(np.float32)
    cat = np.concatenate([x[..., :256], np.broadcast_to(g[:, None],
                                                        (2, 64, 256))], -1)
    w = fp.mlp.dense_0.weight.t()
    close(inference._fanin_dot((t(x[..., :256]), t(g)), w),
          (t(cat) @ w).detach().numpy(), rtol=2e-5, atol=2e-5)
    for a, b in zip(inference._heads_joint(fp, mp, (t(x[..., :256]), t(g))),
                    inference._heads_joint(fp, mp, (t(cat),))):
        close(a, b.detach().numpy(), rtol=2e-5, atol=2e-5)
    with pytest.raises(ValueError, match="rows"):
        inference._fanin_dot((t(g),), w)


def test_wrappers_reject_bad_inputs(plf_scale):
    e = plf_scale
    chain, feat_w, _ = fused.plf_params_from_variables(e["port"])
    feat_tx = t(e["feats"]) @ feat_w
    with pytest.raises(TypeError, match="int32"):
        fused.fused_point_local_feature(feat_tx, t(e["idx"]).long(),
                                        t(e["xyz"]), chain)
    with pytest.raises(TypeError, match="float32"):
        fused.fused_point_local_feature(feat_tx.double(), t(e["idx"]),
                                        t(e["xyz"]), chain)
