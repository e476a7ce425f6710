"""Port parity: the geometry helpers and the experimental label variants of
``cmflow_tpu_torch`` against the JAX package on the CPU.

Bars.  ``se3_inverse``, ``relative_se3`` and ``quat2mat``: atol 1e-6
(3x3 products summed in another order).  ``get_matrix_from_ext`` and
``CameraCalib.from_kitti_file`` are the same host numpy and scipy code: bit
for bit.  ``probabilistic_label_rrv``: rtol 1e-5, atol 1e-6.

The two optical-flow variants take a pixel residual through
``project_radar_to_image``, whose 4-term sums reach ~1e5 before the divide
by depth and round differently in the two frameworks: the projection is
held to atol 1e-3 px (tests/test_torch_losses.py), and here the residual
moves by up to ~7e-4 px.  So the residual is held to 2e-3 px (the
projection's bar on u and v, through the norm);
``probabilistic_label_opt`` to rtol 1e-5, atol 1e-6 plus its derivative
times that bar, ``p * r / sigma^2 * 2e-3``; ``mseg_label_opt`` is equal at
every point whose residual lies farther than 2e-3 px from ``opt_thres``,
and the points within are counted.
"""

# the residual's bar in pixels: the projection's 1e-3 px on u and v
RESIDUAL_PX = 2e-3

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmflow_tpu import geometry as jgeo
from cmflow_tpu.train import labels as jlabels
from cmflow_tpu_torch import geometry
from cmflow_tpu_torch.data.synthetic import make_train_batch
from cmflow_tpu_torch.data.vod import VOD_CAMERA_PROJECTION, VOD_T_CAMERA_RADAR
from cmflow_tpu_torch.train import labels


def t(x):
    return torch.from_numpy(np.array(x))


def random_transforms(rs, b):
    """``[b, 4, 4]`` rigid transforms from random unit quaternions."""
    q = rs.randn(b, 4)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    rot = np.asarray(jgeo.quat2mat(jnp.asarray(q, jnp.float32)))
    out = np.tile(np.eye(4, dtype=np.float32), (b, 1, 1))
    out[:, :3, :3] = rot
    out[:, :3, 3] = rs.randn(b, 3) * 5
    return out.astype(np.float32)


def test_exports_match_jax():
    assert sorted(geometry.__all__) == sorted(jgeo.__all__)


def test_quat2mat():
    rs = np.random.RandomState(1)
    q = rs.randn(6, 4).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    got = geometry.quat2mat(t(q)).numpy()
    want = np.asarray(jgeo.quat2mat(jnp.asarray(q)))
    assert got.shape == (6, 3, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got @ got.transpose(0, 2, 1),
                               np.tile(np.eye(3), (6, 1, 1)), atol=1e-5)


@pytest.mark.parametrize("lead", [(5,), (2, 3)])
def test_se3_inverse_and_relative(lead):
    rs = np.random.RandomState(2)
    n = int(np.prod(lead))
    a = random_transforms(rs, n).reshape(*lead, 4, 4)
    b = random_transforms(rs, n).reshape(*lead, 4, 4)
    inv = geometry.se3_inverse(t(a))
    assert inv.shape == a.shape
    np.testing.assert_allclose(inv.numpy(),
                               np.asarray(jgeo.se3_inverse(jnp.asarray(a))),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose((inv @ t(a)).numpy(),
                               np.broadcast_to(np.eye(4), a.shape), atol=1e-5)
    rel = geometry.relative_se3(t(a), t(b))
    want = jgeo.relative_se3(jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_allclose(rel.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5 * max(1.0, float(np.abs(want).max())))


def test_get_matrix_from_ext():
    rs = np.random.RandomState(3)
    for ext in (rs.randn(6) * [5, 5, 1, 90, 10, 10],
                rs.randn(7, 6) * [5, 5, 1, 90, 10, 10]):
        got = geometry.get_matrix_from_ext(ext)
        want = jgeo.get_matrix_from_ext(ext)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


def test_camera_calib_from_kitti_file(tmp_path):
    path = tmp_path / "calib.txt"
    proj = np.asarray(VOD_CAMERA_PROJECTION, np.float32)
    ext = np.asarray(VOD_T_CAMERA_RADAR, np.float32)[:3]
    path.write_text(
        "P0: 1 0 0 0 0 1 0 0 0 0 1 0\nP1: 1 0 0 0 0 1 0 0 0 0 1 0\n"
        f"P2: {' '.join(repr(float(v)) for v in proj.ravel())}\n"
        "R0_rect: 1 0 0 0 1 0 0 0 1\nTr_imu_to_velo: 0 0 0 0 0 0 0 0 0 0 0 0\n"
        f"Tr_velo_to_cam: {' '.join(repr(float(v)) for v in ext.ravel())}\n")
    got = geometry.CameraCalib.from_kitti_file(str(path))
    want = jgeo.CameraCalib.from_kitti_file(str(path))
    assert [f.name for f in dataclasses.fields(got)] == [
        f.name for f in dataclasses.fields(want)]
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got.projection, proj)


@pytest.fixture(scope="module")
def batch():
    return make_train_batch(5, 2, 128)


def test_probabilistic_label_rrv(batch):
    args = [batch[k] for k in ("pc1", "trans")] + [batch["ft1"][..., 0],
                                                   batch["interval"]]
    got = labels.probabilistic_label_rrv(*map(t, args), 0.5)
    want = jlabels.probabilistic_label_rrv(*map(jnp.asarray, args), 0.5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def opt_args(batch):
    """The optical-flow label inputs; the synthetic flow is the ego motion's
    own, so noise of a few pixels spreads the residuals."""
    noise = np.random.RandomState(6).randn(*batch["opt_flow"].shape) * 3.0
    return [batch[k] for k in ("pc1", "trans", "radar_u", "radar_v")] + [
        (batch["opt_flow"] + noise).astype(np.float32),
        np.asarray(VOD_CAMERA_PROJECTION, np.float32),
        np.asarray(VOD_T_CAMERA_RADAR, np.float32)]


def float64_residual(args):
    """The optical-flow residual ``[B, N]`` in float64, numpy."""
    p = np.asarray(args[5], np.float64)
    tcr = np.asarray(args[6], np.float64)
    pc1, trans = (np.asarray(a, np.float64) for a in args[:2])
    warped = np.einsum("bij,bnj->bni", trans[:, :3, :3], pc1) \
        + trans[:, None, :3, 3]
    hom = np.concatenate([warped, np.ones(warped.shape[:2] + (1,))], -1)
    uvz = np.einsum("ij,bnj->bni", p, np.einsum("ij,bnj->bni", tcr, hom))
    end = np.stack([args[2], args[3]], -1) + args[4]
    return np.linalg.norm(uvz[..., :2] / uvz[..., 2:3] - end, axis=-1)


def test_opt_residual(batch):
    args = opt_args(batch)
    got = labels._opt_residual(*map(t, args)).numpy()
    a = list(map(jnp.asarray, args))
    end = jnp.stack([a[2], a[3]], -1) + a[4]
    warped = jgeo.rigid_to_flow(a[0], a[1]) + a[0]
    want = np.asarray(jnp.linalg.norm(
        jgeo.project_radar_to_image(warped, a[5], a[6]) - end, axis=-1))
    np.testing.assert_allclose(got, want, rtol=0, atol=RESIDUAL_PX)


def test_probabilistic_label_opt(batch):
    args = opt_args(batch)
    sigma = 4.0
    got = labels.probabilistic_label_opt(*map(t, args), sigma).numpy()
    want = np.asarray(jlabels.probabilistic_label_opt(
        *map(jnp.asarray, args), sigma))
    r = float64_residual(args)
    bar = 1e-6 + 1e-5 * np.abs(want) + want * r / sigma ** 2 * RESIDUAL_PX
    assert (np.abs(got - want) <= bar).all(), np.abs(got - want).max()
    assert 0.01 < want.mean() < 0.99  # the labels span the range


def test_mseg_label_opt(batch):
    args = opt_args(batch)
    residual = float64_residual(args)
    # the threshold where both classes occur
    thres = float(np.median(residual))
    got = labels.mseg_label_opt(*map(t, args), thres).numpy()
    want = np.asarray(jlabels.mseg_label_opt(*map(jnp.asarray, args), thres))
    assert got.dtype == want.dtype == np.float32
    assert 0 < want.sum() < want.size  # both classes
    near = np.abs(residual - thres) <= RESIDUAL_PX
    assert int(near.sum()) <= 2, int(near.sum())  # the median point itself
    np.testing.assert_array_equal(got[~near], want[~near])
