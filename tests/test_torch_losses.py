"""Port parity: the losses, pseudo labels, camera geometry and the
differentiable Kabsch of ``cmflow_tpu_torch`` against the JAX package on
the CPU, values and gradients.

Inputs are synthetic training batches (``make_train_batch``), one of them
with clouds shorter than ``num_points``, which the loader pads with
duplicate points: a point and its duplicate tie at d^2 = 0 in the
smoothness loss's top-k and give zero differences in the zero-subgradient
norms.  Bars: values rtol 1e-5 (atol 1e-6), gradients within 1e-5 of their
largest magnitude (float32 sums in another order); the pseudo labels and the
smoothness loss's neighbour choice exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmflow_tpu.geometry import camera as jcam
from cmflow_tpu.geometry import se3 as jse3
from cmflow_tpu.losses import radar_loss as jrl
from cmflow_tpu.train import labels as jlabels
from cmflow_tpu_torch.data.synthetic import make_scene, make_train_batch
from cmflow_tpu_torch.data.vod import (
    VOD_CAMERA_PROJECTION,
    VOD_T_CAMERA_RADAR,
    decode_sample,
)
from cmflow_tpu_torch.geometry import camera, se3
from cmflow_tpu_torch.losses import radar_loss as rl
from cmflow_tpu_torch.train import labels

P, TCR = VOD_CAMERA_PROJECTION, VOD_T_CAMERA_RADAR


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def t(x, grad=False):
    out = torch.from_numpy(np.array(x))
    return out.requires_grad_(True) if grad else out


def j(x):
    return jnp.asarray(x)


def short_cloud_batch(seed, b, num_points, cloud_points):
    """Like ``make_train_batch``, from clouds of ``cloud_points`` points,
    which the loader pads with duplicates up to ``num_points``."""
    rng = np.random.default_rng(seed)
    samples = [decode_sample(make_scene(rng, n1=cloud_points,
                                        n2=cloud_points),
                             "train", eval_mode=False, num_points=num_points,
                             rng=rng) for _ in range(b)]
    return {k: np.stack([s[k] for s in samples]) for k in samples[0]
            if k not in ("valid1", "valid2")}


# full clouds (drawn without repeats), and short clouds padded with duplicates
BATCHES = {"full": lambda: make_train_batch(5, 2, 64),
           "duplicates": lambda: short_cloud_batch(5, 2, 64, 40)}


@pytest.fixture(scope="module", params=sorted(BATCHES))
def batch(request):
    b = BATCHES[request.param]()
    rs = np.random.RandomState(6)
    b["pred_f"] = (b["labels"] + rs.randn(2, 64, 3) * 0.2).astype(np.float32)
    if request.param == "duplicates":
        # points 40.. repeat random points of the first 40; each keeps its
        # original's predicted flow: zero differences
        for e in range(2):
            same = (b["pc1"][e, 40:, None] == b["pc1"][e, None, :40]).all(-1)
            assert same.any(-1).all()
            b["pred_f"][e, 40:] = b["pred_f"][e, same.argmax(-1)]
    b["mseg_pre"] = rs.uniform(0.05, 0.95, (2, 64)).astype(np.float32)
    return b


def close(got, want, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(want),
                               rtol=rtol, atol=atol)


def grad_close(got, want, tol=1e-5):
    want = np.asarray(want)
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=tol * max(np.abs(want).max(), 1e-30))


def value_and_grad_pair(jfn, tfn, x):
    """The loss value and its gradient in ``x`` on both sides."""
    jv, jg = jax.value_and_grad(jfn)(j(x))
    xt = t(x, grad=True)
    tv = tfn(xt)
    tv.backward()
    return (tv, xt.grad), (jv, jg)


LOSSES = {
    "chamfer": (lambda b, f: jrl.soft_chamfer_loss(j(b["pc1"]), j(b["pc2"]),
                                                   j(b["pc1"]) + f),
                lambda b, f: rl.soft_chamfer_loss(t(b["pc1"]), t(b["pc2"]),
                                                  t(b["pc1"]) + f)),
    "smoothness": (lambda b, f: jrl.spatial_smoothness_loss(j(b["pc1"]), f),
                   lambda b, f: rl.spatial_smoothness_loss(t(b["pc1"]), f)),
    "radial": (lambda b, f: jrl.radial_displacement_loss(
                   j(b["pc1"]), f, j(b["ft1"][..., 0])),
               lambda b, f: rl.radial_displacement_loss(
                   t(b["pc1"]), f, t(b["ft1"][..., 0]))),
    "dynamic": (lambda b, f: jrl.dynamic_flow_loss(f, j(b["labels"]),
                                                   j(b["mask"])),
                lambda b, f: rl.dynamic_flow_loss(f, t(b["labels"]),
                                                  t(b["mask"]))),
    "optical": (lambda b, f: jrl.optical_flow_loss(
                    j(b["opt_flow"]), j(b["radar_u"]), j(b["radar_v"]),
                    j(b["pc1"]) + f, j(b["mask"]), j(P), j(TCR)),
                lambda b, f: rl.optical_flow_loss(
                    t(b["opt_flow"]), t(b["radar_u"]), t(b["radar_v"]),
                    t(b["pc1"]) + f, t(b["mask"]), t(P), t(TCR))),
    "ego": (lambda b, f: jrl.ego_motion_loss(
                j(b["pc1"]), jse3.weighted_kabsch(
                    j(b["pc1"]), j(b["pc1"]) + f, centroid="norm"),
                j(b["trans"])),
            lambda b, f: rl.ego_motion_loss(
                t(b["pc1"]), se3.weighted_kabsch(
                    t(b["pc1"]), t(b["pc1"]) + f, centroid="norm"),
                t(b["trans"]))),
}


class TestLosses:
    @pytest.mark.parametrize("name", sorted(LOSSES))
    def test_value_and_flow_gradient(self, batch, name):
        jfn, tfn = LOSSES[name]
        (tv, tg), (jv, jg) = value_and_grad_pair(
            lambda f: jfn(batch, f), lambda f: tfn(batch, f), batch["pred_f"])
        close(tv, jv)
        grad_close(tg, jg)

    def test_smoothness_neighbours_break_ties_low(self, batch):
        """The top-9 of the smoothness loss by a stable sort: the same
        neighbours as ``lax.top_k``, ties to the lower index."""
        d = rl.pointops.square_distance(t(batch["pc1"]), t(batch["pc1"]))
        kidx = torch.sort(d, dim=-1, stable=True).indices[..., :9]
        _, want = jax.lax.top_k(-jrl.pointops.square_distance(
            j(batch["pc1"]), j(batch["pc1"])), 9)
        np.testing.assert_array_equal(kidx.numpy(), np.asarray(want))

    def test_motion_seg_and_bce(self, batch):
        (tv, tg), (jv, jg) = value_and_grad_pair(
            lambda p: jrl.motion_seg_loss(p, j(batch["mask"])),
            lambda p: rl.motion_seg_loss(p, t(batch["mask"])),
            batch["mseg_pre"])
        close(tv, jv)
        grad_close(tg, jg)
        # saturated probabilities: the log clamp at -100
        p = np.array([0.0, 1e-45, 0.5, 1.0], np.float32)
        y = np.array([1.0, 1.0, 0.0, 0.0], np.float32)
        close(rl.binary_cross_entropy(t(p), t(y)),
              jrl.binary_cross_entropy(j(p), j(y)))
        # one class absent: that half adds 0, not NaN
        ones = np.ones((2, 64), np.float32)
        close(rl.motion_seg_loss(t(batch["mseg_pre"]), t(ones)),
              jrl.motion_seg_loss(j(batch["mseg_pre"]), j(ones)))

    def test_composite(self, batch):
        b = batch
        mseg_gt = jlabels.merge_mseg_labels(
            jlabels.mseg_label_rrv(j(b["pc1"]), j(b["trans"]),
                                   j(b["ft1"][..., 0]), j(b["interval"]),
                                   0.3)[0],
            j(b["mask"]))
        pre_trans = np.asarray(jse3.weighted_kabsch(
            j(b["pc1"]), j(b["pc1"] + b["pred_f"])))
        common = ("pc1", "pc2")

        def jfn(f, m):
            return jrl.radar_flow_loss(
                "cmflow", *[j(b[k]) for k in common], f, j(b["ft1"][..., 0]),
                gt_f=j(b["labels"]), pre_trans=j(pre_trans), mseg_pre=m,
                gt_trans=j(b["trans"]), mseg_gt=mseg_gt, dyn_mask=j(b["mask"]),
                radar_u=j(b["radar_u"]), radar_v=j(b["radar_v"]),
                opt=j(b["opt_flow"]), projection=j(P), t_camera_radar=j(TCR))

        (jl, jitems), jg = jax.value_and_grad(jfn, argnums=(0, 1),
                                              has_aux=True)(
            j(b["pred_f"]), j(b["mseg_pre"]))
        f, m = t(b["pred_f"], True), t(b["mseg_pre"], True)
        tl, titems = rl.radar_flow_loss(
            "cmflow", *[t(b[k]) for k in common], f, t(b["ft1"][..., 0]),
            gt_f=t(b["labels"]), pre_trans=t(pre_trans), mseg_pre=m,
            gt_trans=t(b["trans"]), mseg_gt=t(np.asarray(mseg_gt)),
            dyn_mask=t(b["mask"]), radar_u=t(b["radar_u"]),
            radar_v=t(b["radar_v"]), opt=t(b["opt_flow"]), projection=t(P),
            t_camera_radar=t(TCR))
        tl.backward()
        assert sorted(titems) == sorted(rl.LOSS_ITEMS["cmflow"])
        assert sorted(jitems) == sorted(titems)
        for k in titems:
            close(titems[k], jitems[k])
        grad_close(f.grad, jg[0])
        grad_close(m.grad, jg[1])
        _, ritems = rl.radar_flow_loss("raflow", t(b["pc1"]), t(b["pc2"]),
                                       t(b["pred_f"]), t(b["ft1"][..., 0]))
        assert sorted(ritems) == sorted(rl.LOSS_ITEMS["raflow"])


class TestLabels:
    def test_pseudo_labels(self, batch):
        b = batch
        dyn = labels.extract_dynamic_from_fg(t(b["mask"]), t(b["pc1"]),
                                             t(b["trans"]), t(b["labels"]))
        jdyn = jlabels.extract_dynamic_from_fg(j(b["mask"]), j(b["pc1"]),
                                               j(b["trans"]), j(b["labels"]))
        np.testing.assert_array_equal(dyn.numpy(), np.asarray(jdyn))
        # moving points in the mask, some of them re-labelled static
        assert (b["mask"] == 0).any()
        rrv, res = labels.mseg_label_rrv(t(b["pc1"]), t(b["trans"]),
                                         t(b["ft1"][..., 0]), t(b["interval"]),
                                         0.3)
        jrrv, jres = jlabels.mseg_label_rrv(j(b["pc1"]), j(b["trans"]),
                                            j(b["ft1"][..., 0]),
                                            j(b["interval"]), 0.3)
        np.testing.assert_array_equal(rrv.numpy(), np.asarray(jrrv))
        close(res, jres)
        np.testing.assert_array_equal(
            labels.merge_mseg_labels(rrv, dyn).numpy(),
            np.asarray(jlabels.merge_mseg_labels(jrrv, jdyn)))


class TestGeometry:
    def test_camera(self, batch):
        b = batch
        close(camera.project_radar_to_image(t(b["pc1"]), t(P), t(TCR)),
              jcam.project_radar_to_image(j(b["pc1"]), j(P), j(TCR)),
              rtol=1e-5, atol=1e-3)
        warped = (b["pc1"] + b["pred_f"]).astype(np.float32)
        pix = (b["opt_flow"] + np.stack([b["radar_u"], b["radar_v"]], -1))
        pix = pix.astype(np.float32)
        # and with the identity calibration, half the points exactly on
        # their rays (pixel (0, 0) and a point on the optical axis: a zero
        # cross product, where the norm takes its zero subgradient)
        eye_p = np.eye(3, 4, dtype=np.float32)
        eye_t = np.eye(4, dtype=np.float32)
        on_ray, px0 = warped.copy(), pix * 1e-3
        on_ray[:, :32, :2] = 0.0
        px0[:, :32] = 0.0
        # with the VoD calibration a warped point ~20 m out lies ~0.2 m off
        # its ray: the cross product loses ~2 digits to cancellation, and
        # K^-1 is inverted by two libraries, so its gradient is held to 1e-3
        for w, px, pp, tt, tol in ((warped, pix, P, TCR, 1e-3),
                                   (on_ray, px0, eye_p, eye_t, 1e-5)):
            (tv, tg), (jv, jg) = value_and_grad_pair(
                lambda x: jnp.sum(jcam.point_ray_distance(x, j(px), j(pp),
                                                          j(tt))),
                lambda x: torch.sum(camera.point_ray_distance(
                    x, t(px), t(pp), t(tt))),
                w)
            close(tv, jv, rtol=1e-4)
            grad_close(tg, jg, tol)
        dist = camera.point_ray_distance(t(on_ray), t(px0), t(eye_p),
                                         t(eye_t))
        assert (dist[:, :32] == 0).all()

    def test_kde_density(self, batch):
        close(se3.kde_density(t(batch["pc1"]), t(batch["pc2"])),
              jse3.kde_density(j(batch["pc1"]), j(batch["pc2"])))
        close(se3.kde_density(t(batch["pc1"]), t(batch["pc1"]), 2.0),
              jse3.kde_density(j(batch["pc1"]), j(batch["pc1"]), 2.0))


def sign_free_svd_loss(u, s, vh, a, w, c, lib):
    """A function of the SVD that does not depend on the sign of each
    singular pair: ``<A, U diag(w) Vh> + <c, s>``."""
    return lib.sum(a * (u * w[..., None, :]) @ vh) + lib.sum(c * s)


class TestSvd:
    def test_backward_matches_regularised_jvp(self):
        rs = np.random.RandomState(8)
        h = rs.randn(16, 3, 3).astype(np.float32)
        a = rs.randn(16, 3, 3).astype(np.float32)
        w = np.array([1.0, -0.5, 2.0], np.float32)
        c = rs.randn(16, 3).astype(np.float32)

        def jfn(x):
            u, s, vh = jse3._svd3(x)
            return sign_free_svd_loss(u, s, vh, j(a), j(w), j(c), jnp)

        jg = jax.grad(jfn)(j(h))
        ht = t(h, True)
        u, s, vh = se3._SVD3.apply(ht)
        sign_free_svd_loss(u, s, vh, t(a), t(w), t(c), torch).backward()
        np.testing.assert_allclose(ht.grad.numpy(), np.asarray(jg), rtol=0,
                                   atol=1e-4 * np.abs(jg).max())
        # each output's cotangent alone, by jax.vjp.  A cotangent of U or Vh
        # is not sign free: the port's pairs are flipped to JAX's signs
        # (U_port = U_jax diag(sign), Vh_port = diag(sign) Vh_jax)
        ju, _, _ = jse3._svd3(j(h))
        tu, _, _ = se3._SVD3.apply(t(h))
        sign = np.sign(np.sum(np.asarray(ju) * tu.numpy(), axis=-2))
        assert (np.abs(sign) == 1).all()
        _, vjp = jax.vjp(jse3._svd3, j(h))
        shapes = ((16, 3, 3), (16, 3), (16, 3, 3))
        for which in range(3):
            cot = [np.zeros(sh, np.float32) for sh in shapes]
            cot[which] = rs.randn(*shapes[which]).astype(np.float32)
            (jgh,) = vjp(tuple(j(x) for x in cot))
            ht = t(h, True)
            torch.autograd.backward(
                se3._SVD3.apply(ht),
                [t(cot[0] * sign[:, None, :]), t(cot[1]),
                 t(cot[2] * sign[:, :, None])])
            np.testing.assert_allclose(ht.grad.numpy(), np.asarray(jgh),
                                       rtol=0,
                                       atol=1e-4 * np.abs(jgh).max())

    @pytest.mark.parametrize("case", ["equal_pair", "zero"])
    def test_finite_at_degenerate_h(self, case):
        rs = np.random.RandomState(9)
        if case == "zero":
            h = np.zeros((4, 3, 3), np.float32)
        else:  # exactly two equal singular values: signed permutations
            perm = np.eye(3)[[2, 0, 1]] * np.array([1.0, -1.0, 1.0])
            h = np.stack([perm @ np.diag([2.0, 0.5, 2.0]) @ perm.T,
                          np.diag([3.0, 3.0, 1.0]), perm @ np.diag(
                              [1.0, 4.0, 4.0]), np.diag([2.0, 2.0, 2.0])])
            h = h.astype(np.float32)
        a = rs.randn(4, 3, 3).astype(np.float32)
        ht = t(h, True)
        u, s, vh = se3._SVD3.apply(ht)
        sign_free_svd_loss(u, s, vh, t(a), t(np.ones(3, np.float32)),
                           t(np.ones((4, 3), np.float32)), torch).backward()
        assert np.isfinite(ht.grad.numpy()).all()
        # torch.linalg.svd's own backward is not: the reason for _SVD3
        if case == "equal_pair":
            h64 = t(h.astype(np.float64), True)
            u, s, vh = torch.linalg.svd(h64)
            (torch.sum(t(a.astype(np.float64)) * u) + vh.sum()).backward()
            assert not np.isfinite(h64.grad.numpy()).all()


class TestKabschGradient:
    @pytest.mark.parametrize("reflect", ["row", "none", "col"])
    def test_matches_jax(self, reflect):
        rs = np.random.RandomState(10)
        a = (rs.randn(4, 64, 3) * 5).astype(np.float32)
        ang = 0.2
        rot = np.array([[np.cos(ang), -np.sin(ang), 0],
                        [np.sin(ang), np.cos(ang), 0], [0, 0, 1]])
        b = (a @ rot.T + rs.randn(4, 1, 3) + rs.randn(4, 64, 3) * 0.05)
        b = b.astype(np.float32)
        w = rs.rand(4, 64).astype(np.float32)
        w /= w.sum(1, keepdims=True)
        wt = rs.randn(4, 4, 4).astype(np.float32)

        def jfn(bb, ww):
            return jnp.sum(j(wt) * jse3.weighted_kabsch(
                j(a), bb, ww, centroid="sum", reflect=reflect))

        jv, (jgb, jgw) = jax.value_and_grad(jfn, argnums=(0, 1))(j(b), j(w))
        bt, wt_ = t(b, True), t(w, True)
        tv = torch.sum(t(wt) * se3.weighted_kabsch(
            t(a), bt, wt_, centroid="sum", reflect=reflect))
        tv.backward()
        close(tv, jv, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(bt.grad.numpy(), np.asarray(jgb), rtol=0,
                                   atol=1e-4 * np.abs(jgb).max())
        np.testing.assert_allclose(wt_.grad.numpy(), np.asarray(jgw), rtol=0,
                                   atol=1e-4 * np.abs(jgw).max())

    def test_value_from_polar_gradient_from_svd(self):
        """The rotation's value is the polar factor's (as in the JAX
        package), and its gradient stays finite where H is singular."""
        rs = np.random.RandomState(11)
        a = (rs.randn(2, 32, 3) * 5).astype(np.float32)
        w = rs.rand(2, 32).astype(np.float32)
        w[1] = 0.0  # H = 0 for the second element
        bt = t(a + 0.1, True)
        trans = se3.weighted_kabsch(t(a), bt, t(w))
        close(trans, jse3.weighted_kabsch(j(a), j(a + 0.1), j(w)),
              rtol=0, atol=1e-5)
        trans.sum().backward()
        assert np.isfinite(bt.grad.numpy()).all()
