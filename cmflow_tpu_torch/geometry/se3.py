"""SE(3) geometry: batched weighted Kabsch, rigid flow, transforms and
their inverses, quaternions, sensor extrinsics, KDE density.

Counterpart of ``cmflow_tpu/geometry/se3.py``.  One function covers the
reference's three Kabsch variants through its ``centroid`` and ``reflect``
modes; see :func:`weighted_kabsch`.  The 3x3 SVDs and determinants go to
``torch.linalg``; the SVD's derivative is the JAX package's regularised rule
(:class:`_SVD3`), not ``torch.linalg.svd``'s, which is inf/NaN at equal
singular values.
"""

from __future__ import annotations

from typing import Optional

import torch

Tensor = torch.Tensor


class _SVD3(torch.autograd.Function):
    """Batched 3x3 SVD ``h = u @ diag(s) @ vh`` with a regularised
    derivative (``_svd3`` of the JAX package, ``se3.py:33-75``).

    The JAX package defines the JVP: the standard SVD differential with the
    resolvent ``1 / (s_j^2 - s_i^2)`` replaced by ``f = d / (d^2 + eps)``,
    ``d = s_j^2 - s_i^2`` and ``eps = (1e-8 max s^2 + 1e-18)^2``, exact for
    well separated singular values and finite where they meet (H = 0
    included).  The backward here is that JVP's transpose:

        dp = u^T dh v,  du = u (f * (dp s_j + s_i dp^T)),
        dv = v (f * (s_i dp + dp^T s_j)),  ds = diag(dp)

    gives, with ``mu = f * (u^T gu)`` and ``mv = f * (v^T gv)``,

        gh = u (s_j (mu + mu^T) + s_i (mv + mv^T) + diag(gs)) vh.
    """

    @staticmethod
    def forward(ctx, h: Tensor):
        u, s, vh = torch.linalg.svd(h)
        ctx.save_for_backward(u, s, vh)
        return u, s, vh

    @staticmethod
    def backward(ctx, gu: Tensor, gs: Tensor, gvh: Tensor) -> Tensor:
        u, s, vh = ctx.saved_tensors
        s2 = s * s
        d = s2[..., None, :] - s2[..., :, None]  # d[i, j] = s_j^2 - s_i^2
        smax2 = torch.amax(s2, dim=-1, keepdim=True)[..., None]
        eps = (1e-8 * smax2 + 1e-18) ** 2
        f = d / (d * d + eps)
        mu = f * (u.transpose(-1, -2) @ gu)
        mv = f * (vh @ gvh.transpose(-1, -2))
        p = ((mu + mu.transpose(-1, -2)) * s[..., None, :]
             + s[..., :, None] * (mv + mv.transpose(-1, -2))
             + torch.diag_embed(gs))
        return u @ p @ vh


def _cof3(x: Tensor) -> Tensor:
    """Cofactor matrix of batched 3x3 ``x`` (so ``x^{-T} = cof / det``)."""
    a, b, c = x[..., 0, 0], x[..., 0, 1], x[..., 0, 2]
    d, e, f = x[..., 1, 0], x[..., 1, 1], x[..., 1, 2]
    g, h, i = x[..., 2, 0], x[..., 2, 1], x[..., 2, 2]
    row0 = torch.stack([e * i - f * h, f * g - d * i, d * h - e * g], -1)
    row1 = torch.stack([c * h - b * i, a * i - c * g, b * g - a * h], -1)
    row2 = torch.stack([b * f - c * e, c * d - a * f, a * e - b * d], -1)
    return torch.stack([row0, row1, row2], -2)


def polar3(h: Tensor, iters: int = 9) -> Tensor:
    """Orthogonal polar factor ``W = U @ Vh`` of batched 3x3 ``h``, by the
    determinant-scaled Newton iteration ``X <- (g X + g^-1 X^-T) / 2`` with
    ``g = |det X|^(-1/3)`` (Higham, Functions of Matrices, 8.6).  For an
    exactly singular ``h`` the result is finite but meaningless."""
    normf = torch.sqrt(torch.sum(h * h, dim=(-2, -1), keepdim=True))
    x = h / torch.clamp_min(normf, 1e-30)
    for _ in range(iters):
        cof = _cof3(x)
        det = torch.sum(x[..., 0, :] * cof[..., 0, :], dim=-1)
        tiny = torch.where(det < 0, -1e-30, 1e-30).to(det.dtype)
        det_safe = torch.where(det.abs() < 1e-30, tiny, det)
        gamma = det_safe.abs() ** (-1.0 / 3.0)
        gd = (gamma * det_safe)[..., None, None]
        x = 0.5 * (gamma[..., None, None] * x + cof / gd)
    return x


def _flip_row2(m: Tensor, flip: Tensor) -> Tensor:
    """``m`` with its third row multiplied by ``flip`` ``[B]``."""
    return torch.cat([m[:, :2], m[:, 2:] * flip[:, None, None]], dim=1)


def weighted_kabsch(
    a: Tensor,
    b: Tensor,
    weights: Optional[Tensor] = None,
    *,
    centroid: str = "norm",
    reflect: str = "row",
    n_override: Optional[Tensor] = None,
    solver: str = "svd",
) -> Tensor:
    """Best-fit rigid transform ``T`` with ``b ~ T @ a`` per batch element.

    Args:
      a, b: ``[B, N, 3]`` source and target points.
      weights: optional ``[B, N]`` nonnegative weights; ``None`` is uniform.
      centroid: ``"norm"`` (weights normalised to sum 1), ``"mean_n"``
        (``sum(x * w) / N``, or ``/ n_override`` per batch element when
        given), or ``"sum"`` (weights used as they are).
      reflect: ``"row"`` (negate the third row of V when ``det < 0``, as the
        reference does), ``"col"`` (the textbook third column) or ``"none"``.
      solver: ``"svd"``, or ``"polar"`` (Newton polar iteration; ``row`` and
        ``none`` only).  On the ``svd`` route with ``row``/``none`` the
        rotation's value is taken from the polar factor wherever that factor
        is orthogonal to 1e-2, and its gradient from the SVD's regularised
        derivative, as the JAX package does.
    Returns:
      ``[B, 4, 4]`` homogeneous transforms.
    """
    bsz, n, _ = a.shape
    if weights is None:
        w = torch.full((bsz, n), 1.0 / n, dtype=a.dtype, device=a.device)
    else:
        w = weights.to(a.dtype)

    if centroid == "norm":
        wn = w / torch.clamp_min(w.sum(dim=1, keepdim=True), 1e-12)
    elif centroid == "mean_n":
        if n_override is not None:
            wn = w / torch.clamp_min(n_override, 1.0)[:, None].to(a.dtype)
        else:
            wn = w / n
    elif centroid == "sum":
        wn = w
    else:
        raise ValueError(f"unknown centroid mode {centroid!r}")

    centroid_a = torch.einsum("bn,bnc->bc", wn, a)
    centroid_b = torch.einsum("bn,bnc->bc", wn, b)
    am = a - centroid_a[:, None, :]
    bm = b - centroid_b[:, None, :]
    h = torch.einsum("bnc,bn,bnd->bcd", am, w, bm)

    if solver == "polar":
        if reflect not in ("row", "none"):
            raise ValueError("solver='polar' supports reflect row|none")
        # z = V U^T is the transpose of the polar factor U Vh, and
        # sign(det z) = sign(det H)
        r = polar3(h).transpose(-1, -2)
        if reflect == "row":
            flip = torch.where(torch.linalg.det(h) < 0, -1.0, 1.0).to(a.dtype)
            r = _flip_row2(r, flip)
    elif solver == "svd":
        u, _, vh = _SVD3.apply(h)
        v = vh.transpose(-1, -2)
        ut = u.transpose(-1, -2)
        flip = torch.where(torch.linalg.det(v @ ut) < 0, -1.0, 1.0).to(a.dtype)
        if reflect == "row":
            v = _flip_row2(v, flip)
        elif reflect == "col":
            v = torch.cat([v[:, :, :2], v[:, :, 2:] * flip[:, None, None]],
                          dim=2)
        elif reflect != "none":
            raise ValueError(f"unknown reflect mode {reflect!r}")
        r = v @ ut
        if reflect in ("row", "none"):
            # straight through: the value from the polar factor, which is
            # accurate where the SVD may not be (unless H is (near) singular
            # and the Newton iterate is not orthogonal), the gradient from
            # the SVD
            with torch.no_grad():
                rp = polar3(h).transpose(-1, -2)
                if reflect == "row":
                    hflip = torch.where(torch.linalg.det(h) < 0, -1.0, 1.0)
                    rp = _flip_row2(rp, hflip.to(a.dtype))
                eye = torch.eye(3, dtype=rp.dtype, device=rp.device)
                orth_err = torch.amax(
                    (rp.transpose(-1, -2) @ rp - eye).abs(), dim=(-2, -1))
                rv = torch.where((orth_err < 1e-2)[:, None, None], rp, r)
            r = r + (rv - r).detach()
    else:
        raise ValueError(f"unknown solver {solver!r}")
    t = centroid_b - torch.einsum("bij,bj->bi", r, centroid_a)
    return make_transform(r, t)


def make_transform(r: Tensor, t: Tensor) -> Tensor:
    """``[B, 4, 4]`` from rotation ``[B, 3, 3]`` and translation ``[B, 3]``."""
    bsz = r.shape[0]
    top = torch.cat([r, t[:, :, None]], dim=2)
    bottom = torch.tensor([[0.0, 0.0, 0.0, 1.0]], dtype=r.dtype,
                          device=r.device).expand(bsz, 1, 4)
    return torch.cat([top, bottom], dim=1)


def rigid_to_flow(pc: Tensor, trans: Tensor) -> Tensor:
    """Scene flow ``T(pc) - pc`` of a rigid transform, ``[B, N, 3]``."""
    return apply_transform(pc, trans) - pc


def apply_transform(pc: Tensor, trans: Tensor) -> Tensor:
    """Apply homogeneous transforms ``[B, 4, 4]`` to points ``[B, N, 3]``."""
    r = trans[:, :3, :3]
    t = trans[:, :3, 3]
    return torch.einsum("bij,bnj->bni", r, pc) + t[:, None, :]


def se3_inverse(trans: Tensor) -> Tensor:
    """Inverse of rigid transforms ``[..., 4, 4]``: ``[R^T, -R^T t]``."""
    r = trans[..., :3, :3]
    t = trans[..., :3, 3]
    r_inv = r.transpose(-1, -2)
    t_inv = -torch.einsum("...ij,...j->...i", r_inv, t)
    return make_transform(r_inv.reshape(-1, 3, 3),
                          t_inv.reshape(-1, 3)).reshape(trans.shape)


def relative_se3(t1: Tensor, t2: Tensor) -> Tensor:
    """``t1^{-1} @ t2`` of transforms ``[..., 4, 4]``
    (utils/odometry_util.py:63-78)."""
    return se3_inverse(t1) @ t2


def quat2mat(quat: Tensor) -> Tensor:
    """Rotation matrices ``[B, 3, 3]`` of quaternions ``[B, 4]`` in (x, y,
    z, w) order (utils/util.py:191-203)."""
    x, y, z, w = quat[:, 0], quat[:, 1], quat[:, 2], quat[:, 3]
    w2, x2, y2, z2 = w * w, x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    rot = torch.stack([
        w2 + x2 - y2 - z2, 2 * xy - 2 * wz, 2 * wy + 2 * xz,
        2 * wz + 2 * xy, w2 - x2 + y2 - z2, 2 * yz - 2 * wx,
        2 * xz - 2 * wy, 2 * wx + 2 * yz, w2 - x2 - y2 + z2,
    ], dim=1)
    return rot.reshape(-1, 3, 3)


def get_matrix_from_ext(ext):
    """Sensor extrinsic ``(x, y, z, yaw, pitch, roll)`` in degrees, ``[6]``
    or ``[N, 6]``, to 4x4 transforms (utils/util.py:225-243); host numpy
    and scipy."""
    import numpy as np
    from scipy.spatial.transform import Rotation

    ext = np.asarray(ext)
    rot = Rotation.from_euler("ZYX", ext[..., 3:], degrees=True).as_matrix()
    tr = np.zeros(ext.shape[:-1] + (4, 4))
    tr[..., :3, :3] = rot
    tr[..., :3, 3] = ext[..., :3]
    tr[..., 3, 3] = 1.0
    return tr


def kde_density(xyz1: Tensor, xyz2: Tensor, bandwidth: float = 1.0) -> Tensor:
    """Gaussian KDE density ``[B, N]`` of each query point of ``xyz1``
    ``[B, N, 3]`` with respect to ``xyz2`` ``[B, M, 3]``: the mean over
    ``xyz2`` of ``exp(-d^2 / (2 h^2)) / (2.5 h)`` (utils/util.py:172-182)."""
    from cmflow_tpu_torch.ops.pointops import square_distance

    g = torch.exp(-square_distance(xyz1, xyz2)
                  / (2.0 * bandwidth * bandwidth)) / (2.5 * bandwidth)
    return torch.mean(g, dim=-1)
