"""SE(3) geometry: batched weighted Kabsch, rigid flow, transforms.

Counterpart of ``cmflow_tpu/geometry/se3.py`` (forward only).  One function
covers the reference's three Kabsch variants through its ``centroid`` and
``reflect`` modes; see :func:`weighted_kabsch`.  The 3x3 SVDs and
determinants go to ``torch.linalg``.
"""

from __future__ import annotations

from typing import Optional

import torch

Tensor = torch.Tensor


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
        rotation is taken from the polar factor wherever that factor is
        orthogonal to 1e-2, as the JAX package does.
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
        u, _, vh = torch.linalg.svd(h)
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
            # value from the polar factor, which is accurate where the SVD
            # may not be, unless H is (near) singular and the Newton
            # iterate is not orthogonal
            rp = polar3(h).transpose(-1, -2)
            if reflect == "row":
                hflip = torch.where(torch.linalg.det(h) < 0, -1.0, 1.0)
                rp = _flip_row2(rp, hflip.to(a.dtype))
            eye = torch.eye(3, dtype=rp.dtype, device=rp.device)
            orth_err = torch.amax(
                (rp.transpose(-1, -2) @ rp - eye).abs(), dim=(-2, -1))
            r = torch.where((orth_err < 1e-2)[:, None, None], rp, r)
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
