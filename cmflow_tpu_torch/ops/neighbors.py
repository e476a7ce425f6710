"""Neighbour search: multi-radius ball query and exact kNN.

Each function is a wrapper around a CUDA kernel (``csrc/neighbors.cu``) with
its plain PyTorch version beside it.  The ball query and the kNN for
k <= 64 stage the cloud through shared memory in tiles of 2048 points; the
kNN for larger k keeps a query's distances there (up to 16,384 points, then
computes them again each pass), so a cloud may have any size, and any
number of radii and any k up to N are taken.  A CUDA tensor goes to the
kernel; a CPU tensor goes to the plain version.
Both compute squared distances in the same
float32 operation order as the JAX package (``cross = (x*x' + y*y') + z*z'``,
``d = max((-2*cross + q2) + p2, 0)``), so their neighbour indices are
bit-identical to each other and to ``cmflow_tpu.ops.pointops``.

Counterpart of ``cmflow_tpu/ops/neighbors.py`` (``ball_query_multi``,
``knn_pallas``) and of the XLA references ``pointops._ball_query_xla`` and
``pointops._knn_xla``.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from cmflow_tpu_torch.native import build

Tensor = torch.Tensor

# A finite "infinity" for masked squared distances (pointops._BIG).
BIG = 1e10
# radii the ball-query kernel fills in one scan: more go to one launch per
# group of this many
MAX_RADII = 4
# the largest k of the kNN kernel's warp per query; above it a block per
# query selects the k nearest (``csrc/neighbors.cu::knn_select_kernel``)
MAX_K = 64

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "cmflow_ball_query": (_P, _P, _P, _I, _I, _I, _I,
                          ctypes.POINTER(ctypes.c_float),
                          ctypes.POINTER(ctypes.c_int),
                          ctypes.POINTER(ctypes.c_void_p), _P),
    "cmflow_knn": (_P, _P, _P, _I, _I, _I, _I, _P, _P),
}


def square_distance(src: Tensor, dst: Tensor) -> Tensor:
    """Pairwise squared distance ``[B,N,C] x [B,M,C] -> [B,N,M]``, clamped at
    zero, each product and sum a tensor operation of its own (no reduction,
    ``cdist`` or matmul, whose summation order differs)."""
    cross = src[:, :, None, 0] * dst[:, None, :, 0]
    s2 = src[..., 0:1] * src[..., 0:1]
    d2 = dst[:, None, :, 0] * dst[:, None, :, 0]
    for c in range(1, src.shape[-1]):
        cross = cross + src[:, :, None, c] * dst[:, None, :, c]
        s2 = s2 + src[..., c:c + 1] * src[..., c:c + 1]
        d2 = d2 + dst[:, None, :, c] * dst[:, None, :, c]
    return torch.clamp_min((-2.0 * cross + s2) + d2, 0.0)


def masked_square_distance(src: Tensor, dst: Tensor,
                           dst_valid: Optional[Tensor]) -> Tensor:
    """``square_distance`` with invalid destination points pushed to BIG."""
    d = square_distance(src, dst)
    if dst_valid is not None:
        d = torch.where(dst_valid[:, None, :], d, BIG)
    return d


def radius_sq(radius: float) -> float:
    """``r*r`` rounded to float32, as ``jnp.float32(r) ** 2`` gives it."""
    r = np.float32(radius)
    return float(r * r)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def ball_query_multi_plain(radii: Sequence[float], nsamples: Sequence[int],
                           points: Tensor, query: Tensor,
                           points_valid: Optional[Tensor] = None
                           ) -> Tuple[Tensor, ...]:
    """Plain version of :func:`ball_query_multi` (``_ball_query_xla`` per
    radius): the ``K`` smallest hit indices, by sorting keys that are the
    index for a hit and ``N`` otherwise."""
    n = points.shape[1]
    d = square_distance(query, points)
    j = torch.arange(n, device=points.device)
    outs = []
    for r, k in zip(radii, nsamples):
        hit = d < radius_sq(r)
        if points_valid is not None:
            hit = hit & points_valid[:, None, :]
        key = torch.where(hit, j, n)
        idx = torch.sort(key, dim=-1).values[..., :min(k, n)]
        if k > n:  # more slots than points: the extra slots are padding
            idx = torch.cat([idx, idx.new_full(idx.shape[:-1] + (k - n,), n)],
                            dim=-1)
        first = idx[..., :1]
        pad = torch.where(first < n, first, 0)  # first hit, or 0 if none
        outs.append(torch.where(idx < n, idx, pad).to(torch.int32))
    return tuple(outs)


def knn_plain(k: int, query: Tensor, points: Tensor,
              points_valid: Optional[Tensor] = None) -> Tensor:
    """Plain version of :func:`knn`: a stable sort of the masked distance
    row, so equal distances keep the lower index (``lax.top_k``)."""
    d = masked_square_distance(query, points, points_valid)
    return torch.sort(d, dim=-1, stable=True).indices[..., :k].to(torch.int32)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _check_cloud(points: Tensor, query: Tensor,
                 points_valid: Optional[Tensor]) -> None:
    if points.dim() != 3 or points.shape[-1] != 3:
        raise ValueError(f"points must be [B, N, 3], got {tuple(points.shape)}")
    if (query.dim() != 3 or query.shape[-1] != 3
            or query.shape[0] != points.shape[0]):
        raise ValueError(f"query must be [B, S, 3] with the batch of points, "
                         f"got {tuple(query.shape)}")
    if points.dtype != torch.float32 or query.dtype != torch.float32:
        raise TypeError("points and query must be float32")
    if points_valid is not None:
        if points_valid.dtype != torch.bool:
            raise TypeError("points_valid must be bool")
        if points_valid.shape != points.shape[:2]:
            raise ValueError(f"points_valid must be [B, N], got "
                             f"{tuple(points_valid.shape)}")
    tensors = [points, query] + ([] if points_valid is None else [points_valid])
    if any(t.device != points.device for t in tensors):
        raise ValueError("points, query and points_valid must share a device")
    if points.device.type == "cuda":
        if not all(t.is_contiguous() for t in tensors):
            raise ValueError("the CUDA kernels take contiguous tensors")
    elif points.device.type != "cpu":
        raise ValueError(f"unsupported device {points.device}")


def _ptr(t: Optional[Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def ball_query_multi(radii: Sequence[float], nsamples: Sequence[int],
                     points: Tensor, query: Tensor,
                     points_valid: Optional[Tensor] = None
                     ) -> Tuple[Tensor, ...]:
    """Multi-radius ball query: for each query and radius ``r_s``, the first
    ``K_s`` point indices in index order with ``d^2 < r_s^2``.  Empty slots
    repeat the first hit; an empty ball gives all zeros; invalid points are
    never hits.

    Args:
      radii / nsamples: one or more (radius, K) pairs.  Up to MAX_RADII of
        them are one launch; more are one launch per group of MAX_RADII.
      points: ``[B, N, 3]`` float32 searched cloud.
      query: ``[B, S, 3]`` float32 ball centres.
      points_valid: optional ``[B, N]`` bool.
    Returns:
      one ``[B, S, K_s]`` int32 tensor per radius.
    """
    if len(radii) != len(nsamples) or not radii:
        raise ValueError(f"need one or more (radius, K) pairs, got "
                         f"{len(radii)} radii and {len(nsamples)} Ks")
    if any(k < 1 for k in nsamples):
        raise ValueError(f"every K must be positive, got {nsamples}")
    _check_cloud(points, query, points_valid)
    if points.device.type == "cpu":
        return ball_query_multi_plain(radii, nsamples, points, query,
                                      points_valid)
    b, n, _ = points.shape
    s = query.shape[1]
    outs = tuple(torch.empty((b, s, k), dtype=torch.int32,
                             device=points.device) for k in nsamples)
    lib = build.load("neighbors", _SIGNATURES)
    for g in range(0, len(radii), MAX_RADII):
        group = range(g, min(g + MAX_RADII, len(radii)))
        count = len(group)
        code = lib.cmflow_ball_query(
            points.data_ptr(), query.data_ptr(), _ptr(points_valid), b, n, s,
            count,
            (ctypes.c_float * count)(*[radius_sq(radii[i]) for i in group]),
            (ctypes.c_int * count)(*[nsamples[i] for i in group]),
            (ctypes.c_void_p * count)(*[outs[i].data_ptr() for i in group]),
            torch.cuda.current_stream(points.device).cuda_stream)
        build.check(lib, code, "ball_query_multi")
        ball_query_multi.launches += 1
    return outs


ball_query_multi.launches = 0


def knn(k: int, query: Tensor, points: Tensor,
        points_valid: Optional[Tensor] = None) -> Tensor:
    """Exact k nearest neighbours: ``[B, S, k]`` int32 indices into
    ``points``, ascending squared distance, ties to the lower index; invalid
    points sit at distance BIG (so they come last, in index order).  Any
    ``1 <= k <= N``: up to MAX_K a warp per query, above a block per
    query."""
    _check_cloud(points, query, points_valid)
    n = points.shape[1]
    if not 1 <= k <= n:
        raise ValueError(f"k must be in [1, N], got k={k}, N={n}")
    if points.device.type == "cpu":
        return knn_plain(k, query, points, points_valid)
    b = points.shape[0]
    s = query.shape[1]
    out = torch.empty((b, s, k), dtype=torch.int32, device=points.device)
    lib = build.load("neighbors", _SIGNATURES)
    code = lib.cmflow_knn(
        points.data_ptr(), query.data_ptr(), _ptr(points_valid), b, n, s, k,
        out.data_ptr(), torch.cuda.current_stream(points.device).cuda_stream)
    build.check(lib, code, "knn")
    knn.launches += 1
    return out


knn.launches = 0
