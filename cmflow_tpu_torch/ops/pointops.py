"""Point-cloud primitive ops, channels-last ``[B, N, C]``.

Counterpart of ``cmflow_tpu/ops/pointops.py``.  Neighbour searches go
through :mod:`cmflow_tpu_torch.ops.neighbors`, gathers through
:mod:`cmflow_tpu_torch.ops.fused` and farthest-point sampling through
:mod:`cmflow_tpu_torch.ops.sampling`, whose wrappers launch the CUDA kernels
on CUDA tensors and run the plain PyTorch versions on CPU tensors.  Gathers
are differentiable in the points, as the JAX package's ``mxu_group_points``:
forward K6 (``gather_rows``), backward K7 (``gather_rows_backward``), each in
the points' dtype, float32 or bfloat16 (a bf16 gather gets a bf16 cotangent
and returns a bf16 gradient, summed in float32).  An
optional boolean ``valid`` mask marks real (non-padding) points; padded
points are excluded from every neighbourhood.

The ball query, kNN and the gather's forward are also registered as
``torch.library`` custom ops (``cmflow::ball_query``, ``cmflow::knn``,
``cmflow::gather_rows``): PyTorch's selective checkpointing decides by op
what it saves, and sees a kernel launched through ``ctypes`` only as such an
op (``remat: dots``, :mod:`cmflow_tpu_torch.nn.blocks`).  The wrappers go
through them only inside :func:`custom_ops`, which ``remat: dots`` enters:
a custom op's dispatch doubles a wrapper call's host time (about 30 µs more
a call on an H100's host, ``scripts/host_cost_torch.py``), and the train
step is bound by its host.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Iterator, Optional, Tuple

import torch

from cmflow_tpu_torch.ops import neighbors
from cmflow_tpu_torch.ops.fused import gather_rows, gather_rows_backward
from cmflow_tpu_torch.ops.neighbors import (  # noqa: F401  (re-exported)
    BIG,
    masked_square_distance,
    square_distance,
)
from cmflow_tpu_torch.ops.sampling import (  # noqa: F401  (re-exported)
    farthest_point_sample,
)

Tensor = torch.Tensor


# set on a thread while it runs inside custom_ops()
_dispatch = threading.local()


@contextlib.contextmanager
def custom_ops() -> Iterator[None]:
    """Within this context, on this thread, the ball query, kNN and the
    gather run as the custom ops above."""
    before = getattr(_dispatch, "on", False)
    _dispatch.on = True
    try:
        yield
    finally:
        _dispatch.on = before


def _as_ops() -> bool:
    return getattr(_dispatch, "on", False)


@torch.library.custom_op("cmflow::ball_query", mutates_args=())
def _ball_query_op(radius: float, nsample: int, points: Tensor, query: Tensor,
                   points_valid: Optional[Tensor]) -> Tensor:
    (idx,) = neighbors.ball_query_multi((radius,), (nsample,), points, query,
                                        points_valid)
    return idx


@torch.library.custom_op("cmflow::knn", mutates_args=())
def _knn_op(k: int, query: Tensor, points: Tensor,
            points_valid: Optional[Tensor]) -> Tensor:
    return neighbors.knn(k, query, points, points_valid)


@torch.library.custom_op("cmflow::gather_rows", mutates_args=())
def _gather_rows_op(points: Tensor, idx: Tensor) -> Tensor:
    return gather_rows(points, idx)


def knn(k: int, query: Tensor, points: Tensor,
        points_valid: Optional[Tensor] = None) -> Tensor:
    """Indices ``[B, S, k]`` (int32) of the k nearest ``points`` of each
    ``query``, ascending distance, ties to the lower index."""
    if _as_ops():
        return _knn_op(k, query, points, points_valid)
    return neighbors.knn(k, query, points, points_valid)


def knn_with_dists(k: int, query: Tensor, points: Tensor,
                   points_valid: Optional[Tensor] = None
                   ) -> Tuple[Tensor, Tensor]:
    """Like :func:`knn`, also returning the squared distances (ascending)."""
    d = masked_square_distance(query, points, points_valid)
    dist, idx = torch.sort(d, dim=-1, stable=True)
    return dist[..., :k], idx[..., :k].to(torch.int32)


def ball_query(radius: float, nsample: int, points: Tensor, query: Tensor,
               points_valid: Optional[Tensor] = None) -> Tensor:
    """First ``nsample`` point indices (ascending) with squared distance
    strictly below ``radius**2``; empty slots repeat the first hit, and a
    query with no hit gets all zeros.  ``[B, S, nsample]`` int32.

    One radius per call, like the JAX package's per-scale calls."""
    if _as_ops():
        return _ball_query_op(float(radius), int(nsample), points, query,
                              points_valid)
    (idx,) = neighbors.ball_query_multi((radius,), (nsample,), points, query,
                                        points_valid)
    return idx


class _GatherRows(torch.autograd.Function):
    """``gather_rows`` with ``gather_rows_backward`` as its backward, both in
    the points' dtype; the indices take no gradient."""

    @staticmethod
    def forward(ctx, points: Tensor, idx: Tensor) -> Tensor:
        ctx.save_for_backward(idx)
        ctx.n = points.shape[1]
        if _as_ops():
            return _gather_rows_op(points, idx)
        return gather_rows(points, idx)

    @staticmethod
    def backward(ctx, grad: Tensor):
        if not ctx.needs_input_grad[0]:
            return None, None
        (idx,) = ctx.saved_tensors
        # autograd may hand over a stride-0 expanded cotangent (the
        # gradient of a sum); the kernel reads contiguous rows
        return gather_rows_backward(grad.contiguous(), idx, ctx.n), None


def group_points(points: Tensor, idx: Tensor) -> Tensor:
    """Gather per-neighbourhood features: ``[B, N, C]`` by ``[B, S, K]``
    int32 -> ``[B, S, K, C]``."""
    b, s, k = idx.shape
    flat = _GatherRows.apply(points, idx.reshape(b, s * k))
    return flat.reshape(b, s, k, points.shape[2])


def gather_points(points: Tensor, idx: Tensor) -> Tensor:
    """Gather points by index: ``[B, N, C]`` by ``[B, S]`` int32 ->
    ``[B, S, C]``."""
    return _GatherRows.apply(points, idx)


def query_and_group(radius: float, nsample: int, xyz: Tensor,
                    new_xyz: Tensor, features: Optional[Tensor] = None,
                    xyz_valid: Optional[Tensor] = None) -> Tensor:
    """Ball query around the centroids ``new_xyz`` ``[B, S, 3]`` in ``xyz``
    ``[B, N, 3]``, then each neighbour's offset from its centroid and,
    given ``features`` ``[B, N, C]``, its features:
    ``[B, S, nsample, 3 (+ C)]`` (QueryAndGroup,
    lib/pointnet2_utils.py:259-292)."""
    idx = ball_query(radius, nsample, xyz, new_xyz, xyz_valid)
    grouped_xyz = group_points(xyz, idx) - new_xyz[:, :, None, :]
    if features is None:
        return grouped_xyz
    return torch.cat([grouped_xyz, group_points(features, idx)], dim=-1)


def pair_square_distance(query: Tensor, neighbours: Tensor) -> Tensor:
    """Squared distance of each query ``[B, S, 3]`` to its own neighbours
    ``[B, S, K, 3]``, ``[B, S, K]``: :func:`square_distance`'s expression,
    operation by operation, so each value has the bits of that pair's entry
    of the full matrix."""
    q = query[:, :, None, :]
    cross = q[..., 0] * neighbours[..., 0]
    s2 = q[..., 0] * q[..., 0]
    d2 = neighbours[..., 0] * neighbours[..., 0]
    for c in range(1, query.shape[-1]):
        cross = cross + q[..., c] * neighbours[..., c]
        s2 = s2 + q[..., c] * q[..., c]
        d2 = d2 + neighbours[..., c] * neighbours[..., c]
    return torch.clamp_min((-2.0 * cross + s2) + d2, 0.0)


def three_nn(query: Tensor, points: Tensor,
             points_valid: Optional[Tensor] = None) -> Tuple[Tensor, Tensor]:
    """The three nearest ``points`` of each ``query`` (interpolate_gpu.cu
    three_nn): ``(dists [B, S, 3]`` Euclidean and ascending, ``idx [B, S,
    3]`` int32), ties to the lower index; an invalid point lies at squared
    distance BIG.

    The indices come from :func:`knn` (K2 on the card), the squared
    distances from the neighbours gathered (K6) and
    :func:`pair_square_distance`: the values ``knn_with_dists`` sorts, so
    both equal the JAX package's ``knn_with_dists(3, ...)``; the distance is
    their correctly rounded square root (:func:`sqrt_rn`), as ``jnp.sqrt``
    gives it."""
    idx = knn(3, query, points, points_valid)
    d2 = pair_square_distance(query, group_points(points, idx))
    if points_valid is not None:
        b = idx.shape[0]
        inside = torch.gather(points_valid, 1, idx.reshape(b, -1).long())
        d2 = torch.where(inside.reshape(idx.shape), d2, BIG)
    return sqrt_rn(torch.clamp_min(d2, 0.0)), idx


def sqrt_rn(x: Tensor) -> Tensor:
    """The correctly rounded square root of float32 ``x >= 0``, on any
    device.  ``torch.sqrt`` is not: on the CPU and on the card it is one
    ulp off for some values, and not for the same ones
    (``scripts/diag_three_nn_bits.py``), while XLA's, and so the JAX
    package's, is correctly rounded.  The float64 root, rounded to float32,
    lies within one ulp of the answer; the squares of the midpoints to its
    neighbours, exact in float64 (25 significant bits squared), say which
    of the three it is."""
    xd = x.double()
    s = torch.sqrt(xd).float()
    up = torch.nextafter(s, torch.full_like(s, float("inf")))
    down = torch.nextafter(s, torch.zeros_like(s))
    sd = s.double()
    mid_up = (sd + up.double()) * 0.5
    mid_down = (sd + down.double()) * 0.5
    s = torch.where(mid_up * mid_up <= xd, up, s)
    return torch.where(mid_down * mid_down > xd, down, s)


def three_interpolate(features: Tensor, idx: Tensor, weight: Tensor) -> Tensor:
    """Weighted sum of three gathered feature rows (interpolate_gpu.cu
    three_interpolate): ``features [B, N, C]``, ``idx [B, S, 3]``,
    ``weight [B, S, 3]`` -> ``[B, S, C]``."""
    grouped = group_points(features, idx)  # [B, S, 3, C]
    return torch.sum(grouped * weight[..., None], dim=2)


def interpolation_weights(dists: Tensor, eps: float = 1e-8) -> Tensor:
    """Inverse-distance weights of :func:`three_interpolate`, summing to 1
    over the last axis."""
    recip = 1.0 / (dists + eps)
    return recip / torch.sum(recip, dim=-1, keepdim=True)
