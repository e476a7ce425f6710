"""Point-cloud primitive ops, channels-last ``[B, N, C]``.

Counterpart of ``cmflow_tpu/ops/pointops.py``.  Neighbour searches go
through :mod:`cmflow_tpu_torch.ops.neighbors` and gathers through
:mod:`cmflow_tpu_torch.ops.fused`, whose wrappers launch the CUDA kernels
on CUDA tensors and run the plain PyTorch versions on CPU tensors.  Gathers
are differentiable in the points, as the JAX package's ``mxu_group_points``:
forward K6 (``gather_rows``), backward K7 (``gather_rows_backward``), each in
the points' dtype, float32 or bfloat16 (a bf16 gather gets a bf16 cotangent
and returns a bf16 gradient, summed in float32).  An
optional boolean ``valid`` mask marks real (non-padding) points; padded
points are excluded from every neighbourhood.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from cmflow_tpu_torch.ops import neighbors
from cmflow_tpu_torch.ops.fused import gather_rows, gather_rows_backward
from cmflow_tpu_torch.ops.neighbors import (  # noqa: F401  (re-exported)
    masked_square_distance,
    square_distance,
)

Tensor = torch.Tensor


def knn(k: int, query: Tensor, points: Tensor,
        points_valid: Optional[Tensor] = None) -> Tensor:
    """Indices ``[B, S, k]`` (int32) of the k nearest ``points`` of each
    ``query``, ascending distance, ties to the lower index."""
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
