"""General-purpose PointNet++ modules: set abstraction and feature
propagation.

Counterpart of ``cmflow_tpu/nn/extras.py`` (the reference's
lib/pointnet2_modules.py PointnetSAModule and PointnetFPModule, vendored in
its op library though not on the model path).  flax infers a layer's input
width; these modules take it as ``in_ch``.  The shared MLP is ``mlp``, a
:class:`PointwiseMLP`, so ``models/convert.py`` fills it from the JAX
modules' variables.  ``group``: the BatchNorms' process group, the JAX
modules' ``axis_name``.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from cmflow_tpu_torch.nn.blocks import PointwiseMLP
from cmflow_tpu_torch.ops import pointops
from cmflow_tpu_torch.parallel.mesh import Group

Tensor = torch.Tensor


class SetAbstraction(nn.Module):
    """Farthest-point sampling, ball-query grouping, shared MLP, max over the
    neighbours (PointnetSAModule).  ``npoint=None`` groups all points into
    one region around the origin (GroupAll, lib/pointnet2_utils.py:295-318),
    with absolute coordinates and ``new_xyz`` zeros.

    ``in_ch``: the channels of the ``features`` the forward takes, 0 when it
    takes none.  The MLP's input is the neighbours' offsets (with
    ``use_xyz``; in group-all their coordinates) and their features; with
    ``use_xyz=False`` the features alone, or the offsets where there are no
    features."""

    def __init__(self, npoint: Optional[int], radius: Optional[float],
                 nsample: Optional[int], in_ch: int, mlp: Sequence[int],
                 use_xyz: bool = True, group: Group = None):
        super().__init__()
        self.npoint = npoint
        self.radius = radius
        self.nsample = nsample
        self.in_ch = in_ch
        self.use_xyz = use_xyz
        if npoint is None:
            width = 3 * use_xyz + in_ch
        elif use_xyz:
            width = 3 + in_ch
        else:
            width = in_ch or 3
        if width == 0:
            raise ValueError("group-all without xyz needs features")
        self.mlp = PointwiseMLP(width, mlp, group=group)

    def forward(self, xyz: Tensor, features: Optional[Tensor],
                train: bool = False) -> Tuple[Tensor, Tensor]:
        """``xyz [B, N, 3]``, ``features [B, N, in_ch]`` or None ->
        ``(new_xyz [B, S, 3], new_features [B, S, mlp[-1]])``."""
        if (features.shape[-1] if features is not None else 0) != self.in_ch:
            raise ValueError(f"features must have {self.in_ch} channels")
        if self.npoint is not None:
            idx = pointops.farthest_point_sample(xyz, self.npoint)
            new_xyz = pointops.gather_points(xyz, idx)
            if self.use_xyz or features is None:
                grouped = pointops.query_and_group(
                    self.radius, self.nsample, xyz, new_xyz,
                    features if self.use_xyz else None)
            else:
                # the features alone: one ball query, its rows gathered
                gidx = pointops.ball_query(self.radius, self.nsample, xyz,
                                           new_xyz)
                grouped = pointops.group_points(features, gidx)
        else:
            new_xyz = torch.zeros((xyz.shape[0], 1, 3), dtype=xyz.dtype,
                                  device=xyz.device)
            parts = ([xyz] if self.use_xyz else []) + (
                [features] if features is not None else [])
            grouped = torch.cat(parts, dim=-1)[:, None]  # [B, 1, N, C]
        h = self.mlp(grouped, train)
        return new_xyz, torch.amax(h, dim=2)


class FeaturePropagation(nn.Module):
    """Inverse-distance interpolation from the three nearest known points,
    the skip features concatenated, then a shared MLP (PointnetFPModule).
    It needs at least three known points, as the JAX module does.

    ``in_ch``: the channels of ``known_feats`` plus those of
    ``unknown_feats`` (0 when the forward takes none)."""

    def __init__(self, in_ch: int, mlp: Sequence[int], group: Group = None):
        super().__init__()
        self.mlp = PointwiseMLP(in_ch, mlp, group=group)

    def forward(self, unknown: Tensor, known: Tensor,
                unknown_feats: Optional[Tensor], known_feats: Tensor,
                train: bool = False) -> Tensor:
        """Propagate ``known_feats [B, M, C]`` at ``known [B, M, 3]`` onto
        ``unknown [B, N, 3]``: ``[B, N, mlp[-1]]``."""
        dists, idx = pointops.three_nn(unknown, known)
        w = pointops.interpolation_weights(dists)
        interp = pointops.three_interpolate(known_feats, idx, w)
        if unknown_feats is not None:
            interp = torch.cat([interp, unknown_feats], dim=-1)
        return self.mlp(interp, train)
