"""RaFlow — the self-supervised radar scene-flow baseline (RA-L'22).

Counterpart of ``cmflow_tpu/models/raflow.py``: the shared trunk, one flow
head, and the static-flow refinement (SFR, reference raflow.py:78-114).
The reference re-fits its Kabsch per batch element in a Python loop with a
data-dependent branch; here, as in the JAX package, both fits run batched
and ``torch.where`` picks, with no loop and no branch on the data.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from cmflow_tpu_torch.geometry import se3
from cmflow_tpu_torch.models.backbone import (
    BackboneConfig,
    SceneFlowTrunk,
    concat_global,
)
from cmflow_tpu_torch.nn.blocks import FlowHead, masked_global_max
from cmflow_tpu_torch.parallel.mesh import Group

Tensor = torch.Tensor


def static_flow_refinement(pc1: Tensor, output: Tensor, vel1: Tensor,
                           interval: Tensor, valid1: Optional[Tensor],
                           rigid_thres: float, rigid_pcs: float,
                           solver: str = "svd"
                           ) -> Tuple[Tensor, Tensor, Tensor]:
    """RaFlow's SFR on the head's flow ``output``: a Kabsch fit of all
    (valid) points, the Doppler residual's inlier mask, a re-fit on the
    inliers, taken where the inliers exceed ``rigid_pcs`` of the valid
    points.  Returns ``(sf_agg, pre_trans, mask_s)``."""
    b, n, _ = pc1.shape
    pc1_warp = pc1 + output
    if valid1 is not None:
        all_mask = valid1.to(pc1.dtype)
        n_valid = all_mask.sum(dim=1)
    else:
        all_mask = torch.ones((b, n), dtype=pc1.dtype, device=pc1.device)
        n_valid = torch.full((b,), float(n), dtype=pc1.dtype,
                             device=pc1.device)

    # the first fit takes every (valid) point as static; the reference
    # divides its centroids by its dynamic N (raflow.py:126-127), which for
    # a padded cloud is the valid count
    trans = se3.weighted_kabsch(pc1, pc1_warp, all_mask, centroid="mean_n",
                                reflect="row", n_override=n_valid,
                                solver=solver)
    sf_rg = se3.rigid_to_flow(pc1, trans)

    # static points by the Doppler residual (raflow.py:93-97): the rigid
    # flow projected radially against the measured v_r * dt.  The division
    # by v_r stays an IEEE one: v_r == 0 gives inf or nan, so False
    sf_proj = torch.sum(sf_rg * pc1, dim=-1) / torch.linalg.norm(pc1, dim=-1)
    residual = vel1 * interval[:, None] - sf_proj
    mask_s = torch.abs(residual / vel1) < rigid_thres
    if valid1 is not None:
        mask_s = mask_s & valid1

    # the re-fit on the inliers (raflow.py:99-113), batched
    refit = se3.weighted_kabsch(pc1, pc1_warp, mask_s.to(pc1.dtype),
                                centroid="mean_n", reflect="row",
                                n_override=n_valid, solver=solver)
    use_refit = mask_s.sum(dim=1) / n_valid > rigid_pcs  # [B]
    pre_trans = torch.where(use_refit[:, None, None], refit, trans)
    sf_refit = se3.rigid_to_flow(pc1, refit)
    take_rigid = use_refit[:, None] & mask_s
    sf_agg = torch.where(take_rigid[..., None], sf_refit, output)
    return sf_agg, pre_trans, mask_s


class RaFlow(nn.Module):
    """``forward(pc1, pc2, ft1, ft2, interval, train, valid1, valid2) ->
    (coarse_flow, sf_agg, pre_trans, mask_s)`` (reference raflow.py:157-164).
    Submodules ``trunk`` and ``fp`` carry the flax names.  ``dtype``: the
    compute dtype, ``group`` the BatchNorms' process group and ``remat``
    the recomputation mode, as
    :class:`cmflow_tpu_torch.models.cmflow.CMFlow`'s."""

    def __init__(self, rigid_thres: float = 0.15, rigid_pcs: float = 0.25,
                 cfg: BackboneConfig = BackboneConfig(), feat_ch: int = 3,
                 dtype: Optional[torch.dtype] = None, group: Group = None,
                 remat=False):
        super().__init__()
        self.rigid_thres = rigid_thres
        self.rigid_pcs = rigid_pcs  # least inlier share for the re-fit
        self.cfg = cfg
        self.dtype = dtype
        self.trunk = SceneFlowTrunk(cfg, feat_ch, dtype, group, remat)
        self.fp = FlowHead(cfg.head_inch, cfg.head_mlp, dtype, group)

    def forward(self, pc1: Tensor, pc2: Tensor, feature1: Tensor,
                feature2: Tensor, interval: Tensor, train: bool,
                valid1: Optional[Tensor] = None,
                valid2: Optional[Tensor] = None
                ) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
        prop = self.trunk(pc1, pc2, feature1, feature2, train, valid1, valid2)
        final = concat_global(prop, masked_global_max(prop, valid1))
        output = self.fp(final, train)
        sf_agg, pre_trans, mask_s = static_flow_refinement(
            pc1, output, feature1[..., 0], interval, valid1,
            self.rigid_thres, self.rigid_pcs)
        return output, sf_agg, pre_trans, mask_s
