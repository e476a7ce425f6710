"""CMFlow_T — temporal CMFlow with a GRU over the global feature.

Counterpart of ``cmflow_tpu/models/cmflow_t.py``.  The recurrent state is
one ``[B, prop_width]`` vector carried across frames; the module takes one
frame step (reference cmflow_t.py:185-211), and the loop over frames lives
in the train and eval steps (``train/steps.py``).  The GRU is flax's
(:class:`cmflow_tpu_torch.nn.blocks.GRUCell`), whose parameters
``convert.py`` carries across.
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
from cmflow_tpu_torch.nn.blocks import (
    FlowHead,
    GRUCell,
    MotionHead,
    masked_global_max,
)
from cmflow_tpu_torch.parallel.mesh import Group

Tensor = torch.Tensor


def temporal_ego_motion(pc1: Tensor, output: Tensor, scores: Tensor,
                        valid1: Optional[Tensor], stat_thres: float,
                        solver: str = "svd") -> Tuple[Tensor, Tensor, Tensor]:
    """CMFlow_T's ego-motion head and rigid refinement: the static mask, a
    Kabsch weighted by the raw scores normalised to sum 1, with no 1e-4
    floor (cmflow_t.py:118-120, unlike CMFlow), and the rigid flow on static
    points.  Returns ``(sf_agg, pre_trans, mask)``."""
    mask = scores > stat_thres
    w = scores
    if valid1 is not None:
        mask = mask & valid1
        w = w * valid1
    w = w / torch.clamp_min(w.sum(dim=1, keepdim=True), 1e-12)
    pre_trans = se3.weighted_kabsch(pc1, pc1 + output, w, centroid="sum",
                                    reflect="row", solver=solver)
    sf_rg = se3.rigid_to_flow(pc1, pre_trans)
    sf_agg = torch.where(mask[..., None], sf_rg, output)
    return sf_agg, pre_trans, mask


class CMFlowT(nn.Module):
    """``forward(pc1, pc2, ft1, ft2, label_m, train, gfeat, valid1, valid2)
    -> (sf_agg, stat_cls, pre_trans, mask, gfeat_new)``.

    ``gfeat`` is the previous GRU state ``[B, prop_width]``: zeros at a clip
    start (the reference's ``None`` also becomes zeros, cmflow_t.py:97-98).
    ``stat_thres`` is 0.5, hardcoded in the reference (cmflow_t.py:18).
    ``dtype``: the compute dtype of the trunk and heads, as
    :class:`cmflow_tpu_torch.models.cmflow.CMFlow`'s; the GRU has none in
    the JAX package and computes in float32 (its carry stays float32).
    ``group``: the BatchNorms' process group, and ``remat`` the
    recomputation mode, as CMFlow's."""

    def __init__(self, cfg: BackboneConfig = BackboneConfig(),
                 feat_ch: int = 3, dtype: Optional[torch.dtype] = None,
                 group: Group = None, remat=False):
        super().__init__()
        self.stat_thres = 0.5
        self.cfg = cfg
        self.dtype = dtype
        self.trunk = SceneFlowTrunk(cfg, feat_ch, dtype, group, remat)
        self.gru = GRUCell(cfg.prop_width)
        self.fp = FlowHead(cfg.head_inch, cfg.head_mlp, dtype, group)
        self.mp = MotionHead(cfg.head_inch, cfg.head_mlp, dtype, group)

    def forward(self, pc1: Tensor, pc2: Tensor, feature1: Tensor,
                feature2: Tensor, label_m: Optional[Tensor], train: bool,
                gfeat: Tensor, valid1: Optional[Tensor] = None,
                valid2: Optional[Tensor] = None
                ) -> Tuple[Tensor, Tensor, Tensor, Tensor, Tensor]:
        prop = self.trunk(pc1, pc2, feature1, feature2, train, valid1, valid2)
        # the GRU over the pooled global feature (cmflow_t.py:94-107)
        gfeat_new = self.gru(gfeat, masked_global_max(prop, valid1).float())
        final = concat_global(prop, gfeat_new)
        output = self.fp(final, train)
        stat_cls = self.mp(final, train)
        scores = label_m if train and label_m is not None else stat_cls
        sf_agg, pre_trans, mask = temporal_ego_motion(
            pc1, output, scores, valid1, self.stat_thres)
        return sf_agg, stat_cls, pre_trans, mask, gfeat_new
