"""CMFlow — per-pair cross-modal radar scene-flow model.

Counterpart of ``cmflow_tpu/models/cmflow.py``: trunk, flow and motion
heads, the ego-motion weighted Kabsch and the rigid refinement of static
points (reference cmflow.py:96-197).
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
    MotionHead,
    masked_global_max,
)
from cmflow_tpu_torch.parallel.mesh import Group

Tensor = torch.Tensor


class CMFlow(nn.Module):
    """``forward(pc1, pc2, ft1, ft2, label_m, train, valid1, valid2) ->
    (sf_agg, stat_cls, pre_trans, mask)``.  ``dtype``: the compute dtype,
    ``None`` (float32) or ``torch.bfloat16`` (``nn/blocks.py``); the
    outputs are float32 in either.  ``group``: the BatchNorms' process
    group, the JAX model's ``axis_name`` (``None`` for one process).
    ``remat``: False, True or ``"dots"`` (``nn/blocks.py::remat_call``)."""

    def __init__(self, stat_thres: float = 0.5,
                 cfg: BackboneConfig = BackboneConfig(), feat_ch: int = 3,
                 dtype: Optional[torch.dtype] = None, group: Group = None,
                 remat=False):
        super().__init__()
        self.stat_thres = stat_thres
        self.cfg = cfg
        self.dtype = dtype
        self.trunk = SceneFlowTrunk(cfg, feat_ch, dtype, group, remat)
        self.fp = FlowHead(cfg.head_inch, cfg.head_mlp, dtype, group)
        self.mp = MotionHead(cfg.head_inch, cfg.head_mlp, dtype, group)

    def forward(self, pc1: Tensor, pc2: Tensor, feature1: Tensor,
                feature2: Tensor, label_m: Optional[Tensor], train: bool,
                valid1: Optional[Tensor] = None,
                valid2: Optional[Tensor] = None
                ) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
        prop = self.trunk(pc1, pc2, feature1, feature2, train, valid1, valid2)
        final = concat_global(prop, masked_global_max(prop, valid1))
        output = self.fp(final, train)  # [B, N, 3] initial flow
        stat_cls = self.mp(final, train)  # [B, N] static probability

        # training takes the pseudo motion label for the ego-motion head,
        # inference the predicted probabilities (cmflow.py:180-185)
        scores = label_m if train and label_m is not None else stat_cls
        mask = scores > self.stat_thres
        if valid1 is not None:
            mask = mask & valid1

        # ego-motion head: scores to normalised weights, then weighted
        # Kabsch on (pc1 -> pc1 + flow), cmflow.py:96-110
        w = scores + 1e-4
        if valid1 is not None:
            w = w * valid1
        w = w / w.sum(dim=1, keepdim=True)
        pre_trans = se3.weighted_kabsch(pc1, pc1 + output, w,
                                        centroid="sum", reflect="row")

        # static points take the rigid flow (cmflow.py:112-125)
        sf_rg = se3.rigid_to_flow(pc1, pre_trans)
        sf_agg = torch.where(mask[..., None], sf_rg, output)
        return sf_agg, stat_cls, pre_trans, mask
