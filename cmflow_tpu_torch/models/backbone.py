"""Shared scene-flow trunk: multi-scale encoder, cost volume, propagation
encoder.  Counterpart of ``cmflow_tpu/models/backbone.py``.

The widths are the reference's (cmflow.py:21-48): radii (2, 4, 8, 16),
nsamples (4, 8, 16, 32), sa mlp (32, 32, 64) + mlp2 (64, 64, 64), so a
per-cloud local feature of 256 and 512 with the global max; cost volume 512;
propagation mlp (512, 256, 64) + mlp2 (64, 64, 64), so 256 (+256 global).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch
from torch import nn

from cmflow_tpu_torch.nn.blocks import (
    FeatureCorrelator,
    MultiScaleEncoder,
    masked_global_max,
    remat_call,
)
from cmflow_tpu_torch.parallel.mesh import Group

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class BackboneConfig:
    sa_radii: Sequence[float] = (2.0, 4.0, 8.0, 16.0)
    sa_nsamples: Sequence[int] = (4, 8, 16, 32)
    sa_mlp: Sequence[int] = (32, 32, 64)
    sa_mlp2: Sequence[int] = (64, 64, 64)
    fc_nsample: int = 8

    @property
    def fc_inch(self) -> int:
        # num_sas * sa_mlp2[-1] * 2 (local + global), cmflow.py:30
        return len(self.sa_radii) * self.sa_mlp2[-1] * 2

    @property
    def fc_mlp(self) -> Sequence[int]:
        return (self.fc_inch, self.fc_inch, self.fc_inch)

    @property
    def ep_mlp(self) -> Sequence[int]:
        f = self.fc_inch
        return (f, f // 2, f // 8)

    @property
    def ep_mlp2(self) -> Sequence[int]:
        f = self.fc_inch // 8
        return (f, f, f)

    @property
    def prop_width(self) -> int:
        return len(self.sa_radii) * self.ep_mlp2[-1]

    @property
    def head_inch(self) -> int:
        return self.prop_width * 2

    @property
    def head_mlp(self) -> Sequence[int]:
        s = self.head_inch
        return (s // 2, s // 4, s // 8)


class SceneFlowTrunk(nn.Module):
    """Encoder + cost volume + flow-embedding propagation.  Returns
    ``prop_features [B, N, prop_width]``, before the global concat.
    ``dtype`` is the blocks' compute dtype (``nn/blocks.py``): in bf16 the
    features come out float32 in train mode and bf16 in eval.  ``group``:
    the BatchNorms' process group (``None`` for one process).  ``remat``
    (False, True or ``"dots"``): each encoder branch and the cost volume
    run under :func:`cmflow_tpu_torch.nn.blocks.remat_call`, as the JAX
    trunk wraps them."""

    def __init__(self, cfg: BackboneConfig = BackboneConfig(),
                 feat_ch: int = 3, dtype: Optional[torch.dtype] = None,
                 group: Group = None, remat=False):
        super().__init__()
        self.cfg = cfg
        self.remat = remat
        # one encoder for both frames, like the reference's single mse_layer
        self.mse_layer = MultiScaleEncoder(
            cfg.sa_radii, cfg.sa_nsamples, feat_ch, cfg.sa_mlp, cfg.sa_mlp2,
            dtype=dtype, group=group, remat=remat)
        self.fc_layer = FeatureCorrelator(
            cfg.fc_nsample, cfg.fc_inch, cfg.fc_inch, cfg.fc_mlp, dtype=dtype)
        self.mse_layer2 = MultiScaleEncoder(
            cfg.sa_radii, cfg.sa_nsamples,
            feat_ch + cfg.fc_inch + cfg.fc_mlp[-1], cfg.ep_mlp, cfg.ep_mlp2,
            dtype=dtype, group=group, remat=remat)

    def forward(self, pc1: Tensor, pc2: Tensor, feature1: Tensor,
                feature2: Tensor, train: bool,
                valid1: Optional[Tensor] = None,
                valid2: Optional[Tensor] = None) -> Tensor:
        pc1_feat = self.mse_layer(pc1, feature1, train, valid1)
        pc2_feat = self.mse_layer(pc2, feature2, train, valid2)
        pc1_feat = concat_global(pc1_feat, masked_global_max(pc1_feat, valid1))
        pc2_feat = concat_global(pc2_feat, masked_global_max(pc2_feat, valid2))
        cor = remat_call(self.remat, self.fc_layer, pc1, pc2, pc1_feat,
                         pc2_feat, train, valid1, valid2)
        embeddings = torch.cat([feature1, pc1_feat, cor], dim=-1)
        return self.mse_layer2(pc1, embeddings, train, valid1)


def concat_global(prop: Tensor, gfeat: Tensor) -> Tensor:
    """Tile a global feature ``[B, C']`` onto per-point features and concat."""
    b, n, _ = prop.shape
    return torch.cat([prop, gfeat[:, None].expand(b, n, gfeat.shape[-1])],
                     dim=-1)
