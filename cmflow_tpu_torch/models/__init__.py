"""Model registry.  Counterpart of ``cmflow_tpu/models/__init__.py``."""

from __future__ import annotations

import torch

from cmflow_tpu_torch.models.backbone import BackboneConfig, SceneFlowTrunk
from cmflow_tpu_torch.models.cmflow import CMFlow
from cmflow_tpu_torch.nn.blocks import init_parameters
from cmflow_tpu_torch.utils.device import DeviceLike, resolve_device

_NOT_PORTED = {
    "raflow": "RaFlow is not ported yet (ROADMAP Queue 1)",
    "cmflow_t": "CMFlow_T is not ported yet (ROADMAP Queue 1)",
}


def build_model(name: str, device: DeviceLike = None, seed: int = 0,
                stat_thres: float = 0.5) -> torch.nn.Module:
    """Build a model by registry name, its weights drawn from a
    ``torch.Generator`` seeded with ``seed``, in eval mode on ``device``
    (``None`` is the GPU; pass ``"cpu"`` for the CPU).  ``stat_thres`` is
    CMFlow's static-probability threshold (the config's ``stat_thres``)."""
    name = name.lower()
    if name in _NOT_PORTED:
        raise NotImplementedError(_NOT_PORTED[name])
    if name != "cmflow":
        raise KeyError(f"unknown model {name!r}; have ['cmflow']")
    dev = resolve_device(device)
    model = CMFlow(stat_thres=stat_thres)
    init_parameters(model, torch.Generator().manual_seed(seed))
    return model.to(dev).eval()


__all__ = ["BackboneConfig", "SceneFlowTrunk", "CMFlow", "build_model"]
