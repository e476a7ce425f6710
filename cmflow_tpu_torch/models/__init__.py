"""Model registry.  Counterpart of ``cmflow_tpu/models/__init__.py``."""

from __future__ import annotations

import torch

from cmflow_tpu_torch.models.backbone import BackboneConfig, SceneFlowTrunk
from cmflow_tpu_torch.models.cmflow import CMFlow
from cmflow_tpu_torch.models.cmflow_t import CMFlowT
from cmflow_tpu_torch.models.raflow import RaFlow
from cmflow_tpu_torch.nn.blocks import init_parameters
from cmflow_tpu_torch.utils.device import DeviceLike, resolve_device

MODEL_REGISTRY = {"raflow": RaFlow, "cmflow": CMFlow, "cmflow_t": CMFlowT}


def build_model(name: str, device: DeviceLike = None, seed: int = 0,
                stat_thres: float = 0.5,
                rigid_thres: float = 0.15) -> torch.nn.Module:
    """Build a model by registry name, its weights drawn from a
    ``torch.Generator`` seeded with ``seed``, in eval mode on ``device``
    (``None`` is the GPU; pass ``"cpu"`` for the CPU).  ``stat_thres`` is
    CMFlow's static-probability threshold and ``rigid_thres`` RaFlow's
    Doppler-residual threshold (the config's keys); CMFlow_T keeps the
    reference's hardcoded 0.5."""
    name = name.lower()
    if name not in MODEL_REGISTRY:
        raise KeyError(f"unknown model {name!r}; have {list(MODEL_REGISTRY)}")
    dev = resolve_device(device)
    kwargs = {"raflow": dict(rigid_thres=rigid_thres),
              "cmflow": dict(stat_thres=stat_thres)}.get(name, {})
    model = MODEL_REGISTRY[name](**kwargs)
    init_parameters(model, torch.Generator().manual_seed(seed))
    return model.to(dev).eval()


__all__ = ["BackboneConfig", "SceneFlowTrunk", "CMFlow", "CMFlowT", "RaFlow",
           "MODEL_REGISTRY", "build_model"]
