"""Model registry.  Counterpart of ``cmflow_tpu/models/__init__.py``."""

from __future__ import annotations

import torch

from cmflow_tpu_torch.models.backbone import BackboneConfig, SceneFlowTrunk
from cmflow_tpu_torch.models.cmflow import CMFlow
from cmflow_tpu_torch.models.cmflow_t import CMFlowT
from cmflow_tpu_torch.models.raflow import RaFlow
from cmflow_tpu_torch.nn.blocks import init_parameters
from cmflow_tpu_torch.parallel.mesh import Group
from cmflow_tpu_torch.utils.device import DeviceLike, resolve_device

MODEL_REGISTRY = {"raflow": RaFlow, "cmflow": CMFlow, "cmflow_t": CMFlowT}


COMPUTE_DTYPES = {"float32": None, "bfloat16": torch.bfloat16}


def build_model(name: str, device: DeviceLike = None, seed: int = 0,
                stat_thres: float = 0.5, rigid_thres: float = 0.15,
                compute_dtype: str = "float32",
                group: Group = None, remat=False) -> torch.nn.Module:
    """Build a model by registry name, its weights drawn from a
    ``torch.Generator`` seeded with ``seed``, in eval mode on ``device``
    (``None`` is the GPU; pass ``"cpu"`` for the CPU).  ``stat_thres`` is
    CMFlow's static-probability threshold and ``rigid_thres`` RaFlow's
    Doppler-residual threshold (the config's keys); CMFlow_T keeps the
    reference's hardcoded 0.5.  ``compute_dtype`` (the config's key,
    ``"float32"`` or ``"bfloat16"``) is the modules' compute dtype, as the
    JAX package's ``build_model`` gives it: the parameters and BatchNorm
    statistics are float32 either way, so the same weights load into both
    (``models/convert.py``).  ``group`` is the process group the train-mode
    BatchNorms average their statistics over, the JAX ``build_model``'s
    ``axis_name`` (``None`` for one process).  ``remat`` (the config's key:
    False, True or ``"dots"``) recomputes the encoder branches and the cost
    volume in the backward (``nn/blocks.py::remat_call``); any other value
    raises ``ValueError``."""
    name = name.lower()
    if name not in MODEL_REGISTRY:
        raise KeyError(f"unknown model {name!r}; have {list(MODEL_REGISTRY)}")
    if compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype must be one of "
                         f"{tuple(COMPUTE_DTYPES)}, got {compute_dtype!r}")
    dev = resolve_device(device)
    kwargs = {"raflow": dict(rigid_thres=rigid_thres),
              "cmflow": dict(stat_thres=stat_thres)}.get(name, {})
    model = MODEL_REGISTRY[name](**kwargs, dtype=COMPUTE_DTYPES[compute_dtype],
                                 group=group, remat=remat)
    init_parameters(model, torch.Generator().manual_seed(seed))
    return model.to(dev).eval()


__all__ = ["BackboneConfig", "SceneFlowTrunk", "CMFlow", "CMFlowT", "RaFlow",
           "COMPUTE_DTYPES", "MODEL_REGISTRY", "build_model"]
