"""Eval step.  Counterpart of ``cmflow_tpu/train/steps.py::make_eval_step``,
with its two routes: the fused serving engine
(:func:`cmflow_tpu_torch.models.inference.cmflow_infer`) and the module
route (``CMFlow.forward(train=False)``).
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, Tuple

import numpy as np
import torch

from cmflow_tpu_torch.models.inference import cmflow_infer

Tensor = torch.Tensor

_INPUTS = ("pc1", "pc2", "ft1", "ft2", "valid1", "valid2")
_FUSED = ("auto", "on", "off")


def make_eval_step(model_name: str, model: torch.nn.Module,
                   fused: str = "auto"
                   ) -> Callable[[Mapping[str, np.ndarray]],
                                 Tuple[Tensor, Tensor, Tensor, Tensor]]:
    """Inference step ``batch -> (sf_agg, stat_cls, pre_trans, mask)`` in
    eval mode (main_util.py:139-142).

    The batch is a dict of arrays as :func:`cmflow_tpu_torch.data.schema.collate`
    gives them, with ``valid1``/``valid2`` masks; the step moves the fields
    it reads to the model's device.  ``fused`` picks the route: ``"on"`` the
    fused engine, ``"off"`` the module route, ``"auto"`` the fused engine
    when the model's parameters lie on a CUDA device and the module route
    otherwise (the JAX package's rule, with the card in the TPU's place).
    Only ``cmflow`` is ported."""
    if model_name != "cmflow":
        raise NotImplementedError(
            f"eval step for {model_name!r} is not ported yet (ROADMAP Queue 1)")
    if fused not in _FUSED:
        raise ValueError(f"fused must be one of {_FUSED}, got {fused!r}")
    device = next(model.parameters()).device
    use_fused = device.type == "cuda" if fused == "auto" else fused == "on"

    def step(batch: Mapping[str, np.ndarray]):
        x: Dict[str, Tensor] = {
            k: torch.as_tensor(np.asarray(batch[k])).to(device)
            for k in _INPUTS}
        args = (x["pc1"], x["pc2"], x["ft1"], x["ft2"])
        with torch.inference_mode():
            if use_fused:
                return cmflow_infer(model, *args, x["valid1"], x["valid2"])
            return model(*args, None, False, x["valid1"], x["valid2"])

    step.fused = use_fused
    return step
