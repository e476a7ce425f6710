"""Eval step.  Counterpart of ``cmflow_tpu/train/steps.py::make_eval_step``
on its module route (``fused_inference: off``, ``CMFlow.apply(train=False)``).
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, Tuple

import numpy as np
import torch

Tensor = torch.Tensor

_INPUTS = ("pc1", "pc2", "ft1", "ft2", "valid1", "valid2")


def make_eval_step(model_name: str, model: torch.nn.Module
                   ) -> Callable[[Mapping[str, np.ndarray]],
                                 Tuple[Tensor, Tensor, Tensor, Tensor]]:
    """Inference step ``batch -> (sf_agg, stat_cls, pre_trans, mask)`` in
    eval mode (main_util.py:139-142).

    The batch is a dict of arrays as :func:`cmflow_tpu_torch.data.schema.collate`
    gives them, with ``valid1``/``valid2`` masks; the step moves the fields
    it reads to the model's device.  Only ``cmflow`` is ported."""
    if model_name != "cmflow":
        raise NotImplementedError(
            f"eval step for {model_name!r} is not ported yet (ROADMAP Queue 1)")
    device = next(model.parameters()).device

    def step(batch: Mapping[str, np.ndarray]):
        x: Dict[str, Tensor] = {
            k: torch.as_tensor(np.asarray(batch[k])).to(device)
            for k in _INPUTS}
        with torch.inference_mode():
            return model(x["pc1"], x["pc2"], x["ft1"], x["ft2"], None, False,
                         x["valid1"], x["valid2"])

    return step
