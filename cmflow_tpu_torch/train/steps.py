"""Train and eval steps.  Counterpart of ``cmflow_tpu/train/steps.py``:

* :func:`make_train_step`, the per-batch CMFlow train step (reference
  main_util.py:39-90): pseudo labels, the train-mode forward, the composite
  loss, the backward through the K7 gather transposes, one Adam step;
* :func:`make_eval_step`, with its two routes: the fused serving engine
  (:func:`cmflow_tpu_torch.models.inference.cmflow_infer`) and the module
  route (``CMFlow.forward(train=False)``).
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, Tuple

import numpy as np
import torch

from cmflow_tpu_torch.losses import radar_loss as rl
from cmflow_tpu_torch.models.inference import cmflow_infer
from cmflow_tpu_torch.train import labels as labelgen
from cmflow_tpu_torch.train.state import TrainState

Tensor = torch.Tensor

_INPUTS = ("pc1", "pc2", "ft1", "ft2", "valid1", "valid2")
_FUSED = ("auto", "on", "off")
# the fields of a training batch (data/synthetic.py::make_train_batch)
_TRAIN_INPUTS = ("pc1", "pc2", "ft1", "ft2", "trans", "labels", "mask",
                 "interval", "radar_u", "radar_v", "opt_flow")


def _to_device(value, device: torch.device) -> Tensor:
    """A batch field (numpy array or tensor) on ``device``; a tensor in
    pinned host memory is copied without blocking the host."""
    return torch.as_tensor(value).to(device, non_blocking=True)


def _frame_loss(model: torch.nn.Module, x: Mapping[str, Tensor],
                proj: Tensor, tcr: Tensor, vr_thres: float
                ) -> Tuple[Tensor, Dict[str, Tensor]]:
    """Pseudo labels, the train-mode forward and the composite loss of one
    CMFlow batch (``_frame_loss`` of the JAX package).  Updates the
    BatchNorm running statistics; returns ``(loss, items)``."""
    pc1, pc2, ft1, ft2 = x["pc1"], x["pc2"], x["ft1"], x["ft2"]
    vel1 = ft1[..., 0]
    with torch.no_grad():
        dyn_mask = labelgen.extract_dynamic_from_fg(x["mask"], pc1, x["trans"],
                                                    x["labels"])
        mseg_rrv, _ = labelgen.mseg_label_rrv(pc1, x["trans"], vel1,
                                              x["interval"], vr_thres)
        mseg_gt = labelgen.merge_mseg_labels(mseg_rrv, dyn_mask)
    pred_f, mseg_pre, pre_trans, _ = model(pc1, pc2, ft1, ft2, mseg_gt, True)
    return rl.radar_flow_loss(
        "cmflow", pc1, pc2, pred_f, vel1, gt_f=x["labels"],
        pre_trans=pre_trans, mseg_pre=mseg_pre, gt_trans=x["trans"],
        mseg_gt=mseg_gt, dyn_mask=dyn_mask, radar_u=x["radar_u"],
        radar_v=x["radar_v"], opt=x["opt_flow"], projection=proj,
        t_camera_radar=tcr)


def make_train_step(model_name: str, model: torch.nn.Module,
                    calib_projection: np.ndarray,
                    calib_t_camera_radar: np.ndarray, vr_thres: float = 0.3
                    ) -> Callable[[TrainState, Mapping[str, np.ndarray]],
                                  Dict[str, Tensor]]:
    """Per-batch train step ``(state, batch) -> items`` for CMFlow.

    The batch is a dict of arrays or tensors without valid masks, as
    :func:`cmflow_tpu_torch.data.synthetic.make_train_batch` gives it.  The
    step moves it to the model's device, generates the pseudo labels, runs
    the forward with ``train=True`` (batch statistics; the BatchNorm running
    statistics update), the composite loss and its backward, and takes one
    optimizer step and one schedule step.  ``state`` (from
    :func:`cmflow_tpu_torch.train.state.create_train_state`) must hold
    ``model``; it is updated in place.  Returns the loss items, the keys of
    ``LOSS_ITEMS["cmflow"]``, as detached 0-d tensors on the device."""
    if model_name in ("raflow", "cmflow_t"):
        raise NotImplementedError(
            f"train step for {model_name!r} is not ported yet (ROADMAP "
            f"Queue 1)")
    if model_name != "cmflow":
        raise ValueError(f"unknown model {model_name!r}")
    device = next(model.parameters()).device
    proj = torch.as_tensor(np.asarray(calib_projection, np.float32),
                           device=device)
    tcr = torch.as_tensor(np.asarray(calib_t_camera_radar, np.float32),
                          device=device)

    def step(state: TrainState, batch: Mapping[str, np.ndarray]
             ) -> Dict[str, Tensor]:
        if state.model is not model:
            raise ValueError("the train state holds another model")
        x = {k: _to_device(batch[k], device) for k in _TRAIN_INPUTS}
        state.optimizer.zero_grad(set_to_none=True)
        loss, items = _frame_loss(model, x, proj, tcr, vr_thres)
        loss.backward()
        state.optimizer.step()
        state.scheduler.step()
        state.step += 1
        return {k: items[k].detach() for k in rl.LOSS_ITEMS["cmflow"]}

    return step


def make_eval_step(model_name: str, model: torch.nn.Module,
                   fused: str = "auto"
                   ) -> Callable[[Mapping[str, np.ndarray]],
                                 Tuple[Tensor, Tensor, Tensor, Tensor]]:
    """Inference step ``batch -> (sf_agg, stat_cls, pre_trans, mask)`` in
    eval mode (main_util.py:139-142).

    The batch is a dict of arrays as :func:`cmflow_tpu_torch.data.schema.collate`
    gives them (or tensors), with ``valid1``/``valid2`` masks; the step moves
    the fields it reads to the model's device.  ``fused`` picks the route: ``"on"`` the
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
        x = {k: _to_device(batch[k], device) for k in _INPUTS}
        args = (x["pc1"], x["pc2"], x["ft1"], x["ft2"])
        with torch.inference_mode():
            if use_fused:
                return cmflow_infer(model, *args, x["valid1"], x["valid2"])
            return model(*args, None, False, x["valid1"], x["valid2"])

    step.fused = use_fused
    return step
