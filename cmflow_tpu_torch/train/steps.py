"""Train and eval steps.  Counterpart of ``cmflow_tpu/train/steps.py``:

* :func:`make_train_step`, the per-batch train step of the frame-pair
  models (reference main_util.py:39-90): for CMFlow pseudo labels, the
  train-mode forward and the composite loss; for RaFlow the train-mode
  forward and the self-supervised loss on its refined flow; then the
  backward through the K7 gather transposes and one Adam step.  A model
  built with ``compute_dtype="bfloat16"`` trains its bf16 chain
  (``nn/blocks.py``): float32 parameters, gradients and Adam moments, bf16
  activations, K6 and K7 on their bf16 arms for the bf16 gathers;
* :func:`make_train_step_seq`, CMFlow_T's mini-clip step (reference
  clip_util.py:34-66): one optimizer step per frame, the GRU carry
  detached between frames;
* :func:`make_eval_step`, with its two routes: the fused serving engines
  (:mod:`cmflow_tpu_torch.models.inference`) and the module route
  (``forward(train=False)``).

Data parallelism (the JAX steps under ``shard_map`` over the ``data``
mesh): the train steps take a process ``group`` where JAX takes ``mesh``,
and each rank passes its own rows of the global batch
(:func:`cmflow_tpu_torch.parallel.mesh.shard_batch`).  The model is built
with the same group (its BatchNorms average their statistics over it), the
count-normalised losses take the global batch's counts, and after the
backward the gradients and loss items are averaged over the ranks in one
``all_reduce`` each, before Adam: every rank then applies the same update to
the same state, so the parameters stay bit-identical across the ranks.  An
eval forward takes no collective: a sharded eval is each rank's
:func:`make_eval_step` on its own rows.

``nan_check`` (the config's key; the JAX package's ``jax_debug_nans``):
each step also checks the tensors it holds for NaN, in one host read per
check, and raises ``FloatingPointError`` naming the first that holds one:
a train step its inputs, its loss items and, after the backward, every
gradient; an eval step its inputs and its predictions.  Under a group the
flags are summed over the ranks first, so every rank raises together.  A
NaN that autograd's anomaly mode (the CLI turns it on for the run) finds in
the backward raises ``FloatingPointError`` too.
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from cmflow_tpu_torch.losses import radar_loss as rl
from cmflow_tpu_torch.models import MODEL_REGISTRY
from cmflow_tpu_torch.models.inference import (
    check_compute_dtype,
    cmflow_infer,
    cmflow_t_infer,
    raflow_infer,
)
from cmflow_tpu_torch.parallel import mesh
from cmflow_tpu_torch.parallel.mesh import Group
from cmflow_tpu_torch.train import labels as labelgen
from cmflow_tpu_torch.train.state import TrainState

Tensor = torch.Tensor

_INPUTS = ("pc1", "pc2", "ft1", "ft2", "valid1", "valid2")
_FUSED = ("auto", "on", "off")
# the fields of a training batch each model reads
# (data/synthetic.py::make_train_batch)
_TRAIN_INPUTS = ("pc1", "pc2", "ft1", "ft2", "trans", "labels", "mask",
                 "interval", "radar_u", "radar_v", "opt_flow")
_RAFLOW_TRAIN_INPUTS = ("pc1", "pc2", "ft1", "ft2", "interval")


def _to_device(value, device: torch.device) -> Tensor:
    """A batch field (numpy array or tensor) on ``device``; a tensor in
    pinned host memory is copied without blocking the host."""
    return torch.as_tensor(value).to(device, non_blocking=True)


def _frame_loss(model_name: str, model: torch.nn.Module,
                x: Mapping[str, Tensor], proj: Tensor, tcr: Tensor,
                vr_thres: float, gfeat: Optional[Tensor] = None,
                group: Group = None
                ) -> Tuple[Tensor, Dict[str, Tensor], Optional[Tensor]]:
    """The train-mode forward and loss of one frame pair (``_frame_loss``
    of the JAX package): RaFlow's self-supervised loss on its refined flow,
    or, for the cross-modal models, pseudo labels and the composite loss
    (CMFlow_T from the carry ``gfeat``).  Updates the BatchNorm running
    statistics; returns ``(loss, items, gfeat_new)``, ``gfeat_new`` None but
    for CMFlow_T.  ``group``: the losses' (``radar_flow_loss``)."""
    pc1, pc2, ft1, ft2 = x["pc1"], x["pc2"], x["ft1"], x["ft2"]
    vel1 = ft1[..., 0]
    if model_name == "raflow":
        _, sf_agg, _, _ = model(pc1, pc2, ft1, ft2, x["interval"], True)
        loss, items = rl.radar_flow_loss("raflow", pc1, pc2, sf_agg, vel1)
        return loss, items, None
    with torch.no_grad():
        dyn_mask = labelgen.extract_dynamic_from_fg(x["mask"], pc1, x["trans"],
                                                    x["labels"])
        mseg_rrv, _ = labelgen.mseg_label_rrv(pc1, x["trans"], vel1,
                                              x["interval"], vr_thres)
        mseg_gt = labelgen.merge_mseg_labels(mseg_rrv, dyn_mask)
    if model_name == "cmflow":
        pred_f, mseg_pre, pre_trans, _ = model(pc1, pc2, ft1, ft2, mseg_gt,
                                               True)
        gfeat_new = None
    elif model_name == "cmflow_t":
        pred_f, mseg_pre, pre_trans, _, gfeat_new = model(
            pc1, pc2, ft1, ft2, mseg_gt, True, gfeat)
    else:
        raise ValueError(f"unknown model {model_name!r}")
    loss, items = rl.radar_flow_loss(
        model_name, pc1, pc2, pred_f, vel1, gt_f=x["labels"],
        pre_trans=pre_trans, mseg_pre=mseg_pre, gt_trans=x["trans"],
        mseg_gt=mseg_gt, dyn_mask=dyn_mask, radar_u=x["radar_u"],
        radar_v=x["radar_v"], opt=x["opt_flow"], projection=proj,
        t_camera_radar=tcr, group=group)
    return loss, items, gfeat_new


def _calib(model: torch.nn.Module, calib_projection: np.ndarray,
           calib_t_camera_radar: np.ndarray
           ) -> Tuple[torch.device, Tensor, Tensor]:
    device = next(model.parameters()).device
    proj = torch.as_tensor(np.asarray(calib_projection, np.float32),
                           device=device)
    tcr = torch.as_tensor(np.asarray(calib_t_camera_radar, np.float32),
                          device=device)
    return device, proj, tcr


def _train_inputs(model_name: str) -> Tuple[str, ...]:
    if model_name not in MODEL_REGISTRY:
        raise ValueError(f"unknown model {model_name!r}")
    return _RAFLOW_TRAIN_INPUTS if model_name == "raflow" else _TRAIN_INPUTS


def check_nan(what: str, named: Mapping[str, Optional[Tensor]],
              group: Group = None) -> None:
    """Raise ``FloatingPointError`` naming the first floating tensor of
    ``named`` that holds a NaN (one host read; under a group the flags are
    summed over the ranks first)."""
    named = {k: v for k, v in named.items()
             if v is not None and v.is_floating_point()}
    if not named:
        return
    flags = torch.stack([torch.isnan(v).any() for v in named.values()])
    flags = flags.float()
    mesh.pmean_([flags], group)
    for name, bad in zip(named, flags.tolist()):
        if bad:
            raise FloatingPointError(f"nan_check: {what} {name} holds NaN")


def _backward(loss: Tensor, nan_check: bool) -> None:
    """``loss.backward()``; under ``nan_check`` a NaN that anomaly mode
    finds in the backward raises ``FloatingPointError``."""
    if not nan_check:
        loss.backward()
        return
    try:
        loss.backward()
    except RuntimeError as e:
        if "nan" not in str(e):
            raise
        raise FloatingPointError(f"nan_check: {e}") from e


def _optimizer_step(state: TrainState, loss: Tensor,
                    items: Mapping[str, Tensor], keys: Tuple[str, ...],
                    group: Group, nan_check: bool = False) -> Tensor:
    """Backward; with a group, the gradients averaged over the ranks (one
    ``all_reduce``); one optimizer step and one schedule step.  Returns the
    loss items ``keys`` stacked, detached and averaged over the ranks.
    ``nan_check``: the loss items checked before the backward, the
    gradients after their average."""
    if nan_check:
        check_nan("loss item", items, group)
    _backward(loss, nan_check)
    vec = torch.stack([items[k].detach() for k in keys])
    if group is not None:
        mesh.average_gradients(state.model.parameters(), group)
        mesh.pmean_([vec], group)
    if nan_check:
        check_nan("the gradient of", {n: p.grad for n, p in
                                      state.model.named_parameters()}, group)
    state.optimizer.step()
    state.scheduler.step()
    state.step += 1
    return vec


def make_train_step(model_name: str, model: torch.nn.Module,
                    calib_projection: np.ndarray,
                    calib_t_camera_radar: np.ndarray, vr_thres: float = 0.3,
                    group: Group = None, nan_check: bool = False
                    ) -> Callable[[TrainState, Mapping[str, np.ndarray]],
                                  Dict[str, Tensor]]:
    """Per-batch train step ``(state, batch) -> items`` of a frame-pair
    model, ``"cmflow"`` or ``"raflow"`` (CMFlow_T trains per frame of a
    mini-clip: :func:`make_train_step_seq`).

    The batch is a dict of arrays or tensors without valid masks, as
    :func:`cmflow_tpu_torch.data.synthetic.make_train_batch` gives it.  The
    step moves the fields its model reads to the model's device, runs the
    forward with ``train=True`` (batch statistics; the BatchNorm running
    statistics update), the loss (:func:`_frame_loss`) and its backward,
    and takes one optimizer step and one schedule step.  ``state`` (from
    :func:`cmflow_tpu_torch.train.state.create_train_state`) must hold
    ``model``; it is updated in place.  Returns the loss items, the keys of
    ``LOSS_ITEMS[model_name]``, as detached 0-d tensors on the device.

    ``group``: data parallelism (module docstring).  The batch is then this
    rank's rows, ``model`` was built with the same group, and the items are
    the means over the ranks.  ``nan_check``: module docstring."""
    keys = _train_inputs(model_name)
    if model_name == "cmflow_t":
        raise ValueError("cmflow_t trains per frame of a mini-clip: use "
                         "make_train_step_seq")
    device, proj, tcr = _calib(model, calib_projection, calib_t_camera_radar)
    item_keys = rl.LOSS_ITEMS[model_name]
    checked = group is None

    def step(state: TrainState, batch: Mapping[str, np.ndarray]
             ) -> Dict[str, Tensor]:
        nonlocal checked
        if state.model is not model:
            raise ValueError("the train state holds another model")
        x = {k: _to_device(batch[k], device) for k in keys}
        if not checked:
            mesh.check_equal_rows(x["pc1"].shape[0], group)
            checked = True
        if nan_check:
            check_nan("input", x, group)
        state.optimizer.zero_grad(set_to_none=True)
        loss, items, _ = _frame_loss(model_name, model, x, proj, tcr,
                                     vr_thres, group=group)
        vec = _optimizer_step(state, loss, items, item_keys, group,
                              nan_check)
        return {k: vec[j] for j, k in enumerate(item_keys)}

    return step


def make_train_step_seq(model: torch.nn.Module,
                        calib_projection: np.ndarray,
                        calib_t_camera_radar: np.ndarray,
                        vr_thres: float = 0.3, model_name: str = "cmflow_t",
                        group: Group = None, nan_check: bool = False
                        ) -> Callable[[TrainState, Mapping[str, np.ndarray]],
                                      Dict[str, Tensor]]:
    """Mini-clip train step ``(state, clip) -> items`` (reference
    clip_util.py:34-66; ``make_train_step_seq`` of the JAX package).

    The clip is a dict of ``[B, T, ...]`` arrays or tensors.  The step walks
    its T frames in order: for each, the forward from the GRU carry (zeros
    of ``prop_width`` at frame 0), the loss and its backward, one optimizer
    step and one schedule step, then the carry detached for the next frame
    (truncated back-propagation through time).  So a schedule built with
    ``steps_per_epoch`` in clip batches decays T times as often per epoch,
    as the JAX package's does.  A model without a carry (``"cmflow"``,
    ``"raflow"``, as ``model_name`` picks the loss) takes the same per-frame
    steps.  Returns each loss item's mean over the T frames, detached, on
    the device.  ``group``: as :func:`make_train_step`'s, the reduction
    after each frame's backward; each rank's carry stays on its own rows.
    ``nan_check``: module docstring, for each frame."""
    keys = _train_inputs(model_name)
    device, proj, tcr = _calib(model, calib_projection, calib_t_camera_radar)
    item_keys = rl.LOSS_ITEMS[model_name]
    checked = group is None

    def step(state: TrainState, clip: Mapping[str, np.ndarray]
             ) -> Dict[str, Tensor]:
        nonlocal checked
        if state.model is not model:
            raise ValueError("the train state holds another model")
        # frame-major [T, B, ...]: each frame's fields are contiguous, as
        # the kernels take them
        x = {k: _to_device(clip[k], device).transpose(0, 1).contiguous()
             for k in keys}
        t, b = x["pc1"].shape[:2]
        if not checked:
            mesh.check_equal_rows(b, group)
            checked = True
        if nan_check:
            check_nan("input", x, group)
        gfeat = torch.zeros((b, model.cfg.prop_width), device=device)
        sums = None
        for i in range(t):
            frame = {k: v[i] for k, v in x.items()}
            state.optimizer.zero_grad(set_to_none=True)
            loss, items, gfeat_new = _frame_loss(model_name, model, frame,
                                                 proj, tcr, vr_thres, gfeat,
                                                 group)
            vec = _optimizer_step(state, loss, items, item_keys, group,
                                  nan_check)
            if gfeat_new is not None:
                gfeat = gfeat_new.detach()
            sums = vec if sums is None else sums + vec
        means = sums / t
        return {k: means[j] for j, k in enumerate(item_keys)}

    return step


def make_eval_step(model_name: str, model: torch.nn.Module,
                   fused: str = "auto",
                   compute_dtype: torch.dtype = torch.float32,
                   nan_check: bool = False) -> Callable:
    """Inference step in eval mode (main_util.py:139-142,
    clip_util.py:226-233):

    * ``"cmflow"``: ``batch -> (sf_agg, stat_cls, pre_trans, mask)``;
    * ``"raflow"``: ``batch -> (sf_agg, mask_s as float, pre_trans,
      mask_s)``, reading the batch's ``interval`` too;
    * ``"cmflow_t"``: ``(batch, gfeat) -> (sf_agg, stat_cls, pre_trans,
      mask, gfeat_new)``, ``gfeat`` the GRU carry ``[B, prop_width]`` on
      the model's device.

    The batch is a dict of arrays as
    :func:`cmflow_tpu_torch.data.schema.collate` gives them (or tensors),
    with ``valid1``/``valid2`` masks; the step moves
    the fields it reads to the model's device.  ``fused`` picks the route:
    ``"on"`` the fused engine, ``"off"`` the module route, ``"auto"`` the
    fused engine when the model's parameters lie on a CUDA device and the
    module route otherwise (the JAX package's rule, with the card in the
    TPU's place).  ``compute_dtype`` (float32 or bfloat16) is the fused
    engine's; the module route ignores it and serves in the model's own
    compute dtype (``build_model(..., compute_dtype=)``), as the JAX
    package's ``model.apply`` does.  ``nan_check``: module docstring."""
    if model_name not in MODEL_REGISTRY:
        raise ValueError(f"unknown model {model_name!r}")
    if fused not in _FUSED:
        raise ValueError(f"fused must be one of {_FUSED}, got {fused!r}")
    check_compute_dtype(compute_dtype)
    device = next(model.parameters()).device
    use_fused = device.type == "cuda" if fused == "auto" else fused == "on"
    keys = _INPUTS + (("interval",) if model_name == "raflow" else ())

    raflow = model_name == "raflow"
    engine = {"cmflow": cmflow_infer, "raflow": raflow_infer,
              "cmflow_t": cmflow_t_infer}[model_name]

    def step(batch: Mapping[str, np.ndarray], *carry: Tensor):
        x = {k: _to_device(batch[k], device) for k in keys}
        args = (x["pc1"], x["pc2"], x["ft1"], x["ft2"])
        masks = (x["valid1"], x["valid2"])
        if nan_check:
            check_nan("input", {**x, **{f"carry {i}": c
                                        for i, c in enumerate(carry)}})
        with torch.inference_mode():
            if use_fused:
                extra = (x["interval"],) if raflow else ()
                out = engine(model, *args, *extra, *carry, *masks,
                             compute_dtype=compute_dtype)
            else:
                extra = (x["interval"],) if raflow else (None,)
                out = model(*args, *extra, False, *carry, *masks)
            if raflow:
                _, sf_agg, pre_trans, mask_s = out
                out = sf_agg, mask_s.float(), pre_trans, mask_s
        if nan_check:
            check_nan("prediction", {f"output {i}": o
                                     for i, o in enumerate(out)})
        return out

    step.fused = use_fused
    return step
