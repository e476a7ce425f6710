"""Experiment loop: epoch loops, evaluation, checkpoint and resume.

Counterpart of ``cmflow_tpu/train/loop.py`` for the three families
(main.py:51-170, main_util.py:93-206; CMFlow_T's mini-clip training and
clip-ordered evaluation, clip_util.py:20-301): full train-state checkpoints
for a true resume, ``metrics.jsonl`` rows, and evaluation at static padded
shapes with the metric battery on the device.  CMFlow_T's evaluation runs
its clips side by side, one batch lane each (:func:`build_clip_plan`).

The host feed:
* training batches go to the card from pinned host memory with
  non-blocking copies (pinned only when the device is CUDA);
* evaluation batches keep the JAX package's ``eval_wire``: with ``int16``
  (the default) each float32 field with >= 32 values per frame is quantized
  on the host to a per-frame scale ``max|x| / 32767`` (``round``, then
  ``clip`` to +-32767), uploaded as int16 and dequantized on the device as
  ``q * scale`` in float32, the JAX unpack's numbers; ``float32`` is
  lossless.

Neither loop reads the device per step: the train loss items are summed on
the device and read once per epoch, and without ``save_res`` or ``vis`` the
metrics are summed on the device and read once per evaluation pass (under
``nan_check`` each step also reads its NaN flags, ``train/steps.py``).

Data parallelism (a :class:`cmflow_tpu_torch.parallel.mesh.DataParallel`
``dp``, the JAX loop's ``mesh``): ``batch_size`` is the global batch and
must divide by the G ranks; each rank decodes and trains on its rows of
every batch.  Validation and evaluation are sharded the same way when
``eval_batch_size`` divides by G, the model is not CMFlow_T (its lane count
is data-driven) and no result files are written; otherwise rank 0 alone
evaluates and broadcasts the metrics.  A sharded pass pads each rank's rows
to their own bucket (the forwards are the same function of the valid
points at any padding) and sums its metrics over the ranks, so every rank
takes the same best-RNE decision.  Rank 0 alone writes ``run.log``,
``metrics.jsonl`` and the checkpoints, and the other ranks wait for each
checkpoint at a barrier; every rank reads a checkpoint it restores.
"""

from __future__ import annotations

import json
import os
import queue
import threading
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from cmflow_tpu_torch.data import DATASET_REGISTRY, BatchLoader
from cmflow_tpu_torch.evaluation import device_metrics as dmet
from cmflow_tpu_torch.evaluation import metrics as ev
from cmflow_tpu_torch.losses.radar_loss import LOSS_ITEMS
from cmflow_tpu_torch.models import build_model
from cmflow_tpu_torch.parallel import mesh
from cmflow_tpu_torch.parallel.mesh import DataParallel
from cmflow_tpu_torch.train import steps as steplib
from cmflow_tpu_torch.train.state import TrainState, create_train_state
from cmflow_tpu_torch.utils import plots, vis
from cmflow_tpu_torch.utils.config import Config, config_device
from cmflow_tpu_torch.utils.logging import (
    IOStream,
    MetricsWriter,
    NullStream,
    init_experiment_dir,
)

Tensor = torch.Tensor


# --------------------------------------------------------------------------
# checkpointing

def save_checkpoint(path: str, state: TrainState) -> None:
    """Full train-state checkpoint: the model's ``state_dict`` (parameters
    and BatchNorm statistics), the optimizer's (Adam's moments and step), the
    schedule's, and ``state.step``.  Written to a temporary file, then
    renamed, so ``path`` always holds a whole checkpoint."""
    payload = {
        "model": state.model.state_dict(),
        "optimizer": state.optimizer.state_dict(),
        "scheduler": state.scheduler.state_dict(),
        "step": state.step,
    }
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def restore_checkpoint(path: str, state: TrainState) -> TrainState:
    """Restore ``state`` in place from :func:`save_checkpoint`'s file, on the
    model's device whichever device saved it: the tensors are read to the
    host, ``load_state_dict`` copies the weights onto the model's device and
    the optimizer casts Adam's moments to its parameters' device, keeping
    its ``step`` counts on the host where ``torch.optim.Adam`` expects them.
    The next step takes the saved run's next learning rate and Adam step."""
    payload = torch.load(path, map_location="cpu", weights_only=True)
    state.model.load_state_dict(payload["model"])
    state.optimizer.load_state_dict(payload["optimizer"])
    state.scheduler.load_state_dict(payload["scheduler"])
    state.step = int(payload["step"])
    return state


# --------------------------------------------------------------------------
# setup helpers

def build_datasets(cfg: Config, textio) -> Tuple:
    ds_cls = DATASET_REGISTRY[cfg.dataset]
    kwargs = dict(num_points=cfg.num_points, log=textio.cprint,
                  seed=cfg.seed)
    if cfg.dataset == "vodClipDataset":
        kwargs.update(mini_clip_len=cfg.mini_clip_len,
                      update_len=cfg.update_len)
    if cfg.eval:
        test = ds_cls(cfg.dataset_path, cfg.eval_split, eval_mode=True,
                      **kwargs)
        return None, None, test
    train = ds_cls(cfg.dataset_path, cfg.train_set, eval_mode=False, **kwargs)
    val = ds_cls(cfg.dataset_path, "val", eval_mode=True, **kwargs)
    return train, val, None


def _build_model(cfg: Config, device: torch.device,
                 group: mesh.Group = None) -> torch.nn.Module:
    return build_model(cfg.model, device, seed=cfg.seed,
                       stat_thres=cfg.stat_thres, rigid_thres=cfg.rigid_thres,
                       compute_dtype=cfg.compute_dtype, group=group,
                       remat=cfg.remat)


def _lead(dp: Optional[DataParallel]) -> bool:
    """Whether this process writes the run's files: rank 0, or the one
    process."""
    return dp is None or dp.rank == 0


def experiment_dir(cfg: Config, dp: Optional[DataParallel] = None) -> str:
    """The experiment's directory, created (with its config snapshot) by
    the process that writes the run's files."""
    if _lead(dp):
        return init_experiment_dir(cfg.checkpoints_dir, cfg.exp_name, cfg)
    return os.path.join(cfg.checkpoints_dir, cfg.exp_name)


def _device(cfg: Config, dp: Optional[DataParallel]) -> torch.device:
    return config_device(cfg) if dp is None else dp.device


def _sharded_eval(cfg: Config, dp: Optional[DataParallel],
                  writes_files: bool) -> bool:
    """The JAX loop's eval-mesh rule: evaluation rides the data-parallel
    group when ``eval_batch_size`` divides by it and the model is not
    CMFlow_T; the port also keeps a pass that writes result files or
    figures on rank 0 alone."""
    return (dp is not None and cfg.model != "cmflow_t" and not writes_files
            and int(cfg.eval_batch_size) % dp.size == 0)


def require_matplotlib_for_vis(cfg: Config) -> None:
    """``vis: true`` asks for figures: without matplotlib the run stops
    before it starts."""
    if cfg.vis and not plots.have_matplotlib():
        raise ImportError("vis: true draws its PNGs with matplotlib, which "
                          "does not import here")


def draw_curves(exp_dir: str, textio, state: Dict) -> None:
    """The loss and validation curves of the run so far
    (``loss_train/loss_train.png``, ``val_score.png``), as the JAX loop draws
    them after every validation pass.  Without matplotlib one line in the
    log, the first time (``state`` remembers it), and the run goes on."""
    if not plots.have_matplotlib():
        if not state.get("warned"):
            textio.cprint("matplotlib does not import here: the loss and "
                          "validation curves are not drawn")
            state["warned"] = True
        return
    path = os.path.join(exp_dir, "metrics.jsonl")
    plots.plot_loss_curves(path, os.path.join(exp_dir, "loss_train"))
    plots.plot_val_score(path, exp_dir)


def _host_tensor(array: np.ndarray, pin: bool) -> Tensor:
    t = torch.from_numpy(np.ascontiguousarray(array))
    return t.pin_memory() if pin else t


def quantize_int16(flat: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Per-row symmetric int16 quantization of a ``[B, L]`` float32 array:
    ``(q [B, L] int16, scale [B, 1] float32)``, ``q * scale`` the value."""
    max_abs = np.max(np.abs(flat), axis=1, keepdims=True)
    scale = np.where(max_abs > 0, max_abs / 32767.0, 1.0).astype(np.float32)
    q = np.clip(np.round(flat / scale), -32767, 32767).astype(np.int16)
    return q, scale


def pack_eval_batch(host: Dict[str, np.ndarray], wire: str,
                    pin: bool) -> Dict:
    """Host side of the eval wire: ``{key: (shape, tensors)}``, the tensors
    ``(values,)`` or, for a field the ``int16`` wire quantizes, ``(q,
    scale)``; pinned when ``pin``."""
    packed = {}
    for key in sorted(host):
        v = np.asarray(host[key])
        flat = v.reshape(v.shape[0], -1)
        if wire == "int16" and v.dtype == np.float32 and flat.shape[1] >= 32:
            parts = quantize_int16(flat)
        else:
            parts = (v,)
        packed[key] = (v.shape, tuple(_host_tensor(p, pin) for p in parts))
    return packed


def upload_eval_batch(packed: Dict, device: torch.device) -> Dict[str, Tensor]:
    """Device side of the eval wire: non-blocking copies, then ``q * scale``
    in float32 for the quantized fields."""
    out = {}
    for key, (shape, tensors) in packed.items():
        parts = [t.to(device, non_blocking=True) for t in tensors]
        out[key] = (parts[0] if len(parts) == 1
                    else (parts[0].float() * parts[1]).reshape(shape))
    return out


# --------------------------------------------------------------------------
# evaluation

def build_clip_plan(clips_info, lanes: int, update_len: int):
    """Assign the eval clips to ``lanes`` parallel batch lanes (the JAX
    package's clip-batched temporal evaluation).

    The reference evaluates CMFlow_T frame by frame at B=1
    (clip_util.py:182-301), since the GRU carry chains within a clip; clips
    are independent, so L of them run side by side, one lane each, each
    lane taking its clips back to back (each clip to the least loaded
    lane).  A lane's reset flag reproduces the reference's schedule: frame
    i resets where it starts a clip or ``i % update_len == 0`` (the global
    frame index, as the B=1 walk counts it).  A lane out of frames repeats
    its last one with ``lane_valid`` False and a reset.  Returns a
    :class:`BatchLoader` plan."""
    lane_seq = [[] for _ in range(lanes)]  # (frame index, reset) per lane
    for ci in clips_info:
        tgt = min(range(lanes), key=lambda j: len(lane_seq[j]))
        s, e = ci["index"]
        for i in range(s, e):
            lane_seq[tgt].append((i, i == s or i % update_len == 0))
    steps = max((len(sq) for sq in lane_seq), default=0)
    plan = []
    for t in range(steps):
        idxs, valid, resets = [], [], []
        for sq in lane_seq:
            if t < len(sq):
                i, r = sq[t]
            else:
                i, r = (sq[-1][0] if sq else 0), True
            idxs.append(i)
            valid.append(t < len(sq))
            resets.append(r)
        plan.append({"indices": idxs, "lane_valid": valid, "reset": resets})
    return plan


def reset_lanes(gfeat: Tensor, reset: Tensor) -> Tensor:
    """Zero the GRU carry of the lanes whose frame opens a clip or an
    update window (``reset [L]``, uploaded with the batch)."""
    return torch.where(reset[:, None], 0.0, gfeat)


def make_experiment_eval_step(cfg: Config, model):
    """Build the experiment's eval step once, for every validation pass, in
    the config's ``eval_compute_dtype``."""
    dtype = (torch.bfloat16 if cfg.eval_compute_dtype == "bfloat16"
             else torch.float32)
    return steplib.make_eval_step(cfg.model, model,
                                  fused=cfg.fused_inference,
                                  compute_dtype=dtype,
                                  nan_check=cfg.nan_check)


def _pinned_buckets(cfg: Config):
    """The closed eval shape set: cfg.eval_buckets filtered to
    >= num_points, with num_points itself as the floor bucket.  None
    disables pinning (falls back to open-ended pad_multiple rounding)."""
    bs = [int(b) for b in (getattr(cfg, "eval_buckets", None) or ())
          if int(b) >= int(cfg.num_points)]
    if not bs:
        return None
    return sorted(set(bs + [int(cfg.num_points)]))


def _host_prefetch(loader, prep, depth: int = 2):
    """Load and pack batches in a worker thread, ``depth`` ahead of the
    dispatch loop.  Yields ``(batch, packed, load_s, pack_s)`` in loader
    order; worker exceptions re-raise in the consumer."""
    q: queue.Queue = queue.Queue(maxsize=depth)

    def work():
        try:
            t_mark = time.perf_counter()
            for batch in loader:
                t0 = time.perf_counter()
                packed = prep(batch)
                t1 = time.perf_counter()
                q.put((batch, packed, t0 - t_mark, t1 - t0))
                t_mark = time.perf_counter()
            q.put(None)
        except BaseException as e:  # noqa: BLE001 — surface in consumer
            q.put(e)

    threading.Thread(target=work, daemon=True).start()
    while True:
        item = q.get()
        if item is None:
            return
        if isinstance(item, BaseException):
            raise item
        yield item


def evaluate_frames(
    cfg: Config, model, dataset, textio,
    save_res_dir: Optional[str] = None,
    eval_step=None,
    dp: Optional[DataParallel] = None,
    vis_dir: Optional[str] = None,
) -> Tuple[Dict, Dict, Dict]:
    """Frame-pair evaluation (eval_one_epoch, main_util.py:93-206) at static
    padded shapes: ``eval_batch_size`` frames a batch, padded to a pinned
    bucket, a short last batch padded with repeated lanes.

    CMFlow_T's evaluation (test_one_epoch_seq, clip_util.py:182-301) walks
    each clip in order with the GRU carry, reset at clip starts and every
    ``update_len`` frames.  With ``eval_batch_size > 1`` and the dataset's
    ``clips_info``, ``min(eval_batch_size, clips)`` clips run as lanes of
    one batch (:func:`build_clip_plan`), each lane's reset flag uploaded
    with the batch; else one frame a batch, reset where frame ``i`` starts
    a clip or ``i % update_len == 0``.

    Without ``save_res_dir`` and ``vis_dir`` the metrics are summed on the
    device and read once per pass.  With either, each batch's predictions
    come to the host (one batch behind the dispatch) for the host battery
    and, into ``save_res_dir``, the reference's ``[3, N]`` JSON dumps, into
    ``vis_dir`` each frame's BEV flow and segmentation PNGs
    (``{fidx}_flow.png``, ``{fidx}_seg.png``; main_util.py:170-172).  Pass
    ``eval_step`` (from :func:`make_experiment_eval_step`) when calling
    repeatedly.

    ``dp``: a sharded pass (a frame-pair model, no files written): each
    rank evaluates its rows of every batch, padded to its rows' bucket, and
    the metric sums are added over the ranks, so every rank returns the
    global metrics."""
    device = next(model.parameters()).device
    pin = device.type == "cuda"
    wire = cfg.eval_wire
    if eval_step is None:
        eval_step = make_experiment_eval_step(cfg, model)
    temporal = cfg.model == "cmflow_t"
    writes_files = save_res_dir is not None or vis_dir is not None
    if dp is not None and (temporal or writes_files):
        raise ValueError("a sharded evaluation takes a frame-pair model and "
                         "writes no files")
    lane_plan = None
    if temporal and int(cfg.eval_batch_size) > 1 and dataset.clips_info:
        batch_size = min(int(cfg.eval_batch_size), len(dataset.clips_info))
        lane_plan = build_clip_plan(dataset.clips_info, batch_size,
                                    cfg.update_len)
    else:
        batch_size = 1 if temporal else max(1, int(cfg.eval_batch_size))
    loader = BatchLoader(
        dataset, batch_size=batch_size, shuffle=False, drop_last=False,
        pad_bucket=cfg.num_points, pad_multiple=cfg.eval_pad_multiple,
        pad_buckets=_pinned_buckets(cfg), num_workers=cfg.num_workers,
        pad_batch=not temporal, plan=lane_plan,
        shard=None if dp is None else (dp.rank, dp.size),
    )

    def prep(batch):
        """Strip the loader's metadata and the pseudo-label inputs the eval
        step never reads, attach the lane mask, and pack for the wire."""
        host = {k: v for k, v in batch.items()
                if not k.startswith("_")
                and k not in ("radar_u", "radar_v", "opt_flow")}
        lane = batch.get("lane_valid")
        host["lane_valid"] = (np.ones(host["pc1"].shape[0], bool)
                              if lane is None else np.asarray(lane, bool))
        return pack_eval_batch(host, wire, pin)

    use_dev_metrics = not writes_files
    sf_metric = {k: 0.0 for k in
                 ("rne", "50-50 rne", "mov_rne", "stat_rne", "sas", "ras",
                  "epe", "accs", "accr")}
    seg_metric = {"acc": 0.0, "miou": 0.0, "sen": 0.0}
    pose_metric = {"RTE": 0.0, "RAE": 0.0}
    num_pcs = 0

    clip_starts = set()
    clip_of_frame = {}
    for ci in dataset.clips_info or []:
        clip_starts.add(ci["index"][0])
        for i in range(ci["index"][0], ci["index"][1]):
            clip_of_frame[i] = ci["clip_name"]

    def fetch(out):
        """Start the copy of a batch's predictions to the host; returns
        them with an event that marks the copy's end (None on the CPU)."""
        pred_f, _, pred_t, pred_m = out[:4]
        host = [x.to("cpu", non_blocking=True) for x in (pred_f, pred_m,
                                                          pred_t)]
        done = None
        if device.type == "cuda":
            done = torch.cuda.Event()
            done.record()
        return host, done

    def consume(batch, fetched):
        """Fold one batch's host predictions into the host battery and
        write its result dumps."""
        nonlocal num_pcs
        (pred_f, pred_m, pred_t), done = fetched
        if done is not None:
            done.synchronize()
        pred_f, pred_m, pred_t = (x.numpy() for x in (pred_f, pred_m, pred_t))
        valid = np.asarray(batch["valid1"], bool)
        keep = valid.sum(1) > 0
        if "lane_valid" in batch:
            keep &= np.asarray(batch["lane_valid"], bool)
        frame_idx = batch.get("_frame_idx")  # lane-plan mode
        sel = np.nonzero(keep)[0]
        if sel.size:
            res = ev.eval_scene_flow_batch(
                batch["pc1"][sel], pred_f[sel], batch["labels"][sel],
                batch["mask"][sel], valid[sel])
            for k in sf_metric:
                sf_metric[k] += float(np.sum(res[k]))
            seg = ev.eval_motion_seg_batch(
                pred_m[sel].astype(np.float32), batch["mask"][sel],
                valid[sel])
            for k in seg_metric:
                seg_metric[k] += float(np.sum(seg[k]))
            pose = ev.eval_trans_rpe_batch(batch["trans"][sel], pred_t[sel])
            for k in pose_metric:
                pose_metric[k] += float(np.sum(pose[k]))
            num_pcs += int(sel.size)
        for bi in sel:
            bi = int(bi)
            fidx = (int(frame_idx[bi]) if frame_idx is not None
                    else num_pcs - int(sel.size) + int(np.sum(sel < bi)))
            nv = int(valid[bi].sum())
            pc1 = batch["pc1"][bi, :nv]
            if save_res_dir is not None:
                clip = clip_of_frame.get(fidx, "clip_0")
                cdir = os.path.join(save_res_dir, clip)
                os.makedirs(cdir, exist_ok=True)
                # reference stores [3, N] layouts (main_util.py:149-156)
                out = {
                    "pc1": pc1.T.tolist(),
                    "pc2": batch["pc2"][bi, :int(batch["valid2"][bi].sum())]
                           .T.tolist(),
                    "pred_f": pred_f[bi, :nv].T.tolist(),
                    "pred_m": pred_m[bi, :nv].astype(float).tolist(),
                    "pred_t": pred_t[bi].astype(float).tolist(),
                }
                with open(os.path.join(cdir, f"{fidx}.json"), "w") as fo:
                    json.dump(out, fo)
            if vis_dir is not None:
                os.makedirs(vis_dir, exist_ok=True)
                vis.plot_flow_bev(pc1, pred_f[bi, :nv], os.path.join(
                    vis_dir, f"{fidx}_flow.png"))
                vis.plot_seg_bev(pc1, pred_m[bi, :nv] > cfg.stat_thres,
                                 os.path.join(vis_dir, f"{fidx}_seg.png"))

    msums = torch.zeros(len(dmet.METRIC_KEYS), device=device)
    mcount = torch.zeros((), device=device)
    gfeat = None  # CMFlow_T's GRU carry, one row per lane
    pending = None  # one-deep dispatch/consume pipeline (save_res only)
    t_load = t_pack = t_disp = t_cons = t_first = t_stall = 0.0
    t_wall = time.perf_counter()
    t_mark = t_wall
    with torch.inference_mode():
        for i, (batch, packed, load_s, pack_s) in enumerate(
                _host_prefetch(loader, prep)):
            t_now = time.perf_counter()
            t_stall += t_now - t_mark  # main-thread wait on the prefetcher
            t_load += load_s           # worker-thread time (overlapped)
            t_pack += pack_s
            dev = upload_eval_batch(packed, device)
            if temporal:
                if gfeat is None:
                    gfeat = torch.zeros((dev["pc1"].shape[0],
                                         model.cfg.prop_width), device=device)
                if lane_plan is not None:
                    gfeat = reset_lanes(gfeat, dev["reset"])
                elif i in clip_starts or i % cfg.update_len == 0:
                    gfeat = torch.zeros_like(gfeat)
                out = eval_step(dev, gfeat)
                gfeat = out[4]
            else:
                out = eval_step(dev)
            if use_dev_metrics:
                pred_f, _, pred_t, pred_m = out[:4]
                keep = dev["lane_valid"] & (dev["valid1"].sum(1) > 0)
                vec = dmet.frame_metrics(
                    dev["pc1"], pred_f, dev["labels"], dev["mask"],
                    dev["valid1"], dev["trans"], pred_t, pred_m)
                msums, mcount = dmet.accumulate(msums, mcount, vec, keep)
            t_step = time.perf_counter() - t_now
            if i == 0:
                t_first = t_step
            else:
                t_disp += t_step
            t_now = time.perf_counter()
            if not use_dev_metrics:
                if pending is not None:
                    consume(*pending)
                pending = (batch, fetch(out))
            t_cons += time.perf_counter() - t_now
            t_mark = time.perf_counter()
        if pending is not None:
            consume(*pending)
        if use_dev_metrics:
            vec = torch.cat([msums, mcount[None]])
            if dp is not None:
                dist.all_reduce(vec, group=dp.group)
            # the one host read of the pass, which also ends it on the card
            vec = vec.cpu().numpy()
            num_pcs = int(vec[-1])
            slots = dict(zip(dmet.METRIC_KEYS, vec[:-1]))
            for d in (sf_metric, seg_metric, pose_metric):
                for k in d:
                    d[k] = float(slots[k])
    infer_time = time.perf_counter() - t_wall

    for d in (sf_metric, seg_metric, pose_metric):
        for k in d:
            d[k] /= max(num_pcs, 1)

    textio.cprint(
        "###The inference speed is %.3fms per frame###"
        % (infer_time * 1000 / max(num_pcs, 1))
    )
    # "h2d" is the worker's share of the upload: quantizing and pinning;
    # the non-blocking copies are issued with the dispatch
    textio.cprint(
        "eval wall breakdown: stall(load+upload wait) %.1fs  first-batch"
        "(compile) %.1fs  dispatch %.1fs  consume(fetch+metrics) %.1fs  "
        "total %.1fs  [prefetch worker: load %.1fs  h2d %.1fs]"
        % (t_stall, t_first, t_disp, t_cons, infer_time, t_load, t_pack))
    return sf_metric, seg_metric, pose_metric


# --------------------------------------------------------------------------
# training

def evaluate(cfg: Config, model, dataset, textio, dp=None,
             save_res_dir: Optional[str] = None,
             eval_step=None,
             vis_dir: Optional[str] = None) -> Tuple[Dict, Dict, Dict]:
    """:func:`evaluate_frames` of one process, or of a data-parallel run:
    sharded over the ranks where the eval-mesh rule allows it
    (:func:`_sharded_eval`), else on rank 0 alone with the metrics
    broadcast to every rank."""
    files = dict(save_res_dir=save_res_dir, vis_dir=vis_dir)
    writes_files = save_res_dir is not None or vis_dir is not None
    if dp is None or _sharded_eval(cfg, dp, writes_files):
        return evaluate_frames(cfg, model, dataset, textio,
                               eval_step=eval_step, dp=dp, **files)
    result = [None]
    if dp.rank == 0:
        result[0] = evaluate_frames(cfg, model, dataset, textio,
                                    eval_step=eval_step, **files)
    dist.broadcast_object_list(result, src=dist.get_global_rank(dp.group, 0),
                               group=dp.group)
    return result[0]


def train_experiment(cfg: Config, textio=None,
                     dp: Optional[DataParallel] = None) -> Dict:
    """Full training run (main.py:104-170).  Returns a summary dict.
    ``dp``: this rank of a data-parallel run (module docstring).  After
    every validation pass the lead process draws the loss and validation
    curves (:func:`draw_curves`)."""
    require_matplotlib_for_vis(cfg)
    exp_dir = experiment_dir(cfg, dp)
    lead = _lead(dp)
    log = textio or (IOStream(os.path.join(exp_dir, "run.log")) if lead
                     else NullStream())
    metrics_out = (MetricsWriter(os.path.join(exp_dir, "metrics.jsonl"))
                   if lead else NullStream())
    try:
        return _train(cfg, log, metrics_out, exp_dir, dp)
    finally:
        metrics_out.close()
        if textio is None:
            log.close()


def _train(cfg: Config, textio, metrics_out, exp_dir: str,
           dp: Optional[DataParallel]) -> Dict:
    device = _device(cfg, dp)
    group = None if dp is None else dp.group
    if dp is not None and cfg.batch_size % dp.size:
        raise ValueError(f"batch_size {cfg.batch_size} not divisible by the "
                         f"{dp.size}-rank data-parallel group")
    pin = device.type == "cuda"
    model = _build_model(cfg, device, group)
    train_ds, val_ds, _ = build_datasets(cfg, textio)
    temporal = cfg.dataset == "vodClipDataset"
    loader = BatchLoader(
        train_ds, cfg.batch_size, shuffle=True, drop_last=True,
        num_workers=cfg.num_workers, seed=cfg.seed,
        shard=None if dp is None else (dp.rank, dp.size),
    )
    state = create_train_state(
        model, steps_per_epoch=len(loader), lr=cfg.lr,
        weight_decay=cfg.weight_decay, decay_epochs=cfg.decay_epochs,
        decay_rate=cfg.decay_rate)
    if cfg.load_checkpoint and cfg.model_path:
        restore_checkpoint(cfg.model_path, state)
        textio.cprint(f"restored checkpoint from {cfg.model_path} (step "
                      f"{state.step}, next lr "
                      f"{state.optimizer.param_groups[0]['lr']})")
    if dp is not None:
        mesh.replicate(model, group)
        textio.cprint(f"data-parallel over {dp.size} ranks "
                      f"({dist.get_backend(group)}), "
                      f"{cfg.batch_size // dp.size} rows a rank")

    if temporal:
        # one optimizer and schedule step per frame: the schedule, counted
        # in clip batches above, decays mini_clip_len times per epoch, as
        # the JAX package's does
        step_fn = steplib.make_train_step_seq(
            model, train_ds.camera_projection_matrix,
            train_ds.t_camera_radar, cfg.vr_thres, model_name=cfg.model,
            group=group, nan_check=cfg.nan_check)
    else:
        step_fn = steplib.make_train_step(
            cfg.model, model, train_ds.camera_projection_matrix,
            train_ds.t_camera_radar, cfg.vr_thres, group=group,
            nan_check=cfg.nan_check)
    frames_per_batch = cfg.batch_size * (cfg.mini_clip_len if temporal
                                         else 1)
    best_rne = np.inf
    best_path = os.path.join(exp_dir, "models", "best")
    item_keys = LOSS_ITEMS[cfg.model]
    eval_step = make_experiment_eval_step(cfg, model)
    curves = {}

    for epoch in range(cfg.epochs):
        textio.cprint(f"==== epoch {epoch} ====")
        t0 = time.perf_counter()
        # loss items are summed on the device and read once per epoch: a
        # read per step would stall the host on the card every step
        sums_dev = None
        nb = 0
        t_wait = t_steps = 0.0
        batches = iter(loader)
        while True:
            t_a = time.perf_counter()
            batch = next(batches, None)
            t_b = time.perf_counter()
            t_wait += t_b - t_a
            if batch is None:
                break
            items = step_fn(state, {k: _host_tensor(v, pin)
                                    for k, v in batch.items()
                                    if k not in ("valid1", "valid2")})
            vec = torch.stack([items[k] for k in item_keys])
            sums_dev = vec if sums_dev is None else sums_dev + vec
            nb += 1
            t_steps += time.perf_counter() - t_b
        # the one read of the epoch, after every step: the wall clock below
        # spans the epoch's device work
        t_a = time.perf_counter()
        sums = (sums_dev.cpu().numpy() if sums_dev is not None
                else np.zeros(len(item_keys)))
        t_read = time.perf_counter() - t_a
        dt = time.perf_counter() - t0
        means = {k: float(sums[i]) / max(nb, 1)
                 for i, k in enumerate(item_keys)}
        textio.cprint(
            f"mean train loss: {means['Loss']:.6f} "
            f"({nb} steps, {dt:.1f}s, {nb * frames_per_batch / dt:.1f} "
            f"frames/s)"
        )
        # where the epoch's wall time went: waiting on the loader, issuing
        # the steps (the host's share; the device runs behind it), and the
        # one read, which waits for the device to finish
        textio.cprint(
            "train wall breakdown: load wait %.2fs  steps %.2fs  "
            "final read %.2fs" % (t_wait, t_steps, t_read))
        metrics_out.write({"epoch": epoch, "phase": "train", **means})

        sf, seg, pose = evaluate(cfg, model, val_ds, textio, dp,
                                 eval_step=eval_step)
        textio.cprint(f"mean RNE score: {sf['rne']:.6f}")
        metrics_out.write({"epoch": epoch, "phase": "val", **sf, **seg,
                           **pose})

        if sf["rne"] <= best_rne:
            best_rne = sf["rne"]
            _save(best_path, state, dp)
            textio.cprint(f"best val score till now: {best_rne:.6f}")
        if _lead(dp):
            draw_curves(exp_dir, textio, curves)

    _save(os.path.join(exp_dir, "models", "last"), state, dp)
    textio.cprint(f"==== best RNE after {cfg.epochs} epochs: {best_rne} ====")
    return {"best_rne": best_rne, "exp_dir": exp_dir}


def _save(path: str, state: TrainState, dp: Optional[DataParallel]) -> None:
    """Rank 0 writes the checkpoint; the other ranks wait for it."""
    if _lead(dp):
        save_checkpoint(path, state)
    if dp is not None:
        mesh.barrier(dp.group)


def eval_experiment(cfg: Config, textio=None,
                    dp: Optional[DataParallel] = None) -> Dict:
    """Evaluation run (main.py:51-69): restore ``cfg.model_path`` (or the
    experiment's ``models/best``), or warn and evaluate the random init.
    ``dp``: this rank of a data-parallel run (module docstring).  ``vis``:
    each test frame's BEV PNGs into ``test_vis/``."""
    require_matplotlib_for_vis(cfg)
    exp_dir = experiment_dir(cfg, dp)
    log = textio or (IOStream(os.path.join(exp_dir, "run.log"))
                     if _lead(dp) else NullStream())
    try:
        return _eval(cfg, log, exp_dir, dp)
    finally:
        if textio is None:
            log.close()


def _eval(cfg: Config, textio, exp_dir: str,
          dp: Optional[DataParallel]) -> Dict:
    device = _device(cfg, dp)
    model = _build_model(cfg, device)
    _, _, test_ds = build_datasets(cfg, textio)

    ckpt = cfg.model_path or os.path.join(exp_dir, "models", "best")
    if os.path.exists(ckpt):
        restore_checkpoint(ckpt, create_train_state(model))
        textio.cprint(f"restored checkpoint from {ckpt}")
    else:
        textio.cprint("WARNING: no checkpoint found, evaluating random init")

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    save_dir = os.path.join(exp_dir, "results") if cfg.save_res else None
    vis_dir = os.path.join(exp_dir, "test_vis") if cfg.vis else None
    sf, seg, pose = evaluate(cfg, model, test_ds, textio, dp,
                             save_res_dir=save_dir, vis_dir=vis_dir)
    for d in (sf, seg, pose):
        for k, v in d.items():
            textio.cprint(f"###The mean {k}: {v}###")
    if device.type == "cuda":
        peak = torch.cuda.max_memory_allocated(device) / 1e6
        textio.cprint(f"Max memory allocation: {peak:.1f}MB")
    return {"sf": sf, "seg": seg, "pose": pose}
