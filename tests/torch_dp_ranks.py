"""What each rank of the port's data-parallel CPU tests computes.

The ranks are new processes (``parallel/mesh.py::spawn``) that import this
module by name, so it imports the port and nothing of JAX.  Every rank
writes what it computed to ``<out>/rank<r>.pt``; the tests compare those
files with the JAX package's ``shard_map`` steps and with the port in one
process.  The inputs are drawn here from seeds, the same in every process.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from cmflow_tpu_torch.data import schema
from cmflow_tpu_torch.data.synthetic import (
    decode_sample,
    make_scene,
    make_train_batch,
)
from cmflow_tpu_torch.data.vod import VOD_CAMERA_PROJECTION, VOD_T_CAMERA_RADAR
from cmflow_tpu_torch.losses import radar_loss as rl
from cmflow_tpu_torch.models import build_model
from cmflow_tpu_torch.models.convert import export_flax_variables
from cmflow_tpu_torch.nn.blocks import BatchNorm
from cmflow_tpu_torch.parallel import mesh
from cmflow_tpu_torch.train.state import create_train_state
from cmflow_tpu_torch.train.steps import (
    make_eval_step,
    make_train_step,
    make_train_step_seq,
)

P, TCR = VOD_CAMERA_PROJECTION, VOD_T_CAMERA_RADAR
B, N = 4, 48  # the global batch: 2 rows a rank at G = 2
STEPS_PER_EPOCH = 10
MODEL_SEED = {"cmflow": 3, "raflow": 4, "cmflow_t": 5}
# the pair steps' batch: on make_train_batch(0, ...) float32 rounding flips
# kinks of the CMFlow loss, so that even the port's one-process gradient
# lies past the train bar from JAX's (tests/test_torch_parallel.py,
# measure_dp_gradients)
BATCH_SEED = 1
EVAL_SEED = 6
BN_C = 16


def bn_inputs():
    """A ``[B, 16, 8, C]`` input and a cotangent, with a BatchNorm's scale,
    bias and running statistics."""
    rs = np.random.RandomState(1)
    x = (rs.randn(B, 16, 8, BN_C) * 3 + 5).astype(np.float32)
    r = rs.randn(B, 16, 8, BN_C).astype(np.float32)
    scale = rs.uniform(0.5, 1.5, BN_C).astype(np.float32)
    bias = rs.randn(BN_C).astype(np.float32)
    mean = rs.randn(BN_C).astype(np.float32)
    var = rs.uniform(0.5, 2.0, BN_C).astype(np.float32)
    return x, r, scale, bias, mean, var


def loss_inputs():
    """Motion-segmentation probabilities and labels, ``[B, N]``."""
    rs = np.random.RandomState(2)
    pre = rs.uniform(0.05, 0.95, (B, N)).astype(np.float32)
    gt = (rs.uniform(size=(B, N)) < 0.3).astype(np.float32)
    return pre, gt


def global_ratio_inputs():
    """Per-row numerators and label counts, ``[B]``: the ranks' counts
    differ, so a ratio of local sums is not the global one."""
    return (np.array([0.5, 1.5, 4.0, 2.0], np.float32),
            np.array([1.0, 0.0, 6.0, 3.0], np.float32))


def train_batch(seed: int = BATCH_SEED):
    return make_train_batch(seed, B, N)


def clip(t: int):
    """A mini-clip of ``t`` copies of one frame, ``[B, T, ...]``, as the JAX
    package's data-parallel test repeats it."""
    batch = train_batch(7)
    return {k: np.repeat(v[:, None], t, axis=1) for k, v in batch.items()}


def eval_request():
    """B frames of 30-47 points, padded to one 48-point bucket."""
    rng = np.random.default_rng(EVAL_SEED)
    samples = []
    for _ in range(B):
        n1, n2 = (int(x) for x in rng.integers(30, N, size=2))
        samples.append(decode_sample(make_scene(rng, n1=n1, n2=n2), "val",
                                     eval_mode=True, num_points=N))
    return schema.collate([schema.pad_to(s, N) for s in samples])


def batchnorm(x, r, scale, bias, mean, var, group=None):
    """A train-mode :class:`BatchNorm` on ``x`` (this process's rows): its
    output, running statistics and input gradient of ``sum(y * r)``."""
    bn = BatchNorm(BN_C, group=group)
    with torch.no_grad():
        for t, v in ((bn.weight, scale), (bn.bias, bias),
                     (bn.running_mean, mean), (bn.running_var, var)):
            t.copy_(torch.from_numpy(v))
    xt = torch.from_numpy(x).requires_grad_(True)
    y = bn(xt, True)
    (y * torch.from_numpy(r)).sum().backward()
    return dict(y=y.detach().numpy(), mean=bn.running_mean.numpy().copy(),
                var=bn.running_var.numpy().copy(), dx=xt.grad.numpy())


def motion_seg(pre, gt, group=None):
    """``motion_seg_loss`` on this process's rows and its gradient."""
    p = torch.from_numpy(pre).requires_grad_(True)
    loss = rl.motion_seg_loss(p, torch.from_numpy(gt), group)
    loss.backward()
    return dict(loss=float(loss.detach()), grad=p.grad.numpy())


def train_one(name: str, batch, group=None, seq: bool = False):
    """One train step of model ``name`` (``seq``: a mini-clip step) from its
    seeded weights on ``batch`` (this process's rows): the items, the
    gradients before Adam (the last frame's, averaged over the ranks) and
    the variables after the step."""
    model = build_model(name, device="cpu", seed=MODEL_SEED[name],
                        group=group)
    state = create_train_state(model, steps_per_epoch=STEPS_PER_EPOCH)
    if seq:
        step = make_train_step_seq(model, P, TCR, model_name=name,
                                   group=group)
    else:
        step = make_train_step(name, model, P, TCR, group=group)
    items = step(state, batch)
    return dict(items={k: float(v) for k, v in items.items()},
                grads=export_flax_variables(model, grads=True)["params"],
                after=export_flax_variables(model), step=state.step)


def serve(fused: str, request):
    """The CMFlow eval step on ``request``, on ``fused``'s route."""
    model = build_model("cmflow", device="cpu", seed=MODEL_SEED["cmflow"])
    out = make_eval_step("cmflow", model, fused=fused)(request)
    return [t.float().numpy() for t in out]


def run_cases(group, part: str):
    """The cases of ``part`` on this process's rows: ``"pieces"`` (the
    BatchNorm, the motion-segmentation loss, the CMFlow step and the eval
    on both routes) or ``"families"`` (the RaFlow step, CMFlow_T's clip
    step at T=1 and T=2)."""
    shard = (lambda x: x) if group is None else (
        lambda x: mesh.shard_rows(x, group))
    rows = (lambda b: b) if group is None else (
        lambda b: mesh.shard_batch(b, group))
    if part == "families":
        return dict(
            raflow=train_one("raflow", rows(train_batch()), group),
            cmflow_t_t1=train_one("cmflow_t", rows(clip(1)), group, seq=True),
            cmflow_t_t2=train_one("cmflow_t", rows(clip(2)), group, seq=True))
    bn = [shard(a) for a in bn_inputs()[:2]] + list(bn_inputs()[2:])
    num, den = global_ratio_inputs()
    out = dict(
        global_ratio=float(rl._global_ratio(torch.tensor(
            float(shard(num).sum())), torch.tensor(float(shard(den).sum())),
            group)),
        batchnorm=batchnorm(*bn, group=group),
        motion_seg=motion_seg(*(shard(a) for a in loss_inputs()), group),
        cmflow=train_one("cmflow", rows(train_batch()), group))
    request = rows(eval_request())
    out["serve"] = {fused: serve(fused, request) for fused in ("off", "on")}
    if group is not None:  # a rank with another number of rows raises
        try:
            mesh.check_equal_rows(1 + mesh.rank(group), group)
        except ValueError:
            out["unequal_rows_raised"] = True
    return out


def rank_cases(dp: mesh.DataParallel, out_dir: str, part: str) -> None:
    """A rank's entry (``mesh.spawn``): the cases of ``part`` on its rows,
    saved."""
    torch.set_num_threads(1)
    torch.save(run_cases(dp.group, part),
               os.path.join(out_dir, f"rank{dp.rank}.pt"))


def rank_step(dp: mesh.DataParallel, out_dir: str, name: str,
              seed: int) -> None:
    """A rank's entry: one pair step of ``name`` on its rows of
    ``make_train_batch(seed, B, N)``, saved."""
    torch.set_num_threads(1)
    out = train_one(name, mesh.shard_batch(train_batch(seed), dp.group),
                    dp.group)
    torch.save(out, os.path.join(out_dir, f"rank{dp.rank}.pt"))


LOOP_STEPS = 5  # resume: three steps, a checkpoint, then two more


def snapshot(state) -> dict:
    """The bits a train state holds: parameters and statistics, Adam's
    moments and steps, the schedule, the step count."""
    opt = state.optimizer.state_dict()
    return dict(model={k: v.clone() for k, v in state.model.state_dict()
                       .items()},
                moments={f"{i}/{k}": v.clone()
                         for i, s in opt["state"].items()
                         for k, v in s.items()},
                scheduler=state.scheduler.state_dict(), step=state.step)


def same_bits(a: dict, b: dict) -> bool:
    return (a["step"] == b["step"] and a["scheduler"] == b["scheduler"]
            and all(sorted(a[k]) == sorted(b[k])
                    and all(torch.equal(a[k][n], b[k][n]) for n in a[k])
                    for k in ("model", "moments")))


def rank_loop(dp: mesh.DataParallel, cfg_kw: dict, ckpt_dir: str,
              one_process_ckpt: str) -> None:
    """A rank's entry for the loop's tests: a batch size that does not
    divide, one epoch of the loop, a checkpoint-resume at step level and
    the restore of a one-process checkpoint; what it saw, saved."""
    from cmflow_tpu_torch.train import loop
    from cmflow_tpu_torch.utils.config import Config

    torch.set_num_threads(1)
    out = {}
    try:
        loop.train_experiment(Config(**dict(cfg_kw, batch_size=3,
                                            exp_name="odd")), dp=dp)
    except ValueError as e:
        out["odd_batch"] = str(e)
    out["summary"] = loop.train_experiment(Config(**cfg_kw), dp=dp)

    def new_state():
        model = build_model("cmflow", "cpu", seed=0, group=dp.group)
        return create_train_state(model, steps_per_epoch=2, lr=1e-3,
                                  decay_rate=0.5)

    batches = [mesh.shard_batch(make_train_batch(s, B, 64), dp.group)
               for s in range(LOOP_STEPS)]
    path = os.path.join(ckpt_dir, "resume")
    state = new_state()
    step = make_train_step("cmflow", state.model, P, TCR, group=dp.group)
    for batch in batches[:3]:
        step(state, batch)
    loop._save(path, state, dp)
    for batch in batches[3:]:
        step(state, batch)
    straight = snapshot(state)
    state = loop.restore_checkpoint(path, new_state())
    step = make_train_step("cmflow", state.model, P, TCR, group=dp.group)
    for batch in batches[3:]:
        step(state, batch)
    out["resumed_same_bits"] = same_bits(snapshot(state), straight)
    out["final"] = straight
    one = loop.restore_checkpoint(one_process_ckpt, new_state())
    payload = torch.load(one_process_ckpt, map_location="cpu",
                         weights_only=True)
    out["one_process_restored"] = all(
        torch.equal(v, payload["model"][k])
        for k, v in one.model.state_dict().items())
    torch.save(out, os.path.join(ckpt_dir, f"rank{dp.rank}.pt"))
