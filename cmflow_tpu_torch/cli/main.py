"""CLI entry point, the counterpart of ``cmflow_tpu/cli/main.py`` (the
reference's ``main.py``):

    python -m cmflow_tpu_torch.cli.main [--eval] [--save_res]
        --dataset_path ... --exp_name ... [--config configs/cmflow.yaml]
        [--platform cpu]

It runs on the GPU unless ``--platform cpu`` is given, and raises where
there is none.  :func:`main` takes the arguments as a list and returns 0, so
it can be called in-process.

Data parallelism (``data_parallel: true``, the default), as the JAX CLI's
one command uses every local device:

* under a launcher (``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK`` set, e.g.
  ``python -m torch.distributed.run --nproc_per_node=G -m
  cmflow_tpu_torch.cli.main ...``) each process joins the launcher's group
  as one rank, on the card of its local rank (several ranks may share one
  card: they then talk through gloo);
* without one, with G > 1 visible cards, it builds the kernels and starts
  one rank per card itself;
* with one card (or ``--platform cpu``) and no launcher it runs as one
  process, with no group.

A group that cannot start raises: the run never carries on as one process.

``nan_check`` turns on autograd's anomaly mode for the run and has every
step check for NaN (``train/steps.py``), as the JAX CLI sets
``jax_debug_nans``; ``profile_dir`` traces the whole run with
``torch.profiler`` (CPU and, on the card, CUDA activities) and writes a
Chrome trace there when the run ends or fails, ``trace.json`` (a
data-parallel rank: ``trace_rank<r>.json``), as the JAX CLI stops its trace
in a ``finally``.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys
from typing import Iterator, List, Optional

import numpy as np
import torch

from cmflow_tpu_torch.parallel import mesh
from cmflow_tpu_torch.utils.config import Config, load_config


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Radar scene flow (PyTorch)")
    p.add_argument("--config", type=str, default=None,
                   help="flat YAML config (reference configs.yaml keys)")
    p.add_argument("--eval", action="store_true", default=None)
    p.add_argument("--vis", action="store_true", default=None)
    p.add_argument("--save_res", action="store_true", default=None)
    p.add_argument("--load_checkpoint", action="store_true", default=None,
                   help="resume training from --model_path")
    p.add_argument("--dataset_path", type=str, default=None)
    p.add_argument("--exp_name", type=str, default=None)
    p.add_argument("--checkpoints_dir", type=str, default=None)
    p.add_argument("--model", type=str, default=None,
                   choices=[None, "raflow", "cmflow", "cmflow_t"])
    p.add_argument("--dataset", type=str, default=None,
                   choices=[None, "vodDataset", "vodClipDataset",
                            "vodPackedDataset"])
    p.add_argument("--model_path", type=str, default=None)
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--num_workers", type=int, default=None)
    p.add_argument("--platform", type=str, default=None,
                   choices=[None, "auto", "cpu"],
                   help="auto: the GPU (raises without one); cpu: the CPU")
    p.add_argument("--compute_dtype", type=str, default=None,
                   choices=[None, "float32", "bfloat16"],
                   help="the model's compute dtype: training, and its "
                        "module route in eval")
    p.add_argument("--eval_compute_dtype", type=str, default=None,
                   choices=[None, "float32", "bfloat16"],
                   help="serving dtype of the fused engine (validation "
                        "and --eval)")
    p.add_argument("--remat", default=None, nargs="?", const=True,
                   choices=[True, "dots"],
                   type=lambda v: True if v in ("1", "true", "full") else v,
                   help="recompute the encoder branches and the cost "
                        "volume in backward (bare flag = all of them; "
                        "'dots' keeps the neighbour indices, gathers and "
                        "products and recomputes only BatchNorm/activation "
                        "chains)")
    p.add_argument("--nan_check", action="store_true", default=None,
                   help="raise FloatingPointError at the first NaN a step "
                        "holds (anomaly mode on for the run)")
    p.add_argument("--profile_dir", type=str, default=None,
                   help="write a torch.profiler trace of the run here")
    p.add_argument("--eval_wire", type=str, default=None,
                   choices=[None, "float32", "int16"],
                   help="eval host->device wire format (int16 quantizes "
                        "each frame's float fields to a per-frame scale)")
    p.add_argument("--eval_batch_size", type=int, default=None,
                   help="frames per batch at eval")
    return p.parse_args(argv)


@contextlib.contextmanager
def instrumented(cfg: Config, dp: Optional[mesh.DataParallel],
                 textio) -> Iterator[None]:
    """The run's ``nan_check`` (anomaly mode) and ``profile_dir`` (a
    ``torch.profiler`` trace written in a ``finally``); see the module
    docstring."""
    with contextlib.ExitStack() as stack:
        if cfg.nan_check:
            stack.enter_context(torch.autograd.set_detect_anomaly(True))
        prof = None
        if cfg.profile_dir:
            from torch.profiler import ProfilerActivity, profile

            activities = [ProfilerActivity.CPU]
            if cfg.platform != "cpu" and torch.cuda.is_available():
                activities.append(ProfilerActivity.CUDA)
            prof = profile(activities=activities)
            prof.start()
        try:
            yield
        finally:
            if prof is not None:
                prof.stop()
                os.makedirs(cfg.profile_dir, exist_ok=True)
                name = ("trace.json" if dp is None
                        else f"trace_rank{dp.rank}.json")
                path = os.path.join(cfg.profile_dir, name)
                prof.export_chrome_trace(path)
                textio.cprint(f"profiler trace: {path}")


def run(dp: Optional[mesh.DataParallel], cfg: Config) -> None:
    """One process's run: the whole run, or rank ``dp.rank`` of a
    data-parallel one (rank 0 alone writes and prints)."""
    from cmflow_tpu_torch.train.loop import (
        eval_experiment,
        experiment_dir,
        train_experiment,
    )
    from cmflow_tpu_torch.utils.logging import IOStream, NullStream

    np.random.seed(cfg.seed)
    lead = dp is None or dp.rank == 0
    if dp is not None and dp.device.type == "cuda":
        # one build a host, before any rank launches a kernel
        if dp.local_rank == 0:
            from cmflow_tpu_torch.native import build

            build.build()
        mesh.barrier(dp.group)
    exp_dir = experiment_dir(cfg, dp)
    textio = (IOStream(os.path.join(exp_dir, "run.log")) if lead
              else NullStream())
    try:
        textio.cprint(str(cfg))
        with instrumented(cfg, dp, textio):
            if cfg.eval:
                eval_experiment(cfg, textio, dp)
            else:
                train_experiment(cfg, textio, dp)
    finally:
        textio.close()
    if lead:
        print("FINISH")


def main(argv: Optional[List[str]] = None) -> int:
    args = parse_args(argv)
    overrides = {k: v for k, v in vars(args).items()
                 if k != "config" and v is not None}
    cfg = load_config(args.config, overrides)

    launched = mesh.launcher_env()
    if launched is not None:
        rank, world, local_rank = launched
        if not cfg.data_parallel and world > 1:
            raise ValueError(f"launched as {world} ranks with "
                             "data_parallel: false")
        local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
        dp = mesh.setup(rank, world, local_rank, "env://", cfg.platform,
                        local_world)
        try:
            run(dp, cfg)
        finally:
            mesh.teardown()
        return 0
    cards = torch.cuda.device_count() if cfg.platform != "cpu" else 0
    if cfg.data_parallel and cards > 1:
        from cmflow_tpu_torch.native import build

        build.build()
        mesh.spawn(run, (cfg,), cards, cfg.platform)
        return 0
    run(None, cfg)
    return 0


if __name__ == "__main__":
    sys.exit(main())
