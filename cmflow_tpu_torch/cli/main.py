"""CLI entry point, the counterpart of ``cmflow_tpu/cli/main.py`` (the
reference's ``main.py``):

    python -m cmflow_tpu_torch.cli.main [--eval] [--save_res]
        --dataset_path ... --exp_name ... [--config configs/cmflow.yaml]
        [--platform cpu]

It runs on the GPU unless ``--platform cpu`` is given, and raises where
there is none.  :func:`main` takes the arguments as a list and returns 0, so
it can be called in-process.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import List, Optional

import numpy as np

from cmflow_tpu_torch.utils.config import load_config


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
                   help="recompute grouped chains in backward (not ported)")
    p.add_argument("--eval_wire", type=str, default=None,
                   choices=[None, "float32", "int16"],
                   help="eval host->device wire format (int16 quantizes "
                        "each frame's float fields to a per-frame scale)")
    p.add_argument("--eval_batch_size", type=int, default=None,
                   help="frames per batch at eval")
    return p.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> int:
    args = parse_args(argv)
    overrides = {k: v for k, v in vars(args).items()
                 if k != "config" and v is not None}
    cfg = load_config(args.config, overrides)

    np.random.seed(cfg.seed)

    from cmflow_tpu_torch.train.loop import eval_experiment, train_experiment
    from cmflow_tpu_torch.utils.logging import IOStream, init_experiment_dir

    exp_dir = init_experiment_dir(cfg.checkpoints_dir, cfg.exp_name, cfg)
    textio = IOStream(os.path.join(exp_dir, "run.log"))
    try:
        textio.cprint(str(cfg))
        if cfg.eval:
            eval_experiment(cfg, textio)
        else:
            train_experiment(cfg, textio)
    finally:
        textio.close()
    print("FINISH")
    return 0


if __name__ == "__main__":
    sys.exit(main())
