"""bf16 serving against float32 on the card, from a trained checkpoint.

    python scripts/bf16_serving_torch.py --model cmflow \\
        --checkpoint checkpoints/conv_torch_cmflow_bfloat16/models/best \\
        --dataset_path build/conv_ds [--split val]

Restores a checkpoint of the experiment loop (its float32 parameters and
BatchNorm statistics, whichever ``compute_dtype`` trained them), serves
every frame pair of a split through ``make_eval_step`` on the fused engine
in float32 and in bf16 (``compute_dtype=torch.bfloat16``, the config's
``eval_compute_dtype: bfloat16``), in batches of 16 padded as the loop pads
them, and prints how far bf16 lies from float32 on the valid points beside
the JAX package's bf16 bars (``scripts/parity_tpu.py:41``): pre_trans 1e-2,
stat_cls 3e-2, motion masks agreeing on >= 99% of the points, sf_agg within
0.05 max(|sf|, 1) where the masks agree.  CMFlow_T serves each batch from a
zero carry, as at a clip's first frame.  It measures and holds nothing: one
JSON line per batch, then a summary with ``within_bars``.  Needs a CUDA
device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from cmflow_tpu_torch.data import BatchLoader, VodDataset  # noqa: E402
from cmflow_tpu_torch.models import build_model  # noqa: E402
from cmflow_tpu_torch.train import loop  # noqa: E402
from cmflow_tpu_torch.train.state import create_train_state  # noqa: E402
from cmflow_tpu_torch.train.steps import make_eval_step  # noqa: E402
from cmflow_tpu_torch.utils.config import load_config  # noqa: E402

BARS = {"trans": 1e-2, "cls": 3e-2, "agree": 0.99, "flow": 0.05}
BATCH = 16
# per family: the indices of (sf_agg, stat_cls or None, pre_trans, mask) in
# the eval step's outputs
OUTPUTS = {"cmflow": (0, 1, 2, 3), "raflow": (0, None, 2, 3),
           "cmflow_t": (0, 1, 2, 3)}


def compare(family: str, valid: np.ndarray, out, ref) -> dict:
    i_sf, i_cls, i_trans, i_mask = OUTPUTS[family]
    o, r = ([x.float().cpu().numpy() for x in y] for y in (out, ref))
    same = (o[i_mask] == r[i_mask]) & valid
    res = dict(trans_max_abs_err=float(np.abs(o[i_trans] - r[i_trans]).max()),
               flow_max_abs_err=float(np.abs(o[i_sf] - r[i_sf])[same].max()),
               flow_scale=max(float(np.abs(r[i_sf][valid]).max()), 1.0),
               mask_agreement=float(same[valid].mean()),
               valid_points=int(valid.sum()))
    if i_cls is not None:
        res["cls_max_abs_err"] = float(np.abs(o[i_cls] - r[i_cls])[valid].max())
    return res


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--model", required=True,
                   choices=["cmflow", "raflow", "cmflow_t"])
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--dataset_path", required=True)
    p.add_argument("--split", default="val")
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("bf16_serving_torch: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    dev = torch.device("cuda")
    cfg = load_config(f"configs/{args.model}.yaml")
    model = build_model(args.model, dev)
    loop.restore_checkpoint(args.checkpoint, create_train_state(model))
    ds = VodDataset(args.dataset_path, args.split, cfg.num_points,
                    eval_mode=True, log=lambda text: None)
    loader = BatchLoader(ds, BATCH, pad_bucket=cfg.num_points,
                         pad_buckets=loop._pinned_buckets(cfg),
                         num_workers=0)
    steps = {dt: make_eval_step(args.model, model, compute_dtype=dt)
             for dt in (torch.float32, torch.bfloat16)}
    rows = []
    with torch.no_grad():
        for i, batch in enumerate(loader):
            x = {k: v for k, v in batch.items() if not k.startswith("_")}
            b = x["pc1"].shape[0]
            carry = ((torch.zeros((b, model.cfg.prop_width), device=dev),)
                     if args.model == "cmflow_t" else ())
            out = {dt: step(x, *carry) for dt, step in steps.items()}
            res = compare(args.model, np.asarray(x["valid1"]),
                          out[torch.bfloat16], out[torch.float32])
            rows.append(res)
            print(json.dumps(dict(batch=i, frames=int(b),
                                  bucket=int(x["pc1"].shape[1]), **res)),
                  flush=True)
    summary = dict(
        model=args.model, checkpoint=args.checkpoint, split=args.split,
        card=card, frames=len(ds), batches=len(rows),
        trans_max_abs_err=max(r["trans_max_abs_err"] for r in rows),
        mask_agreement=float(sum(r["mask_agreement"] * r["valid_points"]
                                 for r in rows)
                             / sum(r["valid_points"] for r in rows)),
        mask_agreement_min=min(r["mask_agreement"] for r in rows),
        flow_max_abs_err_over_scale=max(r["flow_max_abs_err"] / r["flow_scale"]
                                        for r in rows))
    if OUTPUTS[args.model][1] is not None:
        summary["cls_max_abs_err"] = max(r["cls_max_abs_err"] for r in rows)
    summary["within_bars"] = bool(
        summary["trans_max_abs_err"] <= BARS["trans"]
        and summary.get("cls_max_abs_err", 0.0) <= BARS["cls"]
        and summary["mask_agreement_min"] >= BARS["agree"]
        and summary["flow_max_abs_err_over_scale"] <= BARS["flow"])
    summary["bars"] = BARS
    print(json.dumps(dict(summary=summary)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
