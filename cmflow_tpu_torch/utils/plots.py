"""Training-curve plots (plot_loss_epoch main_util.py:280-295 and the
train/val summary PNGs main.py:156-168), fed from the run's
``metrics.jsonl``.  Counterpart of ``cmflow_tpu/utils/plots.py``; host-side
matplotlib, imported when a figure is drawn, so the package imports without
it (:func:`have_matplotlib`)."""

from __future__ import annotations

import json
import os
from typing import Dict, List


def have_matplotlib() -> bool:
    """Whether matplotlib imports here (the figures need it)."""
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        return False
    return True


def _read_metrics(metrics_path: str) -> List[Dict]:
    if not os.path.exists(metrics_path):
        return []
    out = []
    with open(metrics_path) as f:
        for line in f:
            try:
                out.append(json.loads(line))
            except json.JSONDecodeError:
                continue
    return out


_LOSS_STYLE = {
    "Loss": "b", "chamferLoss": "k", "veloLoss": "g",
    "smoothnessLoss": "c", "egoLoss": "m", "maskLoss": "r",
    "opticalLoss": "y", "superviseLoss": "r",
}


def plot_loss_curves(metrics_path: str, out_dir: str) -> None:
    """Per-loss-term training curves."""
    import matplotlib

    matplotlib.use("Agg")
    from matplotlib import pyplot as plt

    rows = [r for r in _read_metrics(metrics_path)
            if r.get("phase") == "train"]
    if not rows:
        return
    os.makedirs(out_dir, exist_ok=True)
    plt.figure()
    names = [k for k in _LOSS_STYLE if k in rows[0]]
    for k in names:
        plt.plot([r[k] for r in rows], _LOSS_STYLE[k])
    plt.legend(names, loc="upper right")
    plt.xlabel("epoch")
    plt.ylabel("loss")
    plt.savefig(os.path.join(out_dir, "loss_train.png"), dpi=200)
    plt.close()


def plot_val_score(metrics_path: str, out_dir: str,
                   key: str = "rne") -> None:
    """Validation-score curve (best-model selection metric)."""
    import matplotlib

    matplotlib.use("Agg")
    from matplotlib import pyplot as plt

    rows = [r for r in _read_metrics(metrics_path)
            if r.get("phase") == "val" and key in r]
    if not rows:
        return
    os.makedirs(out_dir, exist_ok=True)
    plt.figure()
    plt.plot([r[key] for r in rows], "r")
    plt.legend([f"val_{key}"])
    plt.xlabel("epoch")
    plt.ylabel(key)
    plt.savefig(os.path.join(out_dir, "val_score.png"), dpi=200)
    plt.close()
