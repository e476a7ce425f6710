"""Experiment logging: run.log tee, metrics JSONL and experiment dirs
(main.py:25-48 equivalents).  A copy of ``cmflow_tpu/utils/logging.py``."""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Any, Dict, Optional


class IOStream:
    """Print-and-append logger (main.py:25-35)."""

    def __init__(self, path: str):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        self.f = open(path, "a")

    def cprint(self, text: str) -> None:
        print(text)
        self.f.write(text + "\n")
        self.f.flush()

    def close(self) -> None:
        self.f.close()


class NullStream:
    """What a data-parallel rank other than 0 logs to: nothing (rank 0
    alone writes ``run.log`` and ``metrics.jsonl``)."""

    def cprint(self, text: str) -> None:
        pass

    def write(self, record: Dict[str, Any]) -> None:
        pass

    def close(self) -> None:
        pass


class MetricsWriter:
    """Structured metrics sink: one JSON object per line."""

    def __init__(self, path: str):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        self.f = open(path, "a")

    def write(self, record: Dict[str, Any]) -> None:
        record = dict(record, ts=time.time())
        self.f.write(json.dumps(record) + "\n")
        self.f.flush()

    def close(self) -> None:
        self.f.close()


def init_experiment_dir(checkpoints_dir: str, exp_name: str,
                        config_obj: Optional[Any] = None) -> str:
    """Create checkpoints/<exp>/{models,loss_train,results} and snapshot the
    config (main.py:38-48)."""
    exp = os.path.join(checkpoints_dir, exp_name)
    for sub in ("models", "loss_train", "results"):
        os.makedirs(os.path.join(exp, sub), exist_ok=True)
    if config_obj is not None:
        with open(os.path.join(exp, "config.json"), "w") as f:
            json.dump(dataclasses.asdict(config_obj), f, indent=2)
    return exp
