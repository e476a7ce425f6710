"""Optimizer and train state, as the reference trains.

Counterpart of ``cmflow_tpu/train/state.py``.  Reference: Adam(lr=1e-3,
weight_decay=1e-4) with StepLR(step=decay_epochs, gamma=decay_rate)
(main.py:107-108, configs.yaml:8-11).  ``torch.optim.Adam``'s weight decay
adds ``wd * param`` to the gradient before the moments, which is what the
JAX package builds as ``optax.add_decayed_weights`` then ``optax.adam``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
from torch.optim.lr_scheduler import LambdaLR


def make_optimizer(model: torch.nn.Module, lr: float = 1e-3,
                   weight_decay: float = 1e-4, decay_epochs: int = 1,
                   decay_rate: float = 0.9,
                   steps_per_epoch: Optional[int] = None
                   ) -> Tuple[torch.optim.Adam, LambdaLR]:
    """Adam with L2 weight decay over ``model``'s parameters, and a
    staircase schedule: optimizer step ``i`` (from 0) takes
    ``lr * decay_rate ** (i // (decay_epochs * steps_per_epoch))``, constant
    ``lr`` when ``steps_per_epoch`` is None.  Step the scheduler once after
    every optimizer step."""
    opt = torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999),
                           eps=1e-8, weight_decay=weight_decay)
    if steps_per_epoch:
        period = decay_epochs * steps_per_epoch
        schedule = LambdaLR(opt, lambda i: decay_rate ** (i // period))
    else:
        schedule = LambdaLR(opt, lambda i: 1.0)
    return opt, schedule


@dataclasses.dataclass
class TrainState:
    """What a train step updates in place: the model's parameters and
    BatchNorm statistics, the optimizer's moments, the schedule, and the
    count of optimizer steps taken."""

    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    scheduler: LambdaLR
    step: int = 0


def create_train_state(model: torch.nn.Module,
                       steps_per_epoch: Optional[int] = None,
                       **optimizer_kw) -> TrainState:
    """``TrainState`` of ``model`` with :func:`make_optimizer`'s Adam and
    schedule (``optimizer_kw``: ``lr``, ``weight_decay``, ``decay_epochs``,
    ``decay_rate``)."""
    opt, schedule = make_optimizer(model, steps_per_epoch=steps_per_epoch,
                                   **optimizer_kw)
    return TrainState(model=model, optimizer=opt, scheduler=schedule)
