"""Data parallelism over one process per card.

Counterpart of ``cmflow_tpu/parallel/mesh.py`` and of the ``shard_map``
wrapping of ``cmflow_tpu/train/steps.py``.  The JAX package runs one program
over a 1-D ``data`` mesh: the batch is sharded over the devices, the
parameters are replicated, and the gradients, loss items and BatchNorm
statistics are averaged with ``lax.pmean`` over the mesh axis.  Here each
card has a process of its own, and where the JAX code passes ``axis_name``
the port passes a ``torch.distributed`` process group (``None`` for one
process):

* :func:`setup` is ``make_mesh``: the process group, this rank's card and
  the backend (NCCL where every rank has a card of its own; gloo on the CPU
  and where ranks share a card, which NCCL refuses);
* :func:`shard_rows` / :func:`shard_batch` are ``shard_batch``: rank ``r``
  takes rows ``[r*B/G, (r+1)*B/G)`` of a global batch, the rows
  ``NamedSharding(P("data"))`` places on device ``r``;
* :func:`replicate` is ``replicate``: rank 0's parameters and buffers
  broadcast to every rank;
* :func:`all_reduce_sum` is ``psum`` with a gradient (its backward sums the
  cotangents over the ranks, as the transpose of ``psum`` does), and
  :func:`pmean_` is ``pmean`` of a list of tensors in one collective.

Only ``all_reduce``, ``broadcast`` and ``barrier`` are used: gloo takes all
three on CUDA tensors.
"""

from __future__ import annotations

import dataclasses
import os
import shutil
import tempfile
from typing import Callable, Dict, Iterable, List, Mapping, Optional, Tuple

import torch
import torch.distributed as dist

Tensor = torch.Tensor
Group = Optional[dist.ProcessGroup]

LAUNCHER_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK")


def size(group: Group) -> int:
    """The number of ranks ``G`` (1 without a group)."""
    return 1 if group is None else dist.get_world_size(group)


def rank(group: Group) -> int:
    """This process's rank in ``group`` (0 without a group)."""
    return 0 if group is None else dist.get_rank(group)


def shard_rows(x, group: Group):
    """Rank ``r``'s rows ``[r*B/G, (r+1)*B/G)`` of ``x`` (``[B, ...]``);
    ``B`` must divide by ``G``, so every rank holds as many rows (the pmean
    of the ranks' BatchNorm means is the global mean only then)."""
    g = size(group)
    b = x.shape[0]
    if b % g:
        raise ValueError(f"a batch of {b} rows does not divide over {g} ranks")
    r = rank(group)
    return x[r * b // g:(r + 1) * b // g]


def shard_batch(batch: Mapping, group: Group) -> Dict:
    """:func:`shard_rows` of every field of a global batch."""
    return {k: shard_rows(v, group) for k, v in batch.items()}


class _AllReduceSum(torch.autograd.Function):
    """``psum`` over the ranks; its backward is ``psum`` of the cotangents,
    so that the gradients averaged over the ranks afterwards are the global
    batch's through a statistic every rank shares."""

    @staticmethod
    def forward(ctx, x: Tensor, group: dist.ProcessGroup) -> Tensor:
        ctx.group = group
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g: Tensor):
        out = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=ctx.group)
        return out, None


def all_reduce_sum(x: Tensor, group: Group) -> Tensor:
    """The sum of ``x`` over the ranks, differentiable (``x`` itself
    without a group)."""
    return x if group is None else _AllReduceSum.apply(x, group)


def pmean_(tensors: List[Tensor], group: Group) -> None:
    """Average each tensor over the ranks in place, in one ``all_reduce`` of
    them all flattened into one buffer (nothing without a group)."""
    if group is None or not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    flat /= size(group)
    for t, part in zip(tensors, flat.split([t.numel() for t in tensors])):
        t.copy_(part.view_as(t))


def average_gradients(params: Iterable[torch.nn.Parameter],
                      group: Group) -> None:
    """``lax.pmean(grads)``: every rank's gradients replaced by their mean
    over the ranks, in one collective.  A parameter without a gradient has
    none on every rank (they run the same program) and is left out."""
    pmean_([p.grad for p in params if p.grad is not None], group)


def replicate(module: torch.nn.Module, group: Group) -> None:
    """Broadcast rank 0's parameters and buffers to every rank."""
    if group is None:
        return
    with torch.no_grad():
        for t in (*module.parameters(), *module.buffers()):
            dist.broadcast(t, src=dist.get_global_rank(group, 0), group=group)


def collective_device(group: dist.ProcessGroup) -> torch.device:
    """Where ``group``'s collectives take their tensors: the current card
    under NCCL, else the CPU."""
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def check_equal_rows(b: int, group: dist.ProcessGroup) -> None:
    """Raise unless every rank holds ``b`` rows: the mean over the ranks of
    their BatchNorm statistics is the global batch's only then."""
    rows = torch.tensor([b, -b], dtype=torch.float64,
                        device=collective_device(group))
    dist.all_reduce(rows, op=dist.ReduceOp.MAX, group=group)
    most, fewest = rows[0].item(), -rows[1].item()
    if most != b or fewest != b:
        raise ValueError(f"the ranks hold unequal batches: {b} rows here, "
                         f"{fewest:.0f} to {most:.0f} over the group")


def barrier(group: Group) -> None:
    if group is not None:
        dist.barrier(group=group)


@dataclasses.dataclass(frozen=True)
class DataParallel:
    """One rank of a data-parallel run: its process group, its card (or
    the CPU) and its local rank."""

    group: dist.ProcessGroup
    device: torch.device
    local_rank: int

    @property
    def rank(self) -> int:
        return dist.get_rank(self.group)

    @property
    def size(self) -> int:
        return dist.get_world_size(self.group)


def launcher_env() -> Optional[Tuple[int, int, int]]:
    """``(rank, world size, local rank)`` from a launcher's environment
    (``python -m torch.distributed.run``), or None outside one."""
    if not all(k in os.environ for k in LAUNCHER_ENV):
        return None
    return tuple(int(os.environ[k]) for k in LAUNCHER_ENV)


def backend_and_device(platform: str, local_world: int,
                       local_rank: int) -> Tuple[str, torch.device]:
    """The backend and this rank's device: gloo on the CPU (``platform:
    cpu``); NCCL where each of the host's ``local_world`` ranks has a card
    of its own; gloo where ranks share a card, which NCCL refuses."""
    if platform == "cpu":
        return "gloo", torch.device("cpu")
    cards = torch.cuda.device_count()
    if cards == 0:
        raise RuntimeError("no CUDA device is available for a data-parallel "
                           "rank; pass platform: cpu to run on the CPU")
    device = torch.device("cuda", local_rank % cards)
    return ("nccl" if local_world <= cards else "gloo"), device


def setup(rank_: int, world: int, local_rank: int, init_method: str,
          platform: str = "auto",
          local_world: Optional[int] = None) -> DataParallel:
    """Join a ``world``-rank process group as rank ``rank_`` (``local_world``
    ranks on this host, all of them by default) and pick this rank's card
    (``torch.cuda.set_device``).  Raises if the group cannot start: a
    data-parallel run never carries on as one process."""
    backend, device = backend_and_device(
        platform, world if local_world is None else local_world, local_rank)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=init_method, rank=rank_,
                            world_size=world)
    return DataParallel(group=dist.group.WORLD, device=device,
                        local_rank=local_rank)


def teardown() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def _spawned(local_rank: int, fn: Callable, args: tuple, world: int,
             init_file: str, platform: str) -> None:
    dp = setup(local_rank, world, local_rank, f"file://{init_file}", platform)
    try:
        fn(dp, *args)
    finally:
        teardown()


def spawn(fn: Callable, args: tuple, world: int,
          platform: str = "auto") -> None:
    """Run ``fn(dp, *args)`` in ``world`` new processes, one a rank, their
    group met through a file store in a temporary directory (no TCP port).
    ``fn`` must be importable by name (a module-level function): each rank
    starts from a fresh import.  Raises if any rank fails."""
    import torch.multiprocessing as mp

    tmp = tempfile.mkdtemp(prefix="cmflow_dp_")
    try:
        mp.start_processes(
            _spawned, args=(fn, args, world, os.path.join(tmp, "store"),
                            platform),
            nprocs=world, join=True, start_method="spawn")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
