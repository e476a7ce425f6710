"""Host-side batch loader with background prefetch.

Counterpart of ``cmflow_tpu/data/loader.py`` (the reference's
``torch.utils.data.DataLoader(num_workers=8)``, main.py:203-208): a thread
pool decodes json samples while the previous batch is on the device, and
batches come out as stacked numpy arrays (``[T, ...]`` mini-clip samples
stack to ``[B, T, ...]``).  Given the same dataset, seed and settings it
yields the JAX loader's batches bit for bit (at ``num_workers=0``; with
workers the dataset's shared subsample generator is drawn in thread order).
Moving a batch to the device is the caller's.

Data parallelism (``shard=(rank, ranks)``): every rank builds the same plan
of global batches from the same seed and decodes only its own rows of each,
rows ``[r*B/G, (r+1)*B/G)``, the rows the JAX loop's ``shard_batch`` puts on
device ``r``.  A training sample's subsample is then drawn from a generator
of its own, seeded with ``(seed, epoch, index)``: a rank does not decode
the samples before its rows, so it cannot draw from a generator they share,
and a run draws the same subsamples with any number of ranks and threads.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, List, Optional, Tuple

import numpy as np

from cmflow_tpu_torch.data.schema import Sample, bucket_size, collate, pad_to


class BatchLoader:
    """Iterate dict-batches over a dataset with optional shuffling,
    drop-last, static-bucket padding, and background prefetch."""

    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = False,
        drop_last: bool = False,
        pad_bucket: Optional[int] = None,
        pad_multiple: int = 128,
        pad_buckets: Optional[List[int]] = None,
        num_workers: int = 8,
        prefetch: int = 2,
        seed: int = 1234,
        pad_batch: bool = False,
        plan: Optional[List[dict]] = None,
        shard: Optional[Tuple[int, int]] = None,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.pad_bucket = pad_bucket
        self.pad_multiple = pad_multiple
        # explicit closed bucket set (ascending): every batch pads to one of
        # these N values and nothing else; a frame larger than the top
        # bucket fails loudly
        self.pad_buckets = sorted(pad_buckets) if pad_buckets else None
        self.num_workers = num_workers
        self.prefetch = prefetch
        self.pad_batch = pad_batch
        # an explicit batch plan (lane-batched temporal evaluation): each
        # entry is {"indices": [dataset index per lane], "lane_valid":
        # [bool per lane], "reset": [bool per lane]}; batches come in plan
        # order, padded as any other, with "lane_valid", "reset" and
        # "_frame_idx" attached
        self.plan = plan
        # (rank, ranks): this rank's rows of every global batch (module
        # docstring); the batches must split evenly
        self.shard = shard
        if shard is not None:
            rank, ranks = shard
            if not 0 <= rank < ranks or batch_size % ranks:
                raise ValueError(f"batch_size {batch_size} does not divide "
                                 f"over {ranks} ranks (rank {rank})")
            if plan is not None or not (drop_last or pad_batch):
                raise ValueError("a sharded loader takes whole batches: "
                                 "drop_last or pad_batch, and no plan")
        self.seed = seed
        self._epoch = 0
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        if self.plan is not None:
            return len(self.plan)
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _indices(self) -> np.ndarray:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            self._rng.shuffle(idx)
        return idx

    def _make_batch(self, indices: List[int]) -> Sample:
        samples = [self.dataset[i] for i in indices]
        n_real = len(samples)
        if self.pad_batch and n_real < self.batch_size:
            # pad the batch dimension with repeats of the last sample so a
            # short final batch keeps the batch's shape; "lane_valid" marks
            # the real lanes for the consumer
            samples = samples + [samples[-1]] * (self.batch_size - n_real)
        batch = self._pad_collate(samples)
        if self.pad_batch:
            batch["lane_valid"] = np.arange(len(samples)) < n_real
        return batch

    def _make_shard(self, job: Tuple[List[int], int]) -> Sample:
        """This rank's rows of the global batch ``indices`` (padded to the
        batch size with repeats of its last sample, as ``pad_batch`` pads),
        each sample decoded once, its subsample drawn from its own seeded
        generator."""
        indices, epoch = job
        n_real = len(indices)
        lanes = indices + [indices[-1]] * (self.batch_size - n_real)
        rank, ranks = self.shard
        rows = slice(rank * self.batch_size // ranks,
                     (rank + 1) * self.batch_size // ranks)
        decoded = {i: self.dataset.get(i, np.random.default_rng(
            (self.seed, epoch, i))) for i in set(lanes[rows])}
        batch = self._pad_collate([decoded[i] for i in lanes[rows]])
        if self.pad_batch:
            batch["lane_valid"] = (np.arange(self.batch_size) < n_real)[rows]
        return batch

    def _pad_collate(self, samples: List[Sample]) -> Sample:
        """Pad the samples to the batch's bucket and collate them."""
        if self.pad_buckets is not None:
            n_max = max(
                max(s["pc1"].shape[-2], s["pc2"].shape[-2]) for s in samples
            )
            fits = [b for b in self.pad_buckets if b >= n_max]
            if not fits:
                raise ValueError(
                    f"batch needs N={n_max} points but the pinned eval "
                    f"bucket set is {self.pad_buckets}; raise eval_buckets")
            samples = [pad_to(s, fits[0]) for s in samples]
        elif self.pad_bucket is not None:
            # shared static bucket across the batch: the max real count
            # rounded up, so the kernels see few distinct shapes
            n_max = max(
                max(s["pc1"].shape[-2], s["pc2"].shape[-2]) for s in samples
            )
            n = max(self.pad_bucket,
                    bucket_size(n_max, self.pad_multiple, self.pad_bucket))
            samples = [pad_to(s, n) for s in samples]
        return collate(samples)

    def _make_plan_batch(self, entry: dict) -> Sample:
        batch = self._make_batch(list(entry["indices"]))
        batch["lane_valid"] = np.asarray(entry["lane_valid"], bool)
        batch["reset"] = np.asarray(entry["reset"], bool)
        batch["_frame_idx"] = np.asarray(entry["indices"], np.int64)
        return batch

    def __iter__(self) -> Iterator[Sample]:
        if self.plan is not None:
            jobs = [(self._make_plan_batch, e) for e in self.plan]
        else:
            idx = self._indices()
            batches = [
                idx[i: i + self.batch_size]
                for i in range(0, len(idx), self.batch_size)
            ]
            if self.drop_last:
                batches = [b for b in batches if len(b) == self.batch_size]
            if self.shard is None:
                jobs = [(self._make_batch, list(b)) for b in batches]
            else:
                jobs = [(self._make_shard, ([int(i) for i in b], self._epoch))
                        for b in batches]
                self._epoch += 1

        if self.num_workers <= 0:
            for fn, arg in jobs:
                yield fn(arg)
            return

        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def producer():
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    # bounded in-flight window: keeps decoded-batch memory
                    # at O(workers + prefetch), not O(epoch)
                    window = self.num_workers + self.prefetch
                    pending = []
                    for fn, arg in jobs:
                        pending.append(pool.submit(fn, arg))
                        if len(pending) < window:
                            continue
                        if stop.is_set():
                            return
                        q.put(("item", pending.pop(0).result()))
                    for f in pending:
                        if stop.is_set():
                            return
                        q.put(("item", f.result()))
                q.put(("done", None))
            except BaseException as e:  # forward to the consumer; a dead
                q.put(("error", e))     # producer must never strand q.get()

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                kind, item = q.get()
                if kind == "error":
                    raise item
                if kind == "done":
                    break
                yield item
        finally:
            stop.set()
