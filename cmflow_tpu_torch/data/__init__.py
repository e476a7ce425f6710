"""Datasets, batch loader, sample schema and the synthetic scene generator
(copies of the JAX-free host modules of ``cmflow_tpu/data``)."""

from cmflow_tpu_torch.data.loader import BatchLoader
from cmflow_tpu_torch.data.packed import PackedVodDataset, packed_vod_dataset
from cmflow_tpu_torch.data.vod import VodClipDataset, VodDataset

DATASET_REGISTRY = {
    "vodDataset": VodDataset,
    "vodClipDataset": VodClipDataset,
    # the json tree packed into one memory-mapped file per split on first
    # use: no parse per sample
    "vodPackedDataset": packed_vod_dataset,
}

__all__ = ["BatchLoader", "DATASET_REGISTRY", "PackedVodDataset",
           "VodClipDataset", "VodDataset", "packed_vod_dataset"]
