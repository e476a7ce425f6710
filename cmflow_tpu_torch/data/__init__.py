"""Datasets, batch loader, sample schema and the synthetic scene generator
(copies of the JAX-free host modules of ``cmflow_tpu/data``)."""

from cmflow_tpu_torch.data.loader import BatchLoader
from cmflow_tpu_torch.data.vod import VodClipDataset, VodDataset


def _not_ported(name: str, item: str):
    def build(*args, **kwargs):
        raise NotImplementedError(
            f"dataset {name!r} is not ported yet (ROADMAP Queue 1, {item})")
    return build


DATASET_REGISTRY = {
    "vodDataset": VodDataset,
    "vodClipDataset": VodClipDataset,
    "vodPackedDataset": _not_ported("vodPackedDataset", "item 8"),
}

__all__ = ["BatchLoader", "DATASET_REGISTRY", "VodClipDataset", "VodDataset"]
