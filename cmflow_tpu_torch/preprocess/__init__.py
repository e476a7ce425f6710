"""The offline preprocessing: raw View-of-Delft frames -> flow samples
(copies of ``cmflow_tpu/preprocess``'s host modules, and the RAFT-small
optical-flow provider on the card).  ``vis_frame`` is not ported."""

from cmflow_tpu_torch.preprocess import boxes, flow_samples, optical_flow, vod_io
from cmflow_tpu_torch.preprocess.flow_samples import (
    SCENE_FLOW_SPLITS,
    build_sample,
    process_clip,
    run_preprocess,
)

__all__ = [
    "SCENE_FLOW_SPLITS",
    "boxes",
    "build_sample",
    "flow_samples",
    "optical_flow",
    "process_clip",
    "run_preprocess",
    "vod_io",
]
