"""Offline preprocessing CLI, the counterpart of
``cmflow_tpu/cli/preprocess.py`` (the reference's preprocess_vod.py):

    python -m cmflow_tpu_torch.cli.preprocess --root_dir <vod_root> \\
        --save_dir <out> --clips_dir <clips> \\
        --pseudo_label_path <mot_labels> --true_label_path <gt_labels> \\
        [--raft_weights raft-small.pth] [--no_optical_flow] [--platform cpu]

It writes ``<save_dir>/flow_smp/<split>/<clip>/<f1>_<f2>.json``.  The train
split's camera flow comes from RAFT-small on the GPU unless ``--platform
cpu`` is given; without a GPU and without that flag it raises.
:func:`main` takes the arguments as a list and returns 0.
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="VoD scene-flow preprocessing")
    p.add_argument("--root_dir", required=True)
    p.add_argument("--save_dir", required=True)
    p.add_argument("--clips_dir", required=True)
    p.add_argument("--pseudo_label_path", required=True)
    p.add_argument("--true_label_path", required=True)
    p.add_argument("--raft_weights", default=None,
                   help="torch raft-small.pth checkpoint for camera flow")
    p.add_argument("--no_optical_flow", action="store_true")
    p.add_argument("--platform", default="auto", choices=["auto", "cpu"],
                   help="auto: RAFT on the GPU (raises without one); cpu: "
                        "on the CPU")
    return p.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> int:
    args = parse_args(argv)

    from cmflow_tpu_torch.preprocess.flow_samples import run_preprocess
    from cmflow_tpu_torch.preprocess.optical_flow import (
        RaftSmallProvider,
        ZeroFlowProvider,
    )

    if args.no_optical_flow:
        provider = ZeroFlowProvider()
    else:
        provider = RaftSmallProvider(
            args.raft_weights,
            device="cpu" if args.platform == "cpu" else None)

    run_preprocess(
        root_dir=args.root_dir,
        save_dir=args.save_dir,
        clips_dir=args.clips_dir,
        pseudo_label_path=args.pseudo_label_path,
        true_label_path=args.true_label_path,
        opt_provider=provider,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
