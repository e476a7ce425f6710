#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of CMFlow on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA GPU and nvcc.  Steps:

1. print the card's name and power limit (nvidia-smi);
2. build every CUDA kernel of ``cmflow_tpu_torch/csrc`` with nvcc, one
   process per source, all at once, timed;
3. for each kernel, at every shape the two eval routes give it (B=16 at the
   256 bucket, and the padded 384 bucket with valid masks), hold it to its
   plain PyTorch version on the same inputs: the ball query, kNN and the
   gather exactly; the fused kernels (sa encoder, cost volume, propagation
   encoder) to a max abs error of 1e-4 and of 1e-5 times the output's
   largest magnitude, since they sum float32 products in another order,
   and the tensor-core kernels (sa encoder, the cost volume's first,
   propagation encoder) and the cost volume's second to themselves bit for
   bit across two runs.
   Time the kernel, the plain version and, where one exists, a single
   PyTorch call computing the same function, by their device time: the
   kernels' own durations from ``torch.profiler`` over warmed calls, so
   that the host's time to issue a short kernel does not count.  A
   kernel's time is its own (the gather's backward: its two kernels, the
   CSR build and the piece sum, each also on its own, and exactly two
   kernels a call; the sa encoder's bf16 arm: at most two kernels a call,
   the centroids' mean and the kernel, its whole call's time beside); beside
   it stand the device time of every
   kernel its wrapper launches (the folds and weight packing included)
   and the CUDA-event time of back-to-back wrapper calls, in the summary
   where they differ from it by more than 10%.  For the cost volume
   and the propagation encoder also cuBLAS float32 on the same products
   alone, a yardstick the port never calls.  For the three tensor-core
   kernels a second bound for their arithmetic (3xTF32: three TF32
   products per product); count their tensor-core instructions (``HGMMA``
   for ``wgmma``, ``HMMA`` for the sa encoder's ``mma.sync``) in the built
   libraries' SASS (``cuobjdump``) beside registers, spills and shared
   memory from the ``ptxas -v`` logs, and require some;
4. serve four requests of synthetic frames (decoded, padded to their
   bucket, collated; B=16: three at the 256 bucket, one at the 384 bucket)
   through ``make_eval_step`` with a full-width CMFlow whose weights come
   from a seeded generator and whose BatchNorm statistics are seeded random.
   On the card the step takes the fused engine; require its launches per
   forward (ball query 2, kNN 2, sa encoder 2, cost volume 1 + 1,
   propagation encoder 4, gather 0), finite outputs, and agreement of the
   first request with the same forward on the CPU and with the card's
   module route: stat_cls and sf_agg atol 1e-4, pre_trans atol 5e-4, motion
   masks agreeing on >= 99% of valid points (compared on valid points);
5. serve one request per bucket on the module route (``fused="off"``):
   launches per forward ball query 12, kNN 2, gather 16, the first request
   held to the CPU at the same bars;
5b. bf16 serving (``compute_dtype=torch.bfloat16``, the JAX package's
   ``eval_compute_dtype: bfloat16``): hold the bf16 arms of the sa encoder,
   both cost-volume kernels and the propagation encoder to their plain
   versions at every shape of the bf16 forward (B=16, both buckets, masked)
   within 1e-2 of the output's largest magnitude (the cost volume's second
   arm, whose WeightNet and sums stay float32, within the float32 kernels'
   bars), and to themselves bit for bit; time them as above, beside cuBLAS
   on bf16 operands with float32 sums on the cost volume's and the
   propagation encoder's products, and bound them at the dense bf16 peak
   (989 TFLOP/s); require a tensor-core instruction of a bf16 type in their
   SASS (``HGMMA.*BF16``, ``HMMA.*BF16``), and no note of ptxas's that it
   serialises the ``wgmma``s of the propagation encoder's and the cost
   volume's first bf16 arms; hold those two arms past the neighbour counts
   their float32 siblings take (K=129 and k=65, a query's rows over two
   tiles) to their plain versions and to themselves; measure, without a
   bar, how far the bf16 forward of this model with random weights lies
   from its float32 one (far, in JAX as here: ROADMAP Queue 3); time one
   whole fused forward in each dtype (device time and CUDA operations);
6. hold the gather's backward (K7) to its plain version at every shape the
   train step gives it (B=16, N=256: the sa encoder's C=32 and the
   propagation encoder's C=512 at K = 4, 8, 16, 32, the cost volume's C=512
   at k=8, the smoothness loss's C=3 at k=8) within 1e-5 of the output's
   largest magnitude, and to itself bit for bit across two runs; time it,
   the plain version and ``index_add_`` on the card, a yardstick the port
   never calls; hold its CSR build (``gather_rows_csr``) to its plain
   version exactly at the same shapes; hold the ball query to its plain
   version at the train step's shapes (one radius per launch, no masks) and
   time it.  Hold the ball query and kNN exactly to their plain versions at
   one B=16 cloud of 4,096 points, masked and not (two staged tiles; not
   timed), and the cost volume's second kernel, both arms, to its plain
   version and to itself bit for bit at one B=16, N=384 cloud with k=33,
   past the first kernel's K <= 32, masked, some indices out of range (not
   timed);
7. train: a full-width CMFlow with seeded random weights takes train steps
   (``make_train_step``) on one synthetic B=16, N=256 batch
   (``make_train_batch``, VoD calibration).  The first step is taken on the
   card and on a CPU copy of the model and compared: loss items rtol 1e-4,
   BatchNorm statistics atol 1e-5, parameters after the Adam step atol
   5e-3, each gradient leaf within a relative L2 error of 3e-2 and the whole
   gradient within 1e-2 (a max over neighbours makes single gradient
   entries jump with float32 rounding; see tests/test_torch_train.py).
   Twelve steps in all, each with its launches (ball query 12, kNN 2,
   gather 17, gather backward 15, the fused kernels 0), finite loss items,
   its wall time and frames/s; the last Loss below the first;
8. run the experiment loop through its CLI (``cmflow_tpu_torch.cli.main``,
   in-process, ``configs/cmflow.yaml``, full width) on a synthetic tree in a
   temporary directory (``write_synthetic_dataset``: train 64, val 32, test
   32 frames of 200-319 points): train 2 epochs at B=16, N=256, each with a
   validation pass at the config's ``eval_batch_size`` of 64 (one batch of
   32 frames and 32 repeated lanes, int16 wire); require the launches of
   exactly 8 train steps on the module route (ball query, kNN, gather,
   gather backward) and 2 fused forwards (ball query, kNN, sa encoder, cost
   volume, propagation encoder), finite losses and metrics in
   ``metrics.jsonl``; restore ``models/best`` and require the saved bits;
   resume one epoch from ``models/last`` (``--load_checkpoint``) and require
   the step count, Adam's steps and the learning rate to go on from the
   saved ones; evaluate ``--save_res`` from ``best`` and require one result
   file per test frame and 14 finite means; evaluate ``best`` again with
   ``--eval_compute_dtype bfloat16`` (the same launches on the kernels' bf16
   arms), 14 finite means, its RNE within 5% of the float32 eval's; then on
   one B=64 test batch as the loop forms it hold each fused kernel to its
   plain version (timed by CUDA events around back-to-back calls), the
   device metric battery to the host battery on the same predictions (atol
   1e-4), and the fused route to the module route on the card at the
   serving bars; print the loop's own train frames/s, eval ms per frame and
   peak memory beside the card's name and power limit; serve three B=16
   requests (256, 256, 384) in bf16 from the same checkpoint, launches
   2/2/2/1/1/4 a forward, each held to its float32 forward on the card and
   the first to the CPU's bf16 route at the JAX package's bf16 bars
   (stat_cls 3e-2, pre_trans 1e-2, masks on >= 99% of the valid points,
   sf_agg within 0.05 of max(|sf|, 1) where the masks agree);
9. the other families, full width, B=16: RaFlow and CMFlow_T serve three
   requests (CMFlow_T three frames with the carry and resets) on the fused
   route, held to the module route and to the CPU at the serving bars;
   RaFlow takes six train steps, the first held to the CPU at the train
   bars; CMFlow_T takes a T=2 mini-clip step at learning rate 0 on one
   frame twice, held to the CPU (items, running means, gradients), the same
   step on two frames, its gradients held at the median leaf, then three
   T=5 clip steps, the loss falling; the train paths' kernels held to their
   plain versions at every frame's shapes; a CLI train, resume and eval
   for each family with exact launch counts; their bf16 arms held to their
   plain versions at the first request, and each family's CLI checkpoint
   serving three B=16 requests in bf16 as CMFlow's (CMFlow_T with its
   carry);
9b. bf16 training (``compute_dtype: bfloat16``, the JAX package's bf16
   train mode): hold the bf16 arms of the gather (K6, exactly) and of its
   backward (K7, within one bf16 ulp of each element, the same bits twice,
   its CSR build exactly) to their plain versions at every shape of the
   bf16 CMFlow train step (B=16, N=256: the sa encoder's C=32 and the
   propagation encoder's C=512 at K = 4, 8, 16, 32, the cost volume's
   C=512 at k=8), timed beside ``points[b, idx]`` and a float32
   ``index_add_`` and one cast; take twelve bf16 CMFlow train steps, the
   first held to a CPU bf16 copy at the bars of
   ``tests/test_torch_bf16_train.py``, each step's launches per arm
   (gather 17 of which 14 bf16, gather backward 15 of which 14 bf16),
   finite items and the last Loss below the first; one bf16 RaFlow step
   and one bf16 CMFlow_T T=2 clip step with their launches; a 2-epoch bf16
   CLI train of CMFlow and a 1-epoch resume, launches exact;
9c. data parallelism, each rank a process of its own: two ranks sharing
   the one card (gloo, ``parallel/mesh.py::spawn``), each with 8 of the
   same 16 frames, take the CMFlow float32 step, a RaFlow step, CMFlow_T's
   clip step at T=1 and T=2 and the CMFlow bf16 step from the seeded
   weights; each is held to the one-process step on the 16 frames (loss
   items rtol 1e-4, gradients before Adam at the train bars, BatchNorm
   statistics atol 1e-5; CMFlow_T at T=2 and the bf16 step finite, their
   distance printed), the ranks' variables after every step bit-identical,
   each rank's launches those of the one-process step; the float32 CMFlow
   step timed on both sides and its collectives counted; the ranks' rows
   of one B=16 request through the fused engine in float32 and bf16 held
   to the one-process forward at the serving bars.  A one-rank NCCL group's
   float32 step equals the plain step bit for bit.  Then the CLI under
   ``python -m torch.distributed.run --standalone``: two ranks train 2
   epochs (run.log written once), a one-rank run trains one epoch on the
   same batches (first epoch's loss within rtol 1e-3), two ranks evaluate
   the best checkpoint (every metric within 1e-5 of the one-process
   evaluation), and two 2-rank resumes from the last checkpoint end with
   the same bits.  Two ranks on one card measure contention, not scaling;
9d. the cross-modal preprocessing: RAFT-small with seeded weights at VoD's
   camera size (1216x1936, 12 iterations) on the card: ms per frame pair
   (CUDA events, median of 5 after one warm-up), peak memory, the
   all-pairs product alone beside its bound, two runs compared bit for
   bit, the flow against the same module in float64 on the card (finite;
   max and 99.9th percentile printed) and, at 256x320, against the CPU
   within 1e-2 px.  Then ``python -m cmflow_tpu_torch.cli.preprocess`` in a
   subprocess on a synthetic raw VoD tree (every clip of the default
   splits, full-size JPEG images), RAFT on the card for the train split,
   one train clip again in-process with its flow held to the CLI's within
   1e-2 px; the samples read back through the C++ codec (timed against
   ``json``), packed with ``pack_split``, the packed batches equal to the
   json tree's bit for bit; then the CLI trains two B=16 steps and
   validates once on the packed split (``--dataset vodPackedDataset``),
   its launches exact.  RAFT has no hand-written kernel (cuBLAS, cuDNN);
10. print one JSON line per kernel shape, per request and per train step,
   one per route of a kernel measured on several (the ball query: fused 2
   launches per forward, module 12, train step 12; also under its
   summary's ``by_route``), then the ``{"kernels": [...]}`` summary (each
   kernel also with its launches in each CLI run; the four bf16 arms as
   rows of their own, ``mse.bf16``, ``cv.bf16``, ``cv_agg.bf16``,
   ``plf.bf16``, with the launches of the bf16 serving phase; the gather's
   and its backward's bf16 arms as ``gather.bf16`` and ``gather_bwd.bf16``,
   with the launches of the bf16 train phase), then
   ``{"ok": true, "device": ...}`` last.

Every launch counter is set to 0 just before each served forward, each
train step and each CLI run, and read just after it.  Any failed check raises, so the exit code is non-zero and
the last line is not printed.  Without a CUDA device, or run from anywhere
but the root of a checkout (with ``cmflow_tpu_torch`` beside it), it exits
with code 1 at once.
"""

from __future__ import annotations

import copy
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
import warnings

from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

import cmflow_tpu_torch
from cmflow_tpu_torch.cli import main as cli
from cmflow_tpu_torch.data import BatchLoader, VodClipDataset, VodDataset
from cmflow_tpu_torch.data.synthetic import (
    make_request,
    make_train_batch,
    write_synthetic_dataset,
)
from cmflow_tpu_torch.data.packed import PackedVodDataset, pack_split
from cmflow_tpu_torch.data.vod import VOD_CAMERA_PROJECTION, VOD_T_CAMERA_RADAR
from cmflow_tpu_torch.evaluation import device_metrics, metrics
from cmflow_tpu_torch.losses import radar_loss
from cmflow_tpu_torch.models import build_model, inference
from cmflow_tpu_torch.models.convert import export_flax_variables
from cmflow_tpu_torch.native import build, codec
from cmflow_tpu_torch.nn.blocks import BatchNorm, masked_global_max
from cmflow_tpu_torch.ops import fused, neighbors
from cmflow_tpu_torch.parallel import mesh
from cmflow_tpu_torch.preprocess import SCENE_FLOW_SPLITS, process_clip, vod_io
from cmflow_tpu_torch.preprocess.optical_flow import RaftSmallProvider
from cmflow_tpu_torch.preprocess.synthetic import write_raw_tree
from cmflow_tpu_torch.preprocess.vod_io import IMG_HEIGHT, IMG_WIDTH
from cmflow_tpu_torch.train import loop
from cmflow_tpu_torch.train.state import create_train_state
from cmflow_tpu_torch.train.steps import (
    make_eval_step,
    make_train_step,
    make_train_step_seq,
)
from cmflow_tpu_torch.utils.config import load_config

B = 16
SEED = 0
# published peaks of one H100 SXM (NVIDIA data sheet), used for the bounds
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
TF32_FLOP_PER_S = 495e12  # dense, tensor cores
# kernels that compute their float32 products as three TF32 tensor-core
# products each (csrc/tc_gemm.cuh): their library, device function and
# tensor-core instruction in SASS (HGMMA for wgmma, HMMA for mma.sync)
TC_KERNELS = {"cv": ("cost_volume", "cv_p2p_kernel", "HGMMA"),
              "plf": ("plf", "plf_kernel", "HGMMA"),
              "mse": ("mse", "mse_kernel", "HMMA")}
# float32 operations per (query, point) pair: 3 products and 2 sums for the
# cross term, the -2 scale, 2 sums, the clamp and the comparison
PAIR_FLOPS = 10
BARS = {"flow": 1e-4, "cls": 1e-4, "trans": 5e-4, "agree": 0.99}
# the fused kernels against their plain versions: max abs error, and max
# abs error over the output's largest magnitude
FUSED_ATOL, FUSED_RTOL = 1e-4, 1e-5
# the gather's backward against its plain version (index_add_, which sums
# in another order on the card): max abs error over the largest magnitude
GATHER_BWD_RTOL = 1e-5
# train step, card against CPU (tests/test_torch_train.py): loss items
# relative, BatchNorm statistics and parameters after the step absolute,
# gradients relative L2 per leaf and over the whole gradient
TRAIN_BARS = {"loss_rtol": 1e-4, "stats_atol": 1e-5, "params_atol": 5e-3,
              "grad_leaf_l2": 3e-2, "grad_l2": 1e-2}
TRAIN_STEPS = 12
WRAPPERS = {"ball_query": neighbors.ball_query_multi, "knn": neighbors.knn,
            "gather": fused.gather_rows,
            "mse": fused.fused_multi_scale_encoder,
            "cv": fused.cost_volume_p2p, "cv_agg": fused.cost_volume_agg,
            "plf": fused.fused_point_local_feature,
            "gather_bwd": fused.gather_rows_backward}
EXACT = ("ball_query", "knn", "gather", "gather.bf16")
# the bf16 arms of the fused kernels (bf16 serving, eval_compute_dtype
# bfloat16), each behind its float32 sibling's wrapper and launch counter:
# the bf16 phase's counts are theirs
BF16 = torch.bfloat16
BF16_ARMS = {"mse.bf16": "mse", "cv.bf16": "cv", "cv_agg.bf16": "cv_agg",
             "plf.bf16": "plf"}
# the arms on the tensor cores, with their instruction of a bf16 type in
# SASS (HGMMA.*BF16 for wgmma, HMMA.*BF16 for mma.sync); K4b's arm sums on
# the CUDA cores, as its float32 sibling does
BF16_TC_KERNELS = {"mse.bf16": ("mse", "mse_bf16_kernel", "HMMA"),
                   "cv.bf16": ("cost_volume", "cv_p2p_bf16_kernel", "HGMMA"),
                   "plf.bf16": ("plf", "plf_bf16_kernel", "HGMMA")}
BF16_FLOP_PER_S = 989e12  # dense, tensor cores
# the arms whose wgmmas ptxas must not serialise (no register of an operand
# or the accumulator is touched while their products run)
WGMMA_UNSERIALIZED = ("plf.bf16", "cv.bf16")
# a bf16 arm against its plain version: max abs error over the output's
# largest magnitude (a float32 sum in another order can flip a bf16
# rounding by one ulp, 2^-8)
BF16_RTOL = 1e-2
# the bf16 arms whose arithmetic stays float32 (K4b's: bf16 p2p widened
# exactly, its WeightNet and sums in float32), held at FUSED_ATOL and
# FUSED_RTOL: it reads ~1.3e-7 of the largest magnitude, where a last layer
# in one TF32 pass read 2.5e-4 (PERF.md)
F32_ACCURATE_ARMS = ("cv_agg.bf16",)
# the JAX package's bf16 serving bars (scripts/parity_tpu.py:41,
# tests/test_fused.py:139-148): stat_cls and pre_trans absolute, masks
# agreeing, sf_agg within flow * max(|sf|, 1)
BF16_BARS = {"cls": 3e-2, "trans": 1e-2, "agree": 0.99, "flow": 0.05}
# the CLI's bf16 eval: its RNE within this of the float32 eval's
BF16_RNE_RTOL = 0.05
# the bf16 arms of the gather and its backward (bf16 training), behind
# their float32 siblings' wrappers; each wrapper counts every launch in
# ``launches`` and its bf16 arm's also in ``launches_bf16``
GATHER_ARMS = {"gather.bf16": "gather", "gather_bwd.bf16": "gather_bwd"}
COUNTERS = (*WRAPPERS, *GATHER_ARMS)
# one bf16 train step of the card against the same step on the CPU: the
# bars of tests/test_torch_bf16_train.py (on random weights bf16's rounding
# flips maxima and masks through the step; JAX's own bf16 step lies 0.69-
# 0.80 from its float32 one at the median gradient leaf), and Adam's first
# step as in float32
BF16_TRAIN_BARS = {"loss_rtol": 0.1, "stats_atol": 1e-2,
                   "grad_leaf_l2_median": 0.75, "grad_l2": 0.75,
                   "params_atol": 5e-3}
# held to themselves bit for bit across two runs
SAME_BITS = ("gather_bwd", "cv_agg", *TC_KERNELS, *BF16_ARMS,
             "gather_bwd.bf16")
LAUNCHES = {
    "fused": {"ball_query": 2, "knn": 2, "gather": 0, "mse": 2, "cv": 1,
              "cv_agg": 1, "plf": 4, "gather_bwd": 0},
    "module": {"ball_query": 12, "knn": 2, "gather": 16, "mse": 0, "cv": 0,
               "cv_agg": 0, "plf": 0, "gather_bwd": 0},
    # per train step: the module route's forward, one more gather in the
    # smoothness loss, and the backward of every gather whose rows need a
    # gradient (sa encoder 8, cost volume 2, propagation encoder 4,
    # smoothness 1; not the cost volume's xyz gathers)
    "train": {"ball_query": 12, "knn": 2, "gather": 17, "mse": 0, "cv": 0,
              "cv_agg": 0, "plf": 0, "gather_bwd": 15},
    # a bf16 train step: the same launches, the gathers of the bases and of
    # the point-to-patch cost (sa encoder 8, cost volume 2, propagation
    # encoder 4) on the bf16 arms, the xyz and flow gathers float32
    "train_bf16": {"ball_query": 12, "knn": 2, "gather": 17,
                   "gather.bf16": 14, "mse": 0, "cv": 0, "cv_agg": 0,
                   "plf": 0, "gather_bwd": 15, "gather_bwd.bf16": 14},
}
for _path in LAUNCHES.values():
    for _arm in GATHER_ARMS:
        _path.setdefault(_arm, 0)
# each wrapper's kernels as the profiler names them
DEVICE_NAMES = {"ball_query": ("ball_query_kernel",), "knn": ("knn_kernel",),
                "gather": ("gather_rows_kernel",), "mse": ("mse_kernel",),
                "cv": ("cv_p2p_kernel",), "cv_agg": ("cv_agg_kernel",),
                "plf": ("plf_kernel",),
                "mse.bf16": ("mse_bf16_kernel",),
                "cv.bf16": ("cv_p2p_bf16_kernel",),
                "cv_agg.bf16": ("cv_agg_bf16_kernel",),
                "plf.bf16": ("plf_bf16_kernel",),
                "gather_bwd": ("gather_rows_backward_csr_kernel",
                               "gather_rows_backward_sum_kernel")}
for _arm, _sibling in GATHER_ARMS.items():
    DEVICE_NAMES[_arm] = DEVICE_NAMES[_sibling]
# the CUDA kernels one call of a wrapper may launch, where that is bounded:
# K7 its CSR build and its sum (exactly), K3's bf16 arm the centroids' mean
# and the kernel (at most)
KERNELS_PER_CALL = {"gather_bwd": (2, 2), "gather_bwd.bf16": (2, 2),
                    "mse.bf16": (1, 2)}
# one cloud above the 2048 points the neighbour kernels stage at a time
LARGE_N = 4096
# the route whose forward (train step) each kernel's summary describes
SUMMARY_PATH = {"ball_query": "fused", "knn": "fused", "gather": "module",
                "mse": "fused", "cv": "fused", "cv_agg": "fused",
                "plf": "fused", "gather_bwd": "train",
                **{name: "bf16" for name in BF16_ARMS},
                **{name: "train_bf16" for name in GATHER_ARMS}}
SOURCES = {
    "ball_query": ("cmflow_tpu_torch/csrc/neighbors.cu",
                   "cmflow_tpu/ops/neighbors.py:64"),
    "knn": ("cmflow_tpu_torch/csrc/neighbors.cu",
            "cmflow_tpu/ops/neighbors.py:101"),
    "gather": ("cmflow_tpu_torch/csrc/gather.cu",
               "cmflow_tpu/ops/fused.py:519"),
    "mse": ("cmflow_tpu_torch/csrc/mse.cu", "cmflow_tpu/ops/fused.py:260"),
    "cv": ("cmflow_tpu_torch/csrc/cost_volume.cu",
           "cmflow_tpu/ops/fused.py:688"),
    "cv_agg": ("cmflow_tpu_torch/csrc/cost_volume.cu",
               "cmflow_tpu/ops/fused.py:772"),
    "plf": ("cmflow_tpu_torch/csrc/plf.cu", "cmflow_tpu/ops/fused.py:55"),
    "gather_bwd": ("cmflow_tpu_torch/csrc/gather.cu",
                   "cmflow_tpu/ops/fused.py:579"),
    # the bf16 arms of the Pallas kernels
    "mse.bf16": ("cmflow_tpu_torch/csrc/mse.cu",
                 "cmflow_tpu/ops/fused.py:290"),
    "cv.bf16": ("cmflow_tpu_torch/csrc/cost_volume.cu",
                "cmflow_tpu/ops/fused.py:721"),
    "cv_agg.bf16": ("cmflow_tpu_torch/csrc/cost_volume.cu",
                    "cmflow_tpu/ops/fused.py:792"),
    "plf.bf16": ("cmflow_tpu_torch/csrc/plf.cu", "cmflow_tpu/ops/fused.py:99"),
    "gather.bf16": ("cmflow_tpu_torch/csrc/gather.cu",
                    "cmflow_tpu/ops/fused.py:533"),
    "gather_bwd.bf16": ("cmflow_tpu_torch/csrc/gather.cu",
                        "cmflow_tpu/ops/fused.py:597"),
}


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def zero_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0
    for arm in GATHER_ARMS.values():
        WRAPPERS[arm].launches_bf16 = 0


def counts_now() -> dict:
    counts = {k: fn.launches for k, fn in WRAPPERS.items()}
    counts.update({name: WRAPPERS[arm].launches_bf16
                   for name, arm in GATHER_ARMS.items()})
    return counts


def wrapper_of(name: str):
    """A kernel's wrapper (a bf16 arm's is its float32 sibling's)."""
    return WRAPPERS[{**BF16_ARMS, **GATHER_ARMS}.get(name, name)]


def event_ms(fn, iters: int) -> float:
    """Milliseconds between CUDA events around ``iters`` back-to-back
    calls of ``fn``, over ``iters``: where a call's device work is shorter
    than the host's time to issue it, this times the host."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


PROFILE_TRIES = 6  # windows traced before device_ms gives up
SENTINEL = "spin_kernel"  # torch.cuda._sleep's kernel


def device_ms(fn, iters: int, kernels=("",), per_call: int = 0) -> tuple:
    """Device time of one call of ``fn``, from ``torch.profiler``'s CUDA
    activity over ``iters`` warmed calls: (the summed durations of the
    kernels whose names hold one of ``kernels``, of every kernel it
    launches, {each of ``kernels``: its own}, the kernels it launches).

    The profiler now and then records only part of a window's kernels, or
    none; it drops the first most often, so each window starts with a
    throwaway kernel.  A window counts only if it recorded each of
    ``kernels`` ``iters * per_call`` times (``per_call``: the launches of
    each a call makes), or, without ``per_call``, every kernel a multiple
    of ``iters`` times.  A rejected window is printed to stderr and traced
    again after a pause that doubles, up to ``PROFILE_TRIES`` windows; then
    this raises."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    for t in range(PROFILE_TRIES):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                # the profiler often drops a window's first kernel: let it
                # be this one, which is left out below
                torch.cuda._sleep(1)
                torch.cuda.synchronize()
                for _ in range(iters):
                    fn()
                torch.cuda.synchronize()
            events = [e for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA
                      and SENTINEL not in e.key]
        if per_call:
            whole = all(sum(e.count for e in events if k in e.key)
                        == iters * per_call for k in kernels)
        else:
            whole = bool(events) and all(e.count % iters == 0
                                         for e in events)
        if whole:
            total = sum(e.self_device_time_total for e in events)
            parts = {k: sum(e.self_device_time_total for e in events
                            if k in e.key) / 1e3 / iters for k in kernels}
            count = sum(e.count for e in events) / iters
            return sum(parts.values()), total / 1e3 / iters, parts, count
        print(json.dumps(dict(profiler_window_rejected=dict(
            kernels=list(kernels), iters=iters, per_call=per_call, window=t,
            counts={e.key[:80]: e.count for e in events}))),
            file=sys.stderr, flush=True)
        time.sleep(0.1 * 2 ** t)
    raise RuntimeError(f"the profiler recorded no whole window of "
                       f"{kernels!r} in {PROFILE_TRIES} tries")


def bound_ms(nbytes: float, flops: float, peak: float = F32_FLOP_PER_S):
    """The least time for moving ``nbytes`` and doing ``flops`` at
    ``peak``: (milliseconds, which of the two bounds it)."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / peak
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def bounds(name: str, nbytes: float, flops: float) -> dict:
    """The bound of a kernel's work at its arithmetic's peak, with the
    float32 bound beside it for the 3xTF32 tensor-core kernels."""
    if name in BF16_TC_KERNELS:
        ms, by = bound_ms(nbytes, flops, BF16_FLOP_PER_S)
        return dict(bound_ms=ms, bound_by=by, bound_arith="bf16")
    if name not in TC_KERNELS:
        ms, by = bound_ms(nbytes, flops)
        return dict(bound_ms=ms, bound_by=by)
    ms, by = bound_ms(nbytes, 3 * flops, TF32_FLOP_PER_S)
    f32, f32_by = bound_ms(nbytes, flops)
    return dict(bound_ms=ms, bound_by=by, bound_arith="3xTF32",
                bound_f32_ms=f32, bound_f32_by=f32_by)


def shares(row: dict, ms: float) -> dict:
    """Each bound over the kernel's time."""
    out = dict(share_of_bound=row["bound_ms"] / ms)
    if "bound_f32_ms" in row:
        out["share_of_f32_bound"] = row["bound_f32_ms"] / ms
    return out


def sass_report(libs: dict) -> dict:
    """For each tensor-core kernel: its tensor-core (HGMMA or HMMA; for a
    bf16 arm those of a bf16 type) and FFMA instructions in the SASS of its
    built library, and its registers, spills, shared memory and ptxas's
    notes that it serialises the kernel's ``wgmma``s, from the library's
    ptxas log; the arms in WGMMA_UNSERIALIZED must have no such note."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    report = {}
    for name, (lib, fn, tc_op) in {**TC_KERNELS, **BF16_TC_KERNELS}.items():
        sass = subprocess.run([tool, "-sass", str(libs[lib])], check=True,
                              capture_output=True, text=True).stdout
        body = next(part for part in sass.split("Function : ")[1:]
                    if fn in part.splitlines()[0])
        log = libs[lib].with_suffix(".log").read_text()
        props = next(part for part in
                     log.split("Compiling entry function")[1:]
                     if fn in part.splitlines()[0])
        regs, smem = re.search(r"Used (\d+) registers.*?(\d+) bytes smem",
                               props).groups()
        spill = re.search(r"(\d+) bytes spill stores", props).group(1)
        serialized = [line.strip() for line in log.splitlines()
                      if "wgmma" in line and "serializ" in line
                      and fn in line]
        if name in BF16_TC_KERNELS:
            key, pattern = f"{tc_op.lower()}_bf16", rf"\b{tc_op}\.\S*BF16\b"
        else:
            key, pattern = tc_op.lower(), rf"\b{tc_op}\b"
        count = len(re.findall(pattern, body))
        report[name] = dict(
            function=fn, **{key: count},
            ffma=len(re.findall(r"\bFFMA\b", body)), registers=int(regs),
            spill_store_bytes=int(spill), static_smem_bytes=int(smem),
            wgmma_serialized=serialized)
        require(count > 0,
                f"{fn}: no tensor-core ({tc_op}) instruction in its SASS")
        require(not (serialized and name in WGMMA_UNSERIALIZED),
                f"{fn}: ptxas serialises its wgmmas: {serialized}")
    return report


def numel(tensors) -> int:
    return sum(t.numel() for t in tensors)


# ---------------------------------------------------------------------------
# kernels against their plain versions
# ---------------------------------------------------------------------------

def errors(a, b):
    """(max abs error, largest magnitude of the plain output)."""
    if isinstance(a, tuple):
        pairs = [errors(x, y) for x, y in zip(a, b)]
        return max(p[0] for p in pairs), max(p[1] for p in pairs)
    return (float((a.double() - b.double()).abs().max()),
            float(b.double().abs().max()))


def ball_scan_pairs(radii, ks, pc, valid) -> int:
    """(query, point) pairs the scan visits: until every radius holds its K
    hits, or all N."""
    d = neighbors.square_distance(pc, pc)
    n = pc.shape[1]
    stop = torch.zeros(d.shape[:2], dtype=torch.long, device=pc.device)
    for r, k in zip(radii, ks):
        hit = (d < neighbors.radius_sq(r)) & valid[:, None, :]
        full = hit.cumsum(-1) >= k
        stop = torch.maximum(stop, torch.where(
            full.any(-1), full.float().argmax(-1) + 1, n))
    return int(stop.sum())


def request_tensors(req: dict, dev):
    return [torch.as_tensor(req[k], device=dev)
            for k in ("pc1", "pc2", "ft1", "ft2", "valid1", "valid2")]


def module_cases(req: dict, dev, gen: torch.Generator):
    """The shapes only the module route launches: the ball query one radius
    at a time, and the gathers of ``group_points``."""
    pc1, pc2, _, _, v1, v2 = request_tensors(req, dev)
    b, n, _ = pc1.shape
    cloud_bytes = b * n * (3 * 4 + 1)
    radii, ks = (2.0, 4.0, 8.0, 16.0), (4, 8, 16, 32)
    cases = []
    ball_idx = {}
    for r, k in zip(radii, ks):
        (idx,) = neighbors.ball_query_multi((r,), (k,), pc1, pc1, v1)
        ball_idx[k] = idx
        cases.append(dict(
            kernel="ball_query", path="module",
            shape=f"B={b} N={n} r={r} K={k} masked",
            mult=3,  # sa encoder on pc1 and pc2, propagation encoder on pc1
            run=lambda r=r, k=k: neighbors.ball_query_multi(
                (r,), (k,), pc1, pc1, v1),
            plain=lambda r=r, k=k: neighbors.ball_query_multi_plain(
                (r,), (k,), pc1, pc1, v1),
            nbytes=cloud_bytes + b * n * k * 4,
            flops=PAIR_FLOPS * ball_scan_pairs((r,), (k,), pc1, v1)))
    knn_idx = {"pc1->pc2": neighbors.knn(8, pc1, pc2, v2),
               "pc1->pc1": neighbors.knn(8, pc1, pc1, v1)}

    def gather_case(c, idx, mult, what):
        pts = torch.randn((b, n, c), generator=gen).to(dev)
        flat = idx.reshape(b, -1)
        flat_long = flat.long()
        rows = torch.arange(b, device=dev)[:, None]
        m = flat.shape[1]
        cases.append(dict(
            kernel="gather", path="module",
            shape=f"B={b} N={n} M={m} C={c} ({what})", mult=mult,
            run=lambda: fused.gather_rows(pts, flat),
            plain=lambda: fused.gather_rows_plain(pts, flat),
            library=lambda: pts[rows, flat_long],
            nbytes=b * n * c * 4 + b * m * 4 + b * m * c * 4, flops=0))

    for k in ks:
        gather_case(32, ball_idx[k], 2, f"sa encoder K={k}")
        gather_case(512, ball_idx[k], 1, f"propagation encoder K={k}")
    for name, idx in knn_idx.items():
        gather_case(3, idx, 1, f"cost volume xyz k=8 {name}")
        gather_case(512, idx, 1, f"cost volume features k=8 {name}")
    return cases


def fused_cases(model, req: dict, dev):
    """Every shape of the fused route's forward on this request, with the
    model's packed weights and the forward's own intermediates as inputs;
    the kNN shapes are shared with the module route."""
    pc1, pc2, ft1, ft2, v1, v2 = request_tensors(req, dev)
    b, n, _ = pc1.shape
    cfg = model.trunk.cfg
    radii, ks = tuple(cfg.sa_radii), tuple(cfg.sa_nsamples)
    rows = b * n
    cloud_bytes = rows * (3 * 4 + 1)
    cases = []

    def yardstick(k, widths):
        """cuBLAS float32 on the kernel's products alone, on gathered rows
        of its shape (the values do not matter for the time)."""
        xs = [torch.randn((rows * k, c), device=dev) for c in widths[:-1]]
        ws = [torch.randn((c, o), device=dev)
              for c, o in zip(widths[:-1], widths[1:])]
        return lambda: [x @ w for x, w in zip(xs, ws)]

    idx = {}
    for name, pc, v in (("pc1", pc1, v1), ("pc2", pc2, v2)):
        idx[name] = inference._ball_query_all(radii, ks, pc, v)
        cases.append(dict(
            kernel="ball_query", path="fused",
            shape=f"B={b} N={n} all radii K={ks} {name} masked", mult=1,
            run=lambda pc=pc, v=v: neighbors.ball_query_multi(
                radii, ks, pc, pc, v),
            plain=lambda pc=pc, v=v: neighbors.ball_query_multi_plain(
                radii, ks, pc, pc, v),
            nbytes=cloud_bytes + rows * sum(ks) * 4,
            flops=PAIR_FLOPS * ball_scan_pairs(radii, ks, pc, v)))
    knn2 = neighbors.knn(8, pc1, pc2, v2)
    knn1 = neighbors.knn(8, pc1, pc1, v1)
    for name, pts, valid in (("pc1->pc2", pc2, v2), ("pc1->pc1", pc1, v1)):
        dist = neighbors.masked_square_distance(pc1, pts, valid)
        cases.append(dict(
            kernel="knn", path="fused", shape=f"B={b} N={n} k=8 {name} masked",
            mult=1,
            run=lambda pts=pts, valid=valid: neighbors.knn(8, pc1, pts, valid),
            plain=lambda pts=pts, valid=valid: neighbors.knn_plain(
                8, pc1, pts, valid),
            library=lambda dist=dist: torch.topk(dist, 8, largest=False),
            nbytes=cloud_bytes * (1 if pts is pc1 else 2) + rows * 8 * 4,
            flops=PAIR_FLOPS * b * n * n))

    mse = model.trunk.mse_layer
    packed, _ = fused.mse_narrow_params_from_variables(mse)
    c1, c2, c3 = fused.MSE_WIDTHS
    s_cnt = len(ks)
    for name, pc, ft in (("pc1", pc1, ft1), ("pc2", pc2, ft2)):
        cases.append(dict(
            kernel="mse", path="fused",
            shape=f"B={b} N={n} K={ks} {name} masked", mult=1,
            run=lambda pc=pc, ft=ft, i=idx[name]:
                fused.fused_multi_scale_encoder(ft, i, pc, packed),
            plain=lambda pc=pc, ft=ft, i=idx[name]:
                fused.fused_multi_scale_encoder_plain(ft, i, pc, packed),
            nbytes=4 * (rows * (6 + sum(ks) + s_cnt * c3)
                        + numel(packed[0] + packed[1] + packed[2:])),
            # the folded first layer, then the chain per (query, neighbour)
            flops=2 * (rows * s_cnt * c1 * 9
                       + rows * sum(ks) * (c1 * c2 + c2 * c3))))

    f1 = inference._mse_fused(mse, pc1, ft1, v1, idx["pc1"])
    f2 = inference._mse_fused(mse, pc2, ft2, v2, idx["pc2"])
    g1, g2 = masked_global_max(f1, v1), masked_global_max(f2, v2)
    fc = model.trunk.fc_layer
    d = cfg.fc_inch
    f1t = inference._fanin_dot((f1, g1), fc.w0[:d])
    f2t = inference._fanin_dot((f2, g2), fc.w0[d:2 * d])
    dense, wn1, wn2 = fused.cv_params_from_variables(fc)
    f1c, f2c, z1, z2, zq = fused.cost_volume_folds(
        f1t, f2t, pc1, pc2, dense[0], wn1[0], wn2[0])
    c, k, h = fused.CV_WIDTH, fc.nsample, fused.WEIGHTNET_HIDDEN
    cv_args = (f1c, f2c, knn2, z1, z2, dense[1:], wn1[1:])
    cases.append(dict(
        kernel="cv", path="fused", shape=f"B={b} N={n} C={c} k={k} masked",
        mult=1, run=lambda: fused.cost_volume_p2p(*cv_args),
        plain=lambda: fused.cost_volume_p2p_plain(*cv_args),
        cublas=yardstick(k, (c, c, c)),
        nbytes=4 * (rows * (3 * c + k + 2 * h) + numel(dense[1:] + wn1[1:])),
        flops=2 * rows * k * (2 * c * c + h * h + h * c)))
    p2p = fused.cost_volume_p2p(*cv_args)
    agg_args = (p2p, knn1, zq, wn2[1:])
    cases.append(dict(
        kernel="cv_agg", path="fused", shape=f"B={b} N={n} C={c} k={k} masked",
        mult=1, run=lambda: fused.cost_volume_agg(*agg_args),
        plain=lambda: fused.cost_volume_agg_plain(*agg_args),
        nbytes=4 * (rows * (2 * c + k + h) + numel(wn2[1:])),
        flops=2 * rows * k * (h * h + h * c + c)))
    cor = fused.cost_volume_agg(*agg_args)

    parts = (ft1, f1, g1, cor)
    w1, w2, w3 = fused.PLF_WIDTHS
    for s, scale in enumerate(inference._scales(model.trunk.mse_layer2)):
        chain, feat_w, _ = fused.plf_params_from_variables(scale)
        feat_tx = inference._fanin_dot(parts, feat_w)
        kk = ks[s]
        plf_args = (feat_tx, idx["pc1"][s], pc1, chain)
        cases.append(dict(
            kernel="plf", path="fused", shape=f"B={b} N={n} K={kk} masked",
            mult=1, run=lambda a=plf_args: fused.fused_point_local_feature(*a),
            plain=lambda a=plf_args:
                fused.fused_point_local_feature_plain(*a),
            cublas=yardstick(kk, fused.PLF_WIDTHS),
            nbytes=4 * (rows * (w1 + kk + 3 + w3) + numel(chain)),
            # the folded first layer, then the chain per (query, neighbour)
            flops=2 * (rows * w1 * 6 + rows * kk * (w1 * w2 + w2 * w3))))
    return cases


def nbytes(*tensors) -> int:
    """Bytes of ``tensors`` (nested sequences flattened), each read or
    written once."""
    out = 0
    for t in tensors:
        out += nbytes(*t) if isinstance(t, (list, tuple)) else (
            t.numel() * t.element_size())
    return out


def bf16_cases(model, req: dict, dev):
    """Every shape of the bf16 fused forward (``compute_dtype`` bfloat16)
    on this request: the bf16 arms of K3, K4a, K4b and K5 on the forward's
    own bf16 operands, with the same operation counts as their float32
    siblings and the bytes of their own inputs and outputs; beside K4a and
    K5, cuBLAS on bf16 operands with float32 sums (``torch.mm(...,
    out_dtype=)``, as ``_dot32`` calls it) on their products alone."""
    pc1, pc2, ft1, ft2, v1, v2 = request_tensors(req, dev)
    b, n, _ = pc1.shape
    cfg = model.trunk.cfg
    radii, ks = tuple(cfg.sa_radii), tuple(cfg.sa_nsamples)
    rows = b * n
    cases = []

    def yardstick(k, widths):
        xs = [torch.randn((rows * k, c), device=dev).to(BF16)
              for c in widths[:-1]]
        ws = [torch.randn((c, o), device=dev).to(BF16)
              for c, o in zip(widths[:-1], widths[1:])]
        return lambda: [torch.mm(x, w, out_dtype=torch.float32)
                        for x, w in zip(xs, ws)]

    idx = {name: inference._ball_query_all(radii, ks, pc, v)
           for name, pc, v in (("pc1", pc1, v1), ("pc2", pc2, v2))}
    mse = model.trunk.mse_layer
    packed, _ = fused.mse_narrow_params_from_variables(mse, BF16)
    c1, c2, c3 = fused.MSE_WIDTHS
    s_cnt = len(ks)
    for name, pc, ft in (("pc1", pc1, ft1), ("pc2", pc2, ft2)):
        ftb = ft.to(BF16)
        cases.append(dict(
            kernel="mse.bf16", path="bf16",
            shape=f"B={b} N={n} K={ks} {name} masked", mult=1,
            run=lambda pc=pc, ft=ftb, i=idx[name]:
                fused.fused_multi_scale_encoder(ft, i, pc, packed),
            plain=lambda pc=pc, ft=ftb, i=idx[name]:
                fused.fused_multi_scale_encoder_plain(ft, i, pc, packed),
            # the points, the bf16 features, the indices and the weights
            # in, the float32 output back
            nbytes=(nbytes(pc, ftb, idx[name], packed)
                    + rows * s_cnt * c3 * 4),
            flops=2 * (rows * s_cnt * c1 * 9
                       + rows * sum(ks) * (c1 * c2 + c2 * c3))))

    f1 = inference._mse_fused(mse, pc1, ft1, v1, idx["pc1"], BF16)
    f2 = inference._mse_fused(mse, pc2, ft2, v2, idx["pc2"], BF16)
    g1, g2 = masked_global_max(f1, v1), masked_global_max(f2, v2)
    fc = model.trunk.fc_layer
    d = cfg.fc_inch
    f1t = inference._fanin_dot((f1, g1), fc.w0[:d], BF16).to(BF16)
    f2t = inference._fanin_dot((f2, g2), fc.w0[d:2 * d], BF16).to(BF16)
    dense, wn1, wn2 = fused.cv_params_from_variables(fc)
    dense = [t.to(BF16) if i % 2 == 0 else t for i, t in enumerate(dense)]
    knn2 = neighbors.knn(8, pc1, pc2, v2)
    knn1 = neighbors.knn(8, pc1, pc1, v1)
    f1c, f2c, z1, z2, zq = fused.cost_volume_folds(
        f1t, f2t, pc1, pc2, dense[0], wn1[0], wn2[0], BF16)
    c, k, h = fused.CV_WIDTH, fc.nsample, fused.WEIGHTNET_HIDDEN
    cv_args = (f1c, f2c, knn2, z1, z2, dense[1:], wn1[1:])
    cases.append(dict(
        kernel="cv.bf16", path="bf16",
        shape=f"B={b} N={n} C={c} k={k} masked", mult=1,
        run=lambda: fused.cost_volume_p2p(*cv_args),
        plain=lambda: fused.cost_volume_p2p_plain(*cv_args),
        cublas=yardstick(k, (c, c, c)),
        nbytes=nbytes(cv_args) + rows * c * 2,
        flops=2 * rows * k * (2 * c * c + h * h + h * c)))
    p2p = fused.cost_volume_p2p(*cv_args)
    agg_args = (p2p, knn1, zq, wn2[1:])
    cases.append(dict(
        kernel="cv_agg.bf16", path="bf16",
        shape=f"B={b} N={n} C={c} k={k} masked", mult=1,
        run=lambda: fused.cost_volume_agg(*agg_args),
        plain=lambda: fused.cost_volume_agg_plain(*agg_args),
        nbytes=nbytes(agg_args) + rows * c * 4,
        flops=2 * rows * k * (h * h + h * c + c)))
    cor = fused.cost_volume_agg(*agg_args)

    parts = (ft1, f1, g1, cor)
    w1, w2, w3 = fused.PLF_WIDTHS
    for s, scale in enumerate(inference._scales(model.trunk.mse_layer2)):
        chain, feat_w, _ = fused.plf_params_from_variables(scale)
        chain = inference._cast_chain(chain, BF16)
        feat_tx = inference._fanin_dot(parts, feat_w, BF16).to(BF16)
        kk = ks[s]
        plf_args = (feat_tx, idx["pc1"][s], pc1, chain)
        cases.append(dict(
            kernel="plf.bf16", path="bf16", shape=f"B={b} N={n} K={kk} masked",
            mult=1, run=lambda a=plf_args: fused.fused_point_local_feature(*a),
            plain=lambda a=plf_args:
                fused.fused_point_local_feature_plain(*a),
            cublas=yardstick(kk, fused.PLF_WIDTHS),
            nbytes=nbytes(plf_args) + rows * w3 * 4,
            flops=2 * (rows * w1 * 6 + rows * kk * (w1 * w2 + w2 * w3))))
    return cases


def gather_bwd_cases(batch: dict, dev, gen: torch.Generator):
    """K7 at every shape of the train step, on this batch's own neighbour
    indices and seeded random cotangents."""
    pc1 = torch.as_tensor(batch["pc1"], device=dev)
    pc2 = torch.as_tensor(batch["pc2"], device=dev)
    b, n, _ = pc1.shape
    radii, ks = (2.0, 4.0, 8.0, 16.0), (4, 8, 16, 32)
    d = neighbors.square_distance(pc1, pc1)
    smooth = torch.sort(d, dim=-1, stable=True).indices[..., 1:9]
    shapes = [(c, ks[i], neighbors.ball_query_multi((r,), (k,), pc1, pc1)[0],
               mult, what)
              for i, (r, k) in enumerate(zip(radii, ks))
              for c, mult, what in ((32, 2, "sa encoder"),
                                    (512, 1, "propagation encoder"))]
    shapes += [(512, 8, neighbors.knn(8, pc1, pc2), 1,
                "cost volume pc1->pc2"),
               (512, 8, neighbors.knn(8, pc1, pc1), 1,
                "cost volume pc1->pc1"),
               (3, 8, smooth.to(torch.int32), 1, "smoothness loss")]
    cases = []
    for c, k, idx, mult, what in shapes:
        flat = idx.reshape(b, -1).contiguous()
        m = flat.shape[1]
        g = torch.randn((b, m, c), generator=gen).to(dev)
        rows = (flat.long() + n * torch.arange(b, device=dev)[:, None]
                ).reshape(-1)
        g_rows = g.reshape(b * m, c)
        cases.append(dict(
            kernel="gather_bwd", path="train",
            shape=f"B={b} N={n} M={m} C={c} ({what} K={k})", mult=mult,
            run=lambda g=g, flat=flat: fused.gather_rows_backward(g, flat, n),
            plain=lambda g=g, flat=flat: fused.gather_rows_backward_plain(
                g, flat, n),
            csr=lambda flat=flat: fused.gather_rows_csr(flat, n),
            csr_plain=lambda flat=flat: fused.gather_rows_csr_plain(flat, n),
            library=lambda rows=rows, g_rows=g_rows, c=c: torch.zeros(
                (b * n, c), device=dev).index_add_(0, rows, g_rows),
            nbytes=4 * (b * m * c + b * m + b * n * c), flops=b * m * c,
            csr_flat=flat, c=c, n=n))
    return cases


def train_ball_cases(batch: dict, dev):
    """K1 at the train step's shapes: one radius per launch, unmasked, on
    pc1 (sa and propagation encoders) and pc2 (sa encoder)."""
    cases = []
    for name, mult in (("pc1", 2), ("pc2", 1)):
        pc = torch.as_tensor(batch[name], device=dev)
        b, n, _ = pc.shape
        valid = torch.ones((b, n), dtype=torch.bool, device=dev)
        for r, k in zip((2.0, 4.0, 8.0, 16.0), (4, 8, 16, 32)):
            cases.append(dict(
                kernel="ball_query", path="train",
                shape=f"B={b} N={n} r={r} K={k} {name}", mult=mult,
                run=lambda pc=pc, r=r, k=k: neighbors.ball_query_multi(
                    (r,), (k,), pc, pc),
                plain=lambda pc=pc, r=r, k=k:
                    neighbors.ball_query_multi_plain((r,), (k,), pc, pc),
                nbytes=b * n * 3 * 4 + b * n * k * 4,
                flops=PAIR_FLOPS * ball_scan_pairs((r,), (k,), pc, valid)))
    return cases


def check_large_cloud(dev, gen: torch.Generator) -> None:
    """K1 (all four radii) and K2 (k=8, both masks) at one B=16 cloud of
    LARGE_N points, which the kernels stage in two tiles, held exactly to
    their plain versions; not part of any route's time."""
    pc = (60.0 * torch.rand((B, LARGE_N, 3), generator=gen)).to(dev)
    valid = (torch.rand((B, LARGE_N), generator=gen) > 0.2).to(dev)
    radii, ks = (2.0, 4.0, 8.0, 16.0), (4, 8, 16, 32)
    for v in (None, valid):
        got = neighbors.ball_query_multi(radii, ks, pc, pc, v)
        want = neighbors.ball_query_multi_plain(radii, ks, pc, pc, v)
        require(all(torch.equal(a, b) for a, b in zip(got, want)),
                f"ball_query at N={LARGE_N}: kernel and plain version differ")
        require(torch.equal(neighbors.knn(8, pc, pc, v),
                            neighbors.knn_plain(8, pc, pc, v)),
                f"knn at N={LARGE_N}: kernel and plain version differ")
    emit(dict(large_cloud=dict(batch=B, num_points=LARGE_N,
                               ball_query="exact", knn="exact")))


def check_cv_agg_any_k(model, dev, gen: torch.Generator) -> None:
    """K4b at one B=16, N=384 cloud with k=33 neighbours, past K4a's
    K <= 32, in both arms: masked kNN indices, three of them out of range,
    seeded p2p (float32, and rounded to bf16 for the bf16 arm) and zq, the
    model's WeightNet; each held to its plain version at FUSED_ATOL and
    FUSED_RTOL and to itself bit for bit; not part of any route's time."""
    n, k = 384, 33
    pc = (20.0 * torch.rand((B, n, 3), generator=gen)).to(dev)
    valid = (torch.rand((B, n), generator=gen) > 0.2).to(dev)
    idx = neighbors.knn(k, pc, pc, valid)
    idx[0, :3, 0] = torch.tensor([-1, n, 4096], dtype=torch.int32,
                                 device=dev)
    p2p = torch.randn((B, n, fused.CV_WIDTH), generator=gen).to(dev)
    zq = torch.randn((B, n, fused.WEIGHTNET_HIDDEN), generator=gen).to(dev)
    wn = fused.cv_params_from_variables(model.trunk.fc_layer)[2][1:]
    row = {}
    for name, p in (("cv_agg", p2p), ("cv_agg.bf16", p2p.to(BF16))):
        got = fused.cost_volume_agg(p, idx, zq, wn)
        again = fused.cost_volume_agg(p, idx, zq, wn)
        want = fused.cost_volume_agg_plain(p, idx, zq, wn)
        torch.cuda.synchronize()
        err, scale = errors(got, want)
        require(err <= FUSED_ATOL and err <= FUSED_RTOL * scale,
                f"{name} at N={n} k={k}: kernel and plain version differ "
                f"by {err} at a largest magnitude of {scale}")
        require(torch.equal(got, again), f"{name} at N={n} k={k}: two runs "
                                         f"differ")
        row[name] = dict(max_abs_err=err, plain_max_abs=scale,
                         same_bits=True)
    emit(dict(cv_agg_any_k=dict(batch=B, num_points=n, k=k, **row)))


def check_bf16_tc_any_k(model, dev, gen: torch.Generator) -> None:
    """The bf16 arms of K5 and K4a past the neighbour counts they took
    before (K5 64, K4a 32), at one B=16, N=256 cloud: K5 at K=129 (a
    query's rows over two 128-row tiles) with the model's first
    propagation-encoder scale, K4a at k=65 (over two 64-row tiles) with its
    cost volume's weights, bf16 operands, seeded random indices with some
    outside [0, N); each held to its plain version at BF16_RTOL and to
    itself bit for bit; not part of any route's time."""
    n, row = 256, {}
    pc = (20.0 * torch.rand((B, n, 3), generator=gen)).to(dev)
    chain, _, _ = fused.plf_params_from_variables(
        inference._scales(model.trunk.mse_layer2)[0])
    chain = inference._cast_chain(chain, BF16)
    fc = model.trunk.fc_layer
    dense, wn1, _ = fused.cv_params_from_variables(fc)
    dense = [t.to(BF16) if i % 2 == 0 else t for i, t in enumerate(dense)]
    for name, k, width in (("plf.bf16", 129, fused.PLF_WIDTHS[0]),
                           ("cv.bf16", 65, fused.CV_WIDTH)):
        idx = torch.randint(-2, n + 2, (B, n, k), generator=gen,
                            dtype=torch.int32).to(dev)
        feats = [torch.randn((B, n, width), generator=gen).to(dev).to(BF16)
                 for _ in range(2)]
        if name == "plf.bf16":
            args = (feats[0], idx, pc, chain)
            kernel = fused.fused_point_local_feature
            plain = fused.fused_point_local_feature_plain(*args)
        else:
            z = [torch.randn((B, n, fused.WEIGHTNET_HIDDEN),
                             generator=gen).to(dev) for _ in range(2)]
            args = (feats[0], feats[1], idx, z[0], z[1], dense[1:], wn1[1:])
            kernel = fused.cost_volume_p2p
            plain = fused.cost_volume_p2p_plain(*args)
        got, again = kernel(*args), kernel(*args)
        torch.cuda.synchronize()
        err, scale = errors(got, plain)
        require(got.dtype == plain.dtype and err <= BF16_RTOL * scale,
                f"{name} at N={n} k={k}: kernel and plain version differ by "
                f"{err} at a largest magnitude of {scale}")
        require(torch.equal(got, again), f"{name} at N={n} k={k}: two runs "
                                         f"differ")
        row[name] = dict(k=k, max_abs_err=err, plain_max_abs=scale,
                         same_bits=True)
    emit(dict(bf16_tc_any_k=dict(batch=B, num_points=n, **row)))


def hold_to_plain(case) -> tuple:
    """Hold one case's kernel to its plain version at its bar (and to
    itself bit for bit where it must be); returns (max abs error, the plain
    output's largest magnitude)."""
    name = case["kernel"]
    got, want = case["run"](), case["plain"]()
    torch.cuda.synchronize()
    err, scale = errors(got, want)
    if name in EXACT:
        require(err == 0.0 and (name != "gather.bf16"
                                or got.dtype == want.dtype == BF16),
                f"{name} {case['shape']}: kernel and plain version differ "
                f"by {err}")
    elif name == "gather_bwd.bf16":
        g, w = got.float(), want.float()
        ulp = torch.ldexp(torch.ones_like(w), torch.frexp(
            torch.maximum(g.abs(), w.abs())).exponent - 8)
        require(got.dtype == want.dtype == BF16
                and bool(((g - w).abs() <= ulp).all()),
                f"{name} {case['shape']}: kernel and plain version differ "
                f"by more than one bf16 ulp (max abs {err})")
    elif name == "gather_bwd":
        require(err <= GATHER_BWD_RTOL * scale,
                f"{name} {case['shape']}: kernel and plain version "
                f"differ by {err} at a largest magnitude of {scale}")
    elif name in BF16_ARMS and name not in F32_ACCURATE_ARMS:
        require(got.dtype == want.dtype and err <= BF16_RTOL * scale,
                f"{name} {case['shape']}: kernel and plain version "
                f"differ by {err} at a largest magnitude of {scale}")
    else:
        require(err <= FUSED_ATOL and err <= FUSED_RTOL * scale,
                f"{name} {case['shape']}: kernel and plain version "
                f"differ by {err} at a largest magnitude of {scale}")
    if name in SAME_BITS:
        again = case["run"]()
        torch.cuda.synchronize()
        require(torch.equal(got, again), f"{name} {case['shape']}: two "
                                         f"runs differ")
    if "csr" in case:  # K7's first kernel alone, exactly
        for a, b in zip(case["csr"](), case["csr_plain"]()):
            require(torch.equal(a, b), f"{name} {case['shape']}: "
                                       f"gather_rows_csr and its plain "
                                       f"version differ")
    return err, scale


def check_kernels(cases, first: bool, per_forward: dict) -> None:
    """Hold each case to its plain version, time it, print it, and sum the
    first request's cases per forward or step of their route into
    ``per_forward[(kernel, route)]``."""
    for case in cases:
        name = case["kernel"]
        err, scale = hold_to_plain(case)
        library = case.get("library")
        cublas = case.get("cublas")
        before = wrapper_of(name).launches
        case["run"]()
        per_call = wrapper_of(name).launches - before
        own, wrapper, parts, call_kernels = device_ms(
            case["run"], 20, DEVICE_NAMES[name], per_call)
        lo, hi = KERNELS_PER_CALL.get(name, (1, math.inf))
        require(lo <= call_kernels <= hi,
                f"{name} {case['shape']}: {call_kernels} kernels a call, "
                f"not {lo}..{hi}")
        row = dict(kernel=name, path=case["path"], shape=case["shape"],
                   kernel_ms=own, wrapper_device_ms=wrapper,
                   kernels_per_call=call_kernels,
                   kernel_event_ms=event_ms(case["run"], 50),
                   plain_ms=device_ms(case["plain"], 5)[1],
                   library_ms=device_ms(library, 10)[1] if library else None,
                   max_abs_err=err)
        if len(parts) > 1:
            row["kernel_parts_ms"] = parts
        if name not in EXACT:
            row["plain_max_abs"] = scale
        if cublas:
            row["cublas_products_ms"] = device_ms(cublas, 10)[1]
        row.update(bounds(name, case["nbytes"], case["flops"]))
        row.update(shares(row, row["kernel_ms"]))
        row["launches_per_forward"] = case["mult"]
        emit(row)
        if not first:
            continue
        acc = per_forward.setdefault((name, case["path"]), dict(
            ms=0.0, wrapper_ms=0.0, event_ms=0.0, plain_ms=0.0,
            library_ms=0.0, cublas_products_ms=0.0, nbytes=0.0, flops=0.0,
            max_abs_err=0.0, has_library=True))
        mult = case["mult"]
        acc["ms"] += mult * row["kernel_ms"]
        acc["wrapper_ms"] += mult * row["wrapper_device_ms"]
        acc["event_ms"] += mult * row["kernel_event_ms"]
        acc["plain_ms"] += mult * row["plain_ms"]
        acc["cublas_products_ms"] += mult * row.get("cublas_products_ms", 0.0)
        acc["nbytes"] += mult * case["nbytes"]
        acc["flops"] += mult * case["flops"]
        acc["max_abs_err"] = max(acc["max_abs_err"], err)
        if row["library_ms"] is None:
            acc["has_library"] = False
        else:
            acc["library_ms"] += mult * row["library_ms"]


# ---------------------------------------------------------------------------
# the served model
# ---------------------------------------------------------------------------

def randomize_batchnorm(model, step, req, gen: torch.Generator) -> None:
    """Seeded random BatchNorm statistics on the scale of the activations:
    on one calibration forward of the module route, each BatchNorm takes
    the mean and variance of its input, perturbed by random factors, and a
    random affine."""

    def uniform(shape, lo, hi):
        return (lo + (hi - lo) * torch.rand(shape, generator=gen))

    def pre_hook(mod, args):
        x = args[0].reshape(-1, args[0].shape[-1])
        c = x.shape[-1]
        mean, var = x.mean(0), x.var(0, unbiased=False)
        dev = x.device
        mod.running_mean.copy_(mean + uniform(c, -0.2, 0.2).to(dev)
                               * var.sqrt())
        mod.running_var.copy_(var * uniform(c, 0.7, 1.4).to(dev) + 1e-3)
        mod.weight.copy_(uniform(c, 0.7, 1.3).to(dev))
        mod.bias.copy_(uniform(c, -0.2, 0.2).to(dev))

    hooks = [m.register_forward_pre_hook(pre_hook)
             for m in model.modules() if isinstance(m, BatchNorm)]
    step(req)
    for h in hooks:
        h.remove()


def frame_metrics(req: dict, out) -> dict:
    sf, _, trans, _ = (x.cpu().numpy() for x in out)
    sfm = metrics.eval_scene_flow_batch(req["pc1"], sf, req["labels"],
                                        req["mask"], req["valid1"])
    pose = metrics.eval_trans_rpe_batch(req["trans"], trans)
    res = {k: float(np.mean(sfm[k])) for k in ("epe", "accs", "accr")}
    res.update({k: float(np.mean(pose[k])) for k in ("RTE", "RAE")})
    return res


def compare(req, out, ref, what: str) -> dict:
    """Hold ``out`` to ``ref`` at the bars, on the valid points."""
    (sf, cls, trans, mask), (rsf, rcls, rtrans, rmask) = (
        [x.cpu().numpy() for x in o] for o in (out, ref))
    valid = req["valid1"]
    same = (mask == rmask) & valid
    res = dict(
        cls_max_abs_err=float(np.abs(cls - rcls)[valid].max()),
        trans_max_abs_err=float(np.abs(trans - rtrans).max()),
        flow_max_abs_err=float(np.abs(sf - rsf)[same].max()),
        mask_agreement=float((mask == rmask)[valid].mean()))
    require(res["cls_max_abs_err"] <= BARS["cls"], f"stat_cls {what}: {res}")
    require(res["trans_max_abs_err"] <= BARS["trans"],
            f"pre_trans {what}: {res}")
    require(res["flow_max_abs_err"] <= BARS["flow"], f"sf_agg {what}: {res}")
    require(res["mask_agreement"] >= BARS["agree"], f"mask {what}: {res}")
    return res


def serve(route: str, step, requests, checks,
          family: str = "cmflow") -> dict:
    """Serve ``requests`` through ``step``, counting each kernel's launches
    per forward; ``checks(req, out)`` returns the first request's
    comparisons."""
    launches = {k: 0 for k in COUNTERS}
    want = LAUNCHES[route]
    for i, req in enumerate(requests):
        zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = step(req)
        torch.cuda.synchronize()
        latency = time.perf_counter() - t0
        counts = counts_now()
        require(counts == want,
                f"{route} request {i}: launches {counts}, want {want}")
        for k in launches:
            launches[k] += counts[k]
        b, n = req["pc1"].shape[:2]
        sf, cls, trans, mask = out
        require(sf.shape == (b, n, 3) and cls.shape == (b, n)
                and trans.shape == (b, 4, 4) and mask.shape == (b, n),
                f"{route} request {i}: output shapes")
        require(all(bool(torch.isfinite(x).all()) for x in (sf, cls, trans)),
                f"{route} request {i}: non-finite output")
        row = dict(family=family, route=route, request=i, batch=int(b),
                   bucket=int(n), latency_ms=1e3 * latency,
                   frames_per_s=b / latency,
                   launches=counts, **frame_metrics(req, out))
        if i == 0:
            row.update(checks(req, out))
        emit(row)
    return launches


# per family: the slots of make_eval_step's outputs holding sf_agg,
# stat_cls (RaFlow has none), pre_trans and the mask
BF16_OUTPUTS = {"cmflow": (0, 1, 2, 3), "raflow": (0, None, 2, 3),
                "cmflow_t": (0, 1, 2, 3)}


def compare_bf16(family: str, req, out, ref, what: str,
                 hold: bool = True) -> dict:
    """Hold a bf16 forward's outputs to ``ref`` at BF16_BARS (or, without
    ``hold``, only measure them), on the valid points (sf_agg where the
    masks agree, as :func:`compare`); CMFlow_T's new carry is reported."""
    i_sf, i_cls, i_trans, i_mask = BF16_OUTPUTS[family]
    o, r = ([x.cpu().numpy() for x in y] for y in (out, ref))
    valid = req["valid1"]
    same = (o[i_mask] == r[i_mask]) & valid
    res = dict(trans_max_abs_err=float(np.abs(o[i_trans] - r[i_trans]).max()),
               flow_max_abs_err=float(np.abs(o[i_sf] - r[i_sf])[same].max()),
               flow_scale=max(float(np.abs(r[i_sf][valid]).max()), 1.0),
               mask_agreement=float(same[valid].mean()))
    if i_cls is not None:
        res["cls_max_abs_err"] = float(
            np.abs(o[i_cls] - r[i_cls])[valid].max())
    if family == "cmflow_t":
        res["gfeat_max_abs_err"] = float(np.abs(o[4] - r[4]).max())
    require(not hold or res.get("cls_max_abs_err", 0.0) <= BF16_BARS["cls"]
            and res["trans_max_abs_err"] <= BF16_BARS["trans"]
            and res["mask_agreement"] >= BF16_BARS["agree"]
            and res["flow_max_abs_err"]
            <= BF16_BARS["flow"] * res["flow_scale"], f"{what}: {res}")
    return res


def serve_bf16(name: str, model, cpu_model, requests) -> dict:
    """Serve ``requests`` in bf16 through ``make_eval_step(name, model,
    compute_dtype=torch.bfloat16)``, which on the card takes the fused
    engine and the kernels' bf16 arms: each forward's launches counted
    (2/2/2/1/1/4), finite outputs, each request held to the card's own
    float32 forward on the same inputs and the first to the CPU's bf16
    route (every kernel's plain version), at BF16_BARS.  CMFlow_T carries
    its GRU state frame to frame from a zero carry.  Returns the launches
    summed over the requests."""
    dev = next(model.parameters()).device
    step = make_eval_step(name, model, compute_dtype=BF16)
    require(step.fused, f"{name}: the bf16 eval step on the card must be "
                        f"fused")
    step_f32 = make_eval_step(name, model)
    cpu_step = make_eval_step(name, cpu_model, fused="on",
                              compute_dtype=BF16)
    temporal = name == "cmflow_t"
    carry = ((torch.zeros((B, model.cfg.prop_width), device=dev),)
             if temporal else ())
    launches = {k: 0 for k in COUNTERS}
    for i, req in enumerate(requests):
        zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = step(req, *carry)
        torch.cuda.synchronize()
        latency = time.perf_counter() - t0
        counts = counts_now()
        require(counts == LAUNCHES["fused"],
                f"{name} bf16 request {i}: launches {counts}")
        for k in launches:
            launches[k] += counts[k]
        b, n = req["pc1"].shape[:2]
        require(out[0].shape == (b, n, 3) and out[2].shape == (b, 4, 4)
                and all(bool(torch.isfinite(out[j]).all())
                        for j in (0, 1, 2)),
                f"{name} bf16 request {i}: output shapes or non-finite "
                f"values")
        row = dict(family=name, route="fused", dtype="bfloat16", request=i,
                   batch=int(b), bucket=int(n), latency_ms=1e3 * latency,
                   frames_per_s=b / latency, launches=counts,
                   **frame_metrics(req, out[:4]))
        row["vs_card_float32"] = compare_bf16(
            name, req, out, step_f32(req, *carry),
            f"{name} bf16 request {i} vs the card's float32")
        if i == 0:
            row["vs_cpu_bf16"] = compare_bf16(
                name, req, out, cpu_step(req, *(c.cpu() for c in carry)),
                f"{name} bf16 request {i} vs the CPU's bf16 route")
        emit(row)
        if temporal:
            carry = (out[4],)
    return launches


def leaves(tree, prefix=""):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from leaves(value, f"{prefix}{key}/")
        else:
            yield prefix + key, value


def gradient_errors(model, cpu_model, res: dict) -> dict:
    """The card's gradients against the CPU's: into ``res`` the worst and
    the median leaf's relative L2 error, the whole gradient's, and the
    largest error over each leaf's largest entry; returns each leaf's
    relative L2 error."""
    grads = dict(leaves(export_flax_variables(model, grads=True)))
    cpu_grads = dict(leaves(export_flax_variables(cpu_model, grads=True)))
    leaf_l2 = {k: float(np.linalg.norm(grads[k] - w) / np.linalg.norm(w))
               for k, w in cpu_grads.items()}
    num = sum(float(np.sum((grads[k] - w) ** 2)) for k, w in cpu_grads.items())
    den = sum(float(np.sum(w ** 2)) for w in cpu_grads.values())
    leaf_max = {k: float(np.abs(grads[k] - w).max() / np.abs(w).max())
                for k, w in cpu_grads.items()}
    res["grad_leaf_l2_max"] = max(leaf_l2.values())
    res["grad_leaf_l2_median"] = float(np.median(list(leaf_l2.values())))
    res["grad_l2"] = (num / den) ** 0.5
    res["grad_leaf_max_over_max"] = max(leaf_max.values())
    res["grad_leaves_within_1e-3_of_max"] = sum(
        v <= 1e-3 for v in leaf_max.values())
    res["grad_leaves"] = len(leaf_max)
    return leaf_l2


# each bar's key in a train step's comparison
BAR_OF = {"loss_rtol": "loss_max_rel_err", "grad_leaf_l2": "grad_leaf_l2_max",
          "grad_leaf_l2_median": "grad_leaf_l2_median", "grad_l2": "grad_l2",
          "stats_atol": "stats_max_abs_err",
          "params_atol": "params_max_abs_err"}


def compare_train_step(items, cpu_items, model, cpu_model,
                       stats=("mean", "var"), bars=TRAIN_BARS) -> dict:
    """Hold the card's first train step to the CPU's at ``bars``; of the
    BatchNorm statistics, those named in ``stats`` (the others' error is
    reported)."""
    res = {}
    res["loss_max_rel_err"] = max(
        abs(float(items[k]) - float(cpu_items[k])) / abs(float(cpu_items[k]))
        for k in cpu_items)
    leaf_l2 = gradient_errors(model, cpu_model, res)
    after = dict(leaves(export_flax_variables(model)))
    cpu_after = dict(leaves(export_flax_variables(cpu_model)))
    for kind in ("mean", "var"):
        res[f"stats_{kind}_max_abs_err"] = max(
            float(np.abs(after[k] - w).max()) for k, w in cpu_after.items()
            if k.startswith("batch_stats/") and k.endswith(kind))
    res["stats_max_abs_err"] = max(res[f"stats_{kind}_max_abs_err"]
                                   for kind in stats)
    res["params_max_abs_err"] = max(float(np.abs(after[k] - w).max())
                                    for k, w in cpu_after.items()
                                    if k.startswith("params/"))
    missed = {k: (res[BAR_OF[k]], bar) for k, bar in bars.items()
              if not res[BAR_OF[k]] <= bar}
    require(not missed,
            f"train step, card against CPU: {missed} (value, bar) in {res}, "
            f"worst leaves "
            f"{sorted(leaf_l2.items(), key=lambda kv: -kv[1])[:5]}")
    return res


def train(dev, batch: dict, compute_dtype: str = "float32") -> dict:
    """Train steps of CMFlow in ``compute_dtype`` on the card from seeded
    weights, the first one held to the same step on a CPU copy
    (TRAIN_BARS; BF16_TRAIN_BARS in bf16), each step's launches required
    (per arm in bf16); returns the launches summed over the steps."""
    path = "train" if compute_dtype == "float32" else "train_bf16"
    model = build_model("cmflow", device=dev, seed=SEED + 1,
                        compute_dtype=compute_dtype)
    cpu_model = copy.deepcopy(model).to("cpu")
    state = create_train_state(model)
    step = make_train_step("cmflow", model, VOD_CAMERA_PROJECTION,
                           VOD_T_CAMERA_RADAR)
    t0 = time.perf_counter()
    cpu_items = make_train_step("cmflow", cpu_model, VOD_CAMERA_PROJECTION,
                                VOD_T_CAMERA_RADAR)(
        create_train_state(cpu_model), batch)
    cpu_s = time.perf_counter() - t0
    b = batch["pc1"].shape[0]
    want = LAUNCHES[path]
    launches = {k: 0 for k in COUNTERS}
    losses = []
    for i in range(TRAIN_STEPS):
        zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        items = step(state, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = counts_now()
        require(counts == want,
                f"{path} step {i}: launches {counts}, want {want}")
        for k in launches:
            launches[k] += counts[k]
        values = {k: float(v) for k, v in items.items()}
        require(sorted(values) == sorted(radar_loss.LOSS_ITEMS["cmflow"]),
                f"{path} step {i}: loss items {sorted(values)}")
        require(all(np.isfinite(v) for v in values.values()),
                f"{path} step {i}: non-finite loss items {values}")
        losses.append(values["Loss"])
        row = dict(route=path, step=i, batch=int(b),
                   num_points=int(batch["pc1"].shape[1]),
                   step_ms=1e3 * wall, frames_per_s=b / wall,
                   launches=counts, **values)
        if i == 0:
            row["vs_cpu"] = compare_train_step(
                items, cpu_items, model, cpu_model,
                bars=TRAIN_BARS if path == "train" else BF16_TRAIN_BARS)
            row["cpu_step_s"] = cpu_s
        emit(row)
    require(all(v.dtype == torch.float32
                for v in model.state_dict().values()),
            f"{path}: a parameter or statistic is not float32")
    require(losses[-1] < losses[0],
            f"{path}: the last Loss {losses[-1]} is not below the first "
            f"{losses[0]}")
    return launches


# ---------------------------------------------------------------------------
# bf16 training
# ---------------------------------------------------------------------------

def gather_bf16_cases(batch: dict, dev, gen: torch.Generator):
    """The bf16 arms of K6 and K7 at every shape of the bf16 CMFlow train
    step: the gathers of the sa encoder's and the propagation encoder's
    bases and of the cost volume's base and point-to-patch cost (the xyz
    gathers and the smoothness loss's flow stay float32), on this batch's
    own neighbour indices, seeded bf16 rows and cotangents."""
    cases = []
    for case in gather_bwd_cases(batch, dev, gen):
        flat = case["csr_flat"]
        b, m = flat.shape
        c, n = case["c"], case["n"]
        if c == 3:  # the smoothness loss's flow: float32
            continue
        pts = torch.randn((b, n, c), generator=gen).to(dev).to(BF16)
        g = torch.randn((b, m, c), generator=gen).to(dev).to(BF16)
        flat_long = flat.long()
        rows = torch.arange(b, device=dev)[:, None]
        flat_rows = (flat_long + n * rows).reshape(-1)
        g_rows = g.reshape(b * m, c)
        cases.append(dict(
            kernel="gather.bf16", path="train_bf16", shape=case["shape"],
            mult=case["mult"],
            run=lambda pts=pts, flat=flat: fused.gather_rows(pts, flat),
            plain=lambda pts=pts, flat=flat: fused.gather_rows_plain(pts,
                                                                     flat),
            library=lambda pts=pts, flat_long=flat_long, rows=rows:
                pts[rows, flat_long],
            nbytes=2 * b * n * c + 4 * b * m + 2 * b * m * c, flops=0))
        cases.append(dict(
            kernel="gather_bwd.bf16", path="train_bf16",
            shape=case["shape"], mult=case["mult"],
            run=lambda g=g, flat=flat: fused.gather_rows_backward(g, flat, n),
            plain=lambda g=g, flat=flat: fused.gather_rows_backward_plain(
                g, flat, n),
            csr=case["csr"], csr_plain=case["csr_plain"],
            # index_add_ in float32, then one cast
            library=lambda flat_rows=flat_rows, g_rows=g_rows, c=c:
                torch.zeros((b * n, c), device=dev).index_add_(
                    0, flat_rows, g_rows.float()).to(BF16),
            nbytes=2 * b * m * c + 4 * b * m + 2 * b * n * c,
            flops=b * m * c))
    return cases


def family_bf16_steps(dev) -> dict:
    """One bf16 RaFlow train step and one bf16 CMFlow_T T=2 clip step from
    seeded weights, each with its launches per arm and finite items."""
    out = {}
    for name in ("raflow", "cmflow_t"):
        model = build_model(name, dev, seed=FAMILY_SEED[name] + 1,
                            compute_dtype="bfloat16")
        state = create_train_state(model)
        frames = [make_train_batch(FAMILY_SEED[name] + i, B, 256)
                  for i in range(2 if name == "cmflow_t" else 1)]
        if name == "raflow":
            step = make_train_step(name, model, VOD_CAMERA_PROJECTION,
                                   VOD_T_CAMERA_RADAR)
            batch = frames[0]
        else:
            step = make_train_step_seq(model, VOD_CAMERA_PROJECTION,
                                       VOD_T_CAMERA_RADAR)
            batch = {k: np.stack([f[k] for f in frames], axis=1)
                     for k in frames[0]}
        zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        items = step(state, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = counts_now()
        want = {k: len(frames) * v for k, v in LAUNCHES["train_bf16"].items()}
        require(counts == want,
                f"{name} bf16 step: launches {counts}, want {want}")
        values = {k: float(v) for k, v in items.items()}
        require(sorted(values) == sorted(radar_loss.LOSS_ITEMS[name])
                and all(np.isfinite(v) for v in values.values()),
                f"{name} bf16 step: loss items {values}")
        out[f"{name}_train_bf16"] = counts
        emit(dict(family=name, route="train_bf16", frames=len(frames),
                  batch=B, num_points=256, step_ms=1e3 * wall,
                  launches=counts, **values))
    return out


def cli_bf16_phase(dev) -> dict:
    """A 2-epoch bf16 CLI train of CMFlow (``--compute_dtype bfloat16``)
    and a 1-epoch resume from its ``models/last``, at full width on the
    card, each run's launches required exactly (the train steps on the
    bf16 arms, validation on the fused float32 engine)."""
    steps_per_epoch = CLI_PARTS["train"] // CLI_BATCH
    with tempfile.TemporaryDirectory() as tmp:
        root, ck = os.path.join(tmp, "data"), os.path.join(tmp, "checkpoints")
        write_synthetic_dataset(root, CLI_PARTS, seed=SEED)
        common = ["--config", CLI_CONFIG, "--dataset_path", root,
                  "--checkpoints_dir", ck, "--num_workers", "0",
                  "--batch_size", str(CLI_BATCH), "--compute_dtype",
                  "bfloat16"]
        runs = {"train_bf16": run_cli(
            common + ["--exp_name", "train", "--epochs", str(CLI_EPOCHS)],
            CLI_EPOCHS * steps_per_epoch, CLI_EPOCHS, "train_bf16")}
        rows = require_finite_rows(os.path.join(ck, "train", "metrics.jsonl"),
                                   ["train", "val"] * CLI_EPOCHS)
        last = os.path.join(ck, "train", "models", "last")
        saved = torch.load(last, map_location="cpu", weights_only=True)
        runs["resume_bf16"] = run_cli(
            common + ["--exp_name", "resume", "--epochs", "1",
                      "--load_checkpoint", "--model_path", last],
            steps_per_epoch, 1, "train_bf16")
        resumed = torch.load(os.path.join(ck, "resume", "models", "last"),
                             map_location="cpu", weights_only=True)
        require(resumed["step"] == saved["step"] + steps_per_epoch,
                f"bf16 resume: step {resumed['step']}")
        require(all(v.dtype == torch.float32
                    for v in resumed["model"].values()),
                "bf16 checkpoint: a tensor not float32")
        require_finite_rows(os.path.join(ck, "resume", "metrics.jsonl"),
                            ["train", "val"])
        numbers = {k: read_log(os.path.join(ck, k))
                   for k in ("train", "resume")}
    return dict(runs=runs,
                train_frames_per_s=numbers["train"]["train_frames_per_s"],
                resume_frames_per_s=numbers["resume"]["train_frames_per_s"],
                train_loss=[r["Loss"] for r in rows if r["phase"] == "train"],
                val_rne=[r["rne"] for r in rows if r["phase"] == "val"])


# ---------------------------------------------------------------------------
# the experiment loop through the CLI
# ---------------------------------------------------------------------------

# the synthetic tree of the CLI phase (default n_range, 200-319 points), the
# train batch and epochs; validation and eval run at the config's
# eval_batch_size (64): one batch of 32 frames and 32 repeated lanes
CLI_PARTS = {"train": 64, "val": 32, "test": 32}
CLI_BATCH = 16
CLI_EPOCHS = 2
CLI_CONFIG = "configs/cmflow.yaml"
# the device metric battery (float32) against the host one (float64) on the
# same predictions
METRICS_ATOL = 1e-4
# the kernels each route of the loop must launch
CLI_KERNELS = {"train": ("ball_query", "knn", "gather", "gather_bwd"),
               "fused": ("ball_query", "knn", "mse", "cv", "cv_agg", "plf")}


def run_cli(args, steps: int, val_batches: int,
            train_path: str = "train") -> dict:
    """``cli.main(args)`` with every launch counter set to 0 just before and
    read just after; requires the launches of ``steps`` train steps (module
    route, ``LAUNCHES[train_path]``) and ``val_batches`` fused forwards,
    nothing else."""
    zero_counts()
    t0 = time.perf_counter()
    rc = cli.main(args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = counts_now()
    require(rc == 0, f"cli {args}: exit code {rc}")
    want = {k: steps * LAUNCHES[train_path][k]
            + val_batches * LAUNCHES["fused"][k] for k in COUNTERS}
    require(counts == want, f"cli {args}: launches {counts}, want {want}")
    for route, n in (("train", steps), ("fused", val_batches)):
        require(n == 0 or all(counts[k] > 0 for k in CLI_KERNELS[route]),
                f"cli {args}: a kernel of the {route} route was not launched")
    return dict(wall_s=wall, launches=counts)


def read_log(exp: str) -> dict:
    """The loop's own numbers from its run.log."""
    text = open(os.path.join(exp, "run.log")).read()
    return dict(
        train_frames_per_s=[float(x) for x in re.findall(
            r"mean train loss: \S+ \(\d+ steps, \S+s, (\S+) frames/s\)",
            text)],
        eval_ms_per_frame=[float(x) for x in re.findall(
            r"###The inference speed is (\S+)ms per frame###", text)],
        means={k: float(v) for k, v in re.findall(
            r"###The mean (.+?): (\S+)###", text)},
        peak_memory_mb=[float(x) for x in re.findall(
            r"Max memory allocation: (\S+)MB", text)])


def require_finite_rows(path: str, phases) -> list:
    rows = [json.loads(line) for line in open(path)]
    require([r["phase"] for r in rows] == list(phases),
            f"{path}: phases {[r['phase'] for r in rows]}")
    for r in rows:
        values = {k: v for k, v in r.items()
                  if k not in ("epoch", "phase", "ts")}
        require(values and all(np.isfinite(v) for v in values.values()),
                f"{path}: a loss or metric is not finite: {r}")
    return rows


def checkpoint_bits_equal(model, path: str) -> None:
    saved = torch.load(path, map_location="cpu", weights_only=True)["model"]
    state = model.state_dict()
    require(sorted(saved) == sorted(state), f"{path}: state_dict keys")
    for k, v in saved.items():
        require(torch.equal(state[k].cpu(), v),
                f"{path}: {k} restored with other bits")


def upload_as_the_loop(batch: dict, cfg, dev) -> dict:
    """A loader batch on the card as ``evaluate_frames`` sends it: the
    loader's metadata and the pseudo-label inputs stripped, then the
    config's eval wire."""
    host = {k: v for k, v in batch.items()
            if not k.startswith("_")
            and k not in ("radar_u", "radar_v", "opt_flow")}
    return loop.upload_eval_batch(
        loop.pack_eval_batch(host, cfg.eval_wire, pin=True), dev)


def loop_batch_checks(model, root: str, dev) -> dict:
    """One B=64 eval batch of the test split as the loop forms it (pinned
    buckets, repeated lanes, the int16 wire): each fused kernel at its
    shapes against its plain version, the device metric battery against the
    host one on the same predictions, and the fused route against the
    module route."""
    cfg = load_config(CLI_CONFIG)
    ds = VodDataset(root, cfg.eval_split, cfg.num_points, eval_mode=True,
                    log=lambda text: None)
    batch = next(iter(BatchLoader(
        ds, cfg.eval_batch_size, pad_bucket=cfg.num_points,
        pad_buckets=loop._pinned_buckets(cfg), num_workers=0,
        pad_batch=True)))
    x = upload_as_the_loop(batch, cfg, dev)
    b, n = x["pc1"].shape[:2]
    require(b == cfg.eval_batch_size and not bool(x["lane_valid"].all()),
            f"loop batch: B={b}, lanes {int(x['lane_valid'].sum())}")
    with torch.no_grad():
        for case in fused_cases(model, x, dev):
            err, scale = hold_to_plain(case)
            emit(dict(kernel=case["kernel"], path="cli", shape=case["shape"],
                      max_abs_err=err, plain_max_abs=scale,
                      kernel_event_ms=event_ms(case["run"], 20)))
    step = make_eval_step("cmflow", model)
    require(step.fused, "the loop's eval step on the card must be fused")
    out = step(x)
    pred_f, _, pred_t, pred_m = out
    vec = device_metrics.frame_metrics(
        x["pc1"], pred_f, x["labels"], x["mask"], x["valid1"], x["trans"],
        pred_t, pred_m).cpu().numpy()
    h = {k: v.cpu().numpy() for k, v in x.items()}
    keep = h["lane_valid"] & (h["valid1"].sum(1) > 0)
    f, t, m = (o.cpu().numpy()[keep] for o in (pred_f, pred_t, pred_m))
    v = h["valid1"][keep]
    want = {**metrics.eval_scene_flow_batch(h["pc1"][keep], f,
                                            h["labels"][keep],
                                            h["mask"][keep], v),
            **metrics.eval_motion_seg_batch(m.astype(np.float32),
                                            h["mask"][keep], v),
            **metrics.eval_trans_rpe_batch(h["trans"][keep], t)}
    err = {k: float(np.abs(vec[keep, j] - want[k]).max())
           for j, k in enumerate(device_metrics.METRIC_KEYS)}
    require(max(err.values()) <= METRICS_ATOL,
            f"device metrics against the host battery: {err}")
    req = {"valid1": h["valid1"]}
    vs_module = compare(req, out, make_eval_step("cmflow", model,
                                                 fused="off")(x),
                        "loop batch: fused vs module route")
    return dict(batch=int(b), bucket=int(n),
                real_lanes=int(h["lane_valid"].sum()),
                device_metrics_max_abs_err=err, vs_module_route=vs_module)


def cli_phase(dev, card: str) -> tuple:
    """Train, resume and evaluate through ``cmflow_tpu_torch.cli.main`` on a
    synthetic tree in a temporary directory, at full width on the card;
    returns the numbers and the model restored from ``models/best``."""
    steps_per_epoch = CLI_PARTS["train"] // CLI_BATCH
    with tempfile.TemporaryDirectory() as tmp:
        root, ck = os.path.join(tmp, "data"), os.path.join(tmp, "checkpoints")
        write_synthetic_dataset(root, CLI_PARTS, seed=SEED)
        common = ["--config", CLI_CONFIG, "--dataset_path", root,
                  "--checkpoints_dir", ck, "--num_workers", "0"]
        train_args = ["--batch_size", str(CLI_BATCH)]

        runs = {"train": run_cli(
            common + train_args + ["--exp_name", "train", "--epochs",
                                   str(CLI_EPOCHS)],
            CLI_EPOCHS * steps_per_epoch, CLI_EPOCHS)}
        exp = os.path.join(ck, "train")
        require_finite_rows(os.path.join(exp, "metrics.jsonl"),
                            ["train", "val"] * CLI_EPOCHS)
        best, last = (os.path.join(exp, "models", k) for k in ("best", "last"))

        model = build_model("cmflow", dev)
        loop.restore_checkpoint(best, create_train_state(model))
        checkpoint_bits_equal(model, best)

        saved = torch.load(last, map_location="cpu", weights_only=True)
        runs["resume"] = run_cli(
            common + train_args + ["--exp_name", "resume", "--epochs", "1",
                                   "--load_checkpoint", "--model_path", last],
            steps_per_epoch, 1)
        resumed = torch.load(os.path.join(ck, "resume", "models", "last"),
                             map_location="cpu", weights_only=True)
        cfg = load_config(CLI_CONFIG)
        step = saved["step"] + steps_per_epoch
        require(resumed["step"] == step,
                f"resume: step {resumed['step']}, want {step}")
        require(all(float(s["step"]) == step
                    for s in resumed["optimizer"]["state"].values()),
                f"resume: Adam's steps do not continue from {saved['step']}")
        lr = cfg.lr * cfg.decay_rate ** (step // (cfg.decay_epochs
                                                  * steps_per_epoch))
        got_lr = resumed["optimizer"]["param_groups"][0]["lr"]
        require(got_lr == lr, f"resume: lr {got_lr}, want {lr}")
        require_finite_rows(os.path.join(ck, "resume", "metrics.jsonl"),
                            ["train", "val"])

        runs["eval"] = run_cli(common + ["--exp_name", "eval", "--eval",
                                         "--save_res", "--model_path", best],
                               0, 1)
        runs["eval_bf16"] = run_cli(
            common + ["--exp_name", "eval_bf16", "--eval",
                      "--eval_compute_dtype", "bfloat16", "--model_path",
                      best], 0, 1)
        results = os.path.join(ck, "eval", "results")
        dumps = [f for _, _, fs in os.walk(results) for f in fs]
        require(len(dumps) == CLI_PARTS["test"],
                f"eval --save_res wrote {len(dumps)} result files, want "
                f"{CLI_PARTS['test']}")
        numbers = {k: read_log(os.path.join(ck, k))
                   for k in ("train", "resume", "eval", "eval_bf16")}
        for k in ("eval", "eval_bf16"):
            require(all(np.isfinite(v) for v in numbers[k]["means"].values())
                    and len(numbers[k]["means"]) == 14,
                    f"{k} means: {numbers[k]['means']}")
        rne, rne_bf16 = (numbers[k]["means"]["rne"]
                         for k in ("eval", "eval_bf16"))
        rne_rel = abs(rne_bf16 - rne) / abs(rne)
        require(rne_rel <= BF16_RNE_RTOL,
                f"eval --eval_compute_dtype bfloat16: RNE {rne_bf16} against "
                f"{rne} in float32")
        batch = loop_batch_checks(model, root, dev)
    return model, dict(
        card=card, runs=runs, resume=dict(step=step, lr=got_lr),
        loop_batch=batch,
        train_frames_per_s=numbers["train"]["train_frames_per_s"],
        val_ms_per_frame=numbers["train"]["eval_ms_per_frame"],
        eval_ms_per_frame=numbers["eval"]["eval_ms_per_frame"],
        eval_peak_memory_mb=numbers["eval"]["peak_memory_mb"],
        eval_means=numbers["eval"]["means"],
        eval_bf16=dict(
            ms_per_frame=numbers["eval_bf16"]["eval_ms_per_frame"],
            peak_memory_mb=numbers["eval_bf16"]["peak_memory_mb"],
            means=numbers["eval_bf16"]["means"],
            rne_rel_to_float32=rne_rel))


# ---------------------------------------------------------------------------
# RaFlow and CMFlow_T
# ---------------------------------------------------------------------------

FAMILY_SEED = {"raflow": SEED + 20, "cmflow_t": SEED + 30}
SEQ_T = 5  # mini_clip_len of configs/cmflow_t.yaml
SEQ_FRAMES = 3  # frames served with the carry
FAMILY_TRAIN_STEPS = {"raflow": 6, "cmflow_t": 3}  # steps, clip steps
GFEAT_ATOL = 1e-4
FAMILY_CONFIG = {"raflow": "configs/raflow.yaml",
                 "cmflow_t": "configs/cmflow_t.yaml"}
# each family's synthetic tree for the CLI: {partition: (frames, clips)}.
# CMFlow_T: 16 mini-clips of 5 (one clip batch), val and test in 8 clips,
# so its evaluation runs 8 lanes
FAMILY_TREE = {"raflow": {"train": (64, 2), "val": (32, 2), "test": (32, 2)},
               "cmflow_t": {"train": (80, 1), "val": (48, 8),
                            "test": (16, 8)}}


def hold_cases(cases) -> int:
    """Hold each case's kernel to its plain version, untimed; returns the
    count of cases."""
    with torch.no_grad():
        for case in cases:
            hold_to_plain(case)
    return len(cases)


def compare_raflow(req, out, ref, what: str) -> dict:
    """RaFlow's ``(sf_agg, mask_s as float, pre_trans, mask_s)`` held to
    ``ref`` at the serving bars, on the valid points."""
    (sf, _, trans, mask), (rsf, _, rtrans, rmask) = (
        [x.cpu().numpy() for x in o] for o in (out, ref))
    valid = req["valid1"]
    same = (mask == rmask) & valid
    res = dict(trans_max_abs_err=float(np.abs(trans - rtrans).max()),
               flow_max_abs_err=float(np.abs(sf - rsf)[same].max()),
               mask_agreement=float((mask == rmask)[valid].mean()))
    require(res["trans_max_abs_err"] <= BARS["trans"]
            and res["flow_max_abs_err"] <= BARS["flow"]
            and res["mask_agreement"] >= BARS["agree"], f"{what}: {res}")
    return res


def compare_temporal(req, out, ref, what: str) -> dict:
    """CMFlow_T's five outputs: the serving bars, and the new carry."""
    res = compare(req, out[:4], ref[:4], what)
    res["gfeat_max_abs_err"] = float((out[4].cpu() - ref[4].cpu()).abs()
                                     .max())
    require(res["gfeat_max_abs_err"] <= GFEAT_ATOL, f"gfeat {what}: {res}")
    return res


def serve_raflow(dev, gen, requests) -> tuple:
    """RaFlow with seeded weights and BatchNorm statistics through
    ``make_eval_step`` on the fused route; its kernels held to their plain
    versions at its first request; the first request held to the CPU and to
    the module route.  Returns the launches, the kernel cases held and the
    model."""
    model = build_model("raflow", dev, seed=FAMILY_SEED["raflow"])
    module_step = make_eval_step("raflow", model, fused="off")
    randomize_batchnorm(model, module_step,
                        make_request(SEED + 98, B, (200, 256)), gen)
    step = make_eval_step("raflow", model)
    require(step.fused, "raflow: make_eval_step on the card must be fused")
    cpu_model = copy.deepcopy(model).to("cpu")
    held = hold_cases(fused_cases(model, requests[0], dev))

    def checks(req, out):
        return dict(
            vs_cpu=compare_raflow(req, out, make_eval_step(
                "raflow", cpu_model, fused="on")(req), "raflow fused vs CPU"),
            vs_module_route=compare_raflow(req, out, module_step(req),
                                           "raflow fused vs module route"))

    launches = serve("fused", step, requests, checks, family="raflow")
    return launches, held, model


def serve_cmflow_t(dev, gen, frames) -> tuple:
    """CMFlow_T with seeded weights and BatchNorm statistics: SEQ_FRAMES
    B=16 frames through ``make_eval_step`` on the fused route with the GRU
    carry, every lane reset at frame 0 and lane 0 again at frame 2
    (``cmflow_t_infer_seq``'s resets).  Each frame's launches; the first
    frame held to the module route; every frame and the final carry held
    to ``cmflow_t_infer_seq`` on the CPU and on the card.  Returns the
    launches, the kernel cases held and the model."""
    model = build_model("cmflow_t", dev, seed=FAMILY_SEED["cmflow_t"])
    width = model.cfg.prop_width
    module_step = make_eval_step("cmflow_t", model, fused="off")
    zeros = torch.zeros((B, width), device=dev)
    randomize_batchnorm(model, lambda req: module_step(req, zeros),
                        make_request(SEED + 97, B, (200, 256)), gen)
    step = make_eval_step("cmflow_t", model)
    require(step.fused, "cmflow_t: make_eval_step on the card must be fused")
    cpu_model = copy.deepcopy(model).to("cpu")
    held = hold_cases(fused_cases(model, frames[0], dev))

    reset = torch.zeros((SEQ_FRAMES, B), dtype=torch.bool)
    reset[0] = True
    reset[2, 0] = True
    start = torch.full((B, width), 7.0)  # dropped by the first reset
    gfeat = start.to(dev)
    launches = {k: 0 for k in COUNTERS}
    outs = []
    for t, req in enumerate(frames):
        gfeat = loop.reset_lanes(gfeat, reset[t].to(dev))
        zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = step(req, gfeat)
        torch.cuda.synchronize()
        latency = time.perf_counter() - t0
        counts = counts_now()
        require(counts == LAUNCHES["fused"],
                f"cmflow_t frame {t}: launches {counts}")
        for k in launches:
            launches[k] += counts[k]
        require(out[4].shape == (B, width)
                and all(bool(torch.isfinite(x).all())
                        for x in (out[0], out[1], out[2], out[4])),
                f"cmflow_t frame {t}: output shapes or non-finite values")
        row = dict(family="cmflow_t", route="fused", frame=t, batch=B,
                   bucket=int(req["pc1"].shape[1]), latency_ms=1e3 * latency,
                   frames_per_s=B / latency, launches=counts,
                   reset_lanes=int(reset[t].sum()),
                   **frame_metrics(req, out[:4]))
        if t == 0:
            row["vs_module_route"] = compare_temporal(
                req, out, module_step(req, gfeat), "cmflow_t fused vs module")
        emit(row)
        outs.append(out)
        gfeat = out[4]

    keys = ("pc1", "pc2", "ft1", "ft2", "valid1", "valid2")
    stacked = {k: torch.stack([torch.as_tensor(r[k]) for r in frames])
               for k in keys}
    seq = {}
    for name, m, d in (("card", model, dev), ("cpu", cpu_model, "cpu")):
        (sf, cls, trans, mask), final = inference.cmflow_t_infer_seq(
            m, *(stacked[k].to(d) for k in keys[:4]), start.to(d),
            reset.to(d), stacked["valid1"].to(d), stacked["valid2"].to(d))
        seq[name] = [(sf[t], cls[t], trans[t], mask[t],
                      final if t == SEQ_FRAMES - 1 else outs[t][4])
                     for t in range(SEQ_FRAMES)]
    checks = {}
    for name, ref in seq.items():
        checks[name] = [compare_temporal(frames[t], outs[t], ref[t],
                                         f"cmflow_t frame {t} vs {name} seq")
                        for t in range(SEQ_FRAMES)]
    emit(dict(family="cmflow_t", route="fused", sequence=SEQ_FRAMES,
              vs_infer_seq_card=checks["card"],
              vs_infer_seq_cpu=checks["cpu"]))
    return launches, held, model


def lr0_clip_steps(model, cpu_model, clip: dict) -> tuple:
    """One mini-clip step at learning rate 0 on the card and on the CPU,
    each model left with its last frame's gradients; the two steps' loss
    items."""
    return tuple(make_train_step_seq(m, VOD_CAMERA_PROJECTION,
                                     VOD_T_CAMERA_RADAR)(
        create_train_state(m, lr=0.0), clip) for m in (model, cpu_model))


def train_family(name: str, dev, gen) -> tuple:
    """Train steps of ``name`` on the card from seeded weights.

    RaFlow: FAMILY_TRAIN_STEPS B=16, N=256 steps on one batch, the first
    held to the same step on the CPU at TRAIN_BARS.  CMFlow_T: first a T=2
    mini-clip step at learning rate 0 on the clip's first frame twice, held
    to the CPU (loss items, running means, and the second frame's
    gradients, which take the first frame's carry; the running variances
    reported, see tests/test_torch_cmflow_t.py); then the same step on the
    clip's first two frames, its second frame's gradients held at the
    median leaf (the per-leaf bar) and the rest reported: there the loss is
    not smooth at float32's scale, and two implementations' whole gradients
    lie ~1.4e-2 apart (``python tests/test_torch_cmflow_t.py gradients``;
    scripts/profile_torch_seq_grad_jitter.py).  Then FAMILY_TRAIN_STEPS
    steps on one T=SEQ_T clip at the config's learning rate.  The kernels
    of the backward are held to their plain versions at every frame's
    shapes.  Returns the launches summed over the steps and the count of
    kernel cases held."""
    seed = FAMILY_SEED[name]
    n_frames = SEQ_T if name == "cmflow_t" else 1
    frames = [make_train_batch(seed + i, B, 256) for i in range(n_frames)]
    held = sum(hold_cases(gather_bwd_cases(f, dev, gen)
                          + train_ball_cases(f, dev)) for f in frames)
    model = build_model(name, dev, seed=seed)
    cpu_model = copy.deepcopy(model).to("cpu")
    t0 = time.perf_counter()
    if name == "raflow":
        batch = frames[0]
        state = create_train_state(model)
        step = make_train_step(name, model, VOD_CAMERA_PROJECTION,
                               VOD_T_CAMERA_RADAR)
        cpu_items = make_train_step(name, cpu_model, VOD_CAMERA_PROJECTION,
                                    VOD_T_CAMERA_RADAR)(
            create_train_state(cpu_model), batch)
        want = LAUNCHES["train"]
        vs_cpu = None
    else:
        batch = {k: np.stack([f[k] for f in frames], axis=1)
                 for k in frames[0]}
        two = {k: np.repeat(v[:, :1], 2, axis=1) for k, v in batch.items()}
        vs_cpu = compare_train_step(*lr0_clip_steps(model, cpu_model, two),
                                    model, cpu_model, stats=("mean",))
        # two distinct frames: the median leaf held, the rest reported
        lr0_clip_steps(model, cpu_model,
                       {k: v[:, :2] for k, v in batch.items()})
        distinct = {}
        leaf_l2 = gradient_errors(model, cpu_model, distinct)
        vs_cpu["two_frames"] = distinct
        require(distinct["grad_leaf_l2_median"] <= TRAIN_BARS["grad_leaf_l2"],
                f"cmflow_t train gradients on two frames: {distinct}, worst "
                f"leaves {sorted(leaf_l2.items(), key=lambda kv: -kv[1])[:5]}")
        state = create_train_state(model)
        step = make_train_step_seq(model, VOD_CAMERA_PROJECTION,
                                   VOD_T_CAMERA_RADAR)
        want = {k: SEQ_T * v for k, v in LAUNCHES["train"].items()}
    cpu_s = time.perf_counter() - t0
    launches = {k: 0 for k in COUNTERS}
    losses = []
    for i in range(FAMILY_TRAIN_STEPS[name]):
        zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        items = step(state, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = counts_now()
        require(counts == want, f"{name} train step {i}: launches {counts}, "
                                f"want {want}")
        for k in launches:
            launches[k] += counts[k]
        values = {k: float(v) for k, v in items.items()}
        require(sorted(values) == sorted(radar_loss.LOSS_ITEMS[name])
                and all(np.isfinite(v) for v in values.values()),
                f"{name} train step {i}: loss items {values}")
        losses.append(values["Loss"])
        row = dict(family=name, route="train", step=i, batch=B,
                   num_points=256, frames_per_step=B * n_frames,
                   step_ms=1e3 * wall, frames_per_s=B * n_frames / wall,
                   launches=counts, **values)
        if i == 0:
            row["vs_cpu"] = (compare_train_step(items, cpu_items, model,
                                                cpu_model)
                             if vs_cpu is None else vs_cpu)
            row["cpu_s"] = cpu_s
        emit(row)
    require(losses[-1] < losses[0], f"{name} train: the last Loss "
                                    f"{losses[-1]} is not below the first "
                                    f"{losses[0]}")
    return launches, held


def lane_batch_checks(model, root: str, dev) -> dict:
    """CMFlow_T's first evaluation batch as the loop forms it: one lane per
    val clip (``build_clip_plan``), the int16 wire.  Each fused kernel at
    its shapes against its plain version, and the fused route against the
    module route from the reset carry."""
    cfg = load_config(FAMILY_CONFIG["cmflow_t"])
    ds = VodClipDataset(root, "val", cfg.num_points, eval_mode=True,
                        update_len=cfg.update_len, log=lambda text: None)
    lanes = min(cfg.eval_batch_size, len(ds.clips_info))
    plan = loop.build_clip_plan(ds.clips_info, lanes, cfg.update_len)
    batch = next(iter(BatchLoader(
        ds, lanes, pad_bucket=cfg.num_points,
        pad_buckets=loop._pinned_buckets(cfg), num_workers=0, plan=plan)))
    x = upload_as_the_loop(batch, cfg, dev)
    b, n = x["pc1"].shape[:2]
    require(b == len(ds.clips_info) and bool(x["reset"].all()),
            f"lane batch: B={b}, resets {x['reset'].tolist()}")
    held = hold_cases(fused_cases(model, x, dev))
    gfeat = loop.reset_lanes(torch.ones((b, model.cfg.prop_width),
                                        device=dev), x["reset"])
    out = make_eval_step("cmflow_t", model)(x, gfeat)
    ref = make_eval_step("cmflow_t", model, fused="off")(x, gfeat)
    vs_module = compare_temporal({"valid1": batch["valid1"]}, out, ref,
                                 "lane batch: fused vs module route")
    return dict(lanes=int(b), bucket=int(n), kernel_cases=held,
                vs_module_route=vs_module)


def family_cli_phase(name: str, dev) -> tuple:
    """Train (2 epochs), resume (1 epoch) and evaluate ``name`` through
    ``cmflow_tpu_torch.cli.main`` on its synthetic tree (FAMILY_TREE) at
    full width on the card, each run's launches required exactly; returns
    the numbers and the model restored from ``models/best``."""
    cfg = load_config(FAMILY_CONFIG[name])
    parts = FAMILY_TREE[name]
    temporal = name == "cmflow_t"
    t_len = cfg.mini_clip_len if temporal else 1
    train_frames, train_clips = parts["train"]
    per_clip = train_frames // train_clips
    batches = (train_clips * (per_clip // t_len) if temporal
               else train_frames) // CLI_BATCH
    steps_per_epoch = batches * t_len  # optimizer steps

    def eval_batches(partition):
        frames, clips = parts[partition]
        if temporal:  # a lane per clip, as long as a clip
            return frames // clips
        return -(-frames // cfg.eval_batch_size)

    with tempfile.TemporaryDirectory() as tmp:
        root, ck = os.path.join(tmp, "data"), os.path.join(tmp, "checkpoints")
        for i, (part, (frames, clips)) in enumerate(parts.items()):
            write_synthetic_dataset(root, {part: frames},
                                    clips_per_partition=clips, seed=SEED + i)
        common = ["--config", FAMILY_CONFIG[name], "--dataset_path", root,
                  "--checkpoints_dir", ck, "--num_workers", "0",
                  "--batch_size", str(CLI_BATCH)]
        runs = {"train": run_cli(
            common + ["--exp_name", "train", "--epochs", str(CLI_EPOCHS)],
            CLI_EPOCHS * steps_per_epoch, CLI_EPOCHS * eval_batches("val"))}
        exp = os.path.join(ck, "train")
        require_finite_rows(os.path.join(exp, "metrics.jsonl"),
                            ["train", "val"] * CLI_EPOCHS)
        best, last = (os.path.join(exp, "models", k) for k in ("best", "last"))
        model = build_model(name, dev)
        loop.restore_checkpoint(best, create_train_state(model))
        checkpoint_bits_equal(model, best)
        saved = torch.load(last, map_location="cpu", weights_only=True)
        runs["resume"] = run_cli(
            common + ["--exp_name", "resume", "--epochs", "1",
                      "--load_checkpoint", "--model_path", last],
            steps_per_epoch, eval_batches("val"))
        resumed = torch.load(os.path.join(ck, "resume", "models", "last"),
                             map_location="cpu", weights_only=True)
        step = saved["step"] + steps_per_epoch
        # the schedule counts batches (clip batches), one step per frame
        lr = cfg.lr * cfg.decay_rate ** (step // (cfg.decay_epochs * batches))
        got_lr = resumed["optimizer"]["param_groups"][0]["lr"]
        require(resumed["step"] == step
                and math.isclose(got_lr, lr, rel_tol=1e-12),
                f"{name} resume: step {resumed['step']} lr {got_lr}, want "
                f"{step} and {lr}")
        require_finite_rows(os.path.join(ck, "resume", "metrics.jsonl"),
                            ["train", "val"])
        runs["eval"] = run_cli(common + ["--exp_name", "eval", "--eval",
                                         "--save_res", "--model_path", best],
                               0, eval_batches("test"))
        dumps = [f for _, _, fs in os.walk(os.path.join(ck, "eval",
                                                        "results"))
                 for f in fs]
        require(len(dumps) == parts["test"][0],
                f"{name} eval --save_res wrote {len(dumps)} files")
        numbers = {k: read_log(os.path.join(ck, k))
                   for k in ("train", "resume", "eval")}
        require(len(numbers["eval"]["means"]) == 14
                and all(np.isfinite(v)
                        for v in numbers["eval"]["means"].values()),
                f"{name} eval means: {numbers['eval']['means']}")
        lanes = lane_batch_checks(model, root, dev) if temporal else None
    return model, dict(
        family=name, runs=runs, resume=dict(step=step, lr=got_lr),
        lane_batch=lanes,
        train_frames_per_s=numbers["train"]["train_frames_per_s"],
        val_ms_per_frame=numbers["train"]["eval_ms_per_frame"],
        eval_ms_per_frame=numbers["eval"]["eval_ms_per_frame"],
        eval_peak_memory_mb=numbers["eval"]["peak_memory_mb"],
        eval_means=numbers["eval"]["means"])


# ---------------------------------------------------------------------------
# data parallelism: two ranks sharing the one card (gloo), a one-rank NCCL
# group, and the CLI under torch.distributed.run
# ---------------------------------------------------------------------------

DDP_RANKS = 2
DDP_TIMED_STEPS = 3
# case: (model, weight seed, compute dtype, mini-clip length or None)
DDP_CASES = {"cmflow": ("cmflow", SEED + 1, "float32", None),
             "raflow": ("raflow", FAMILY_SEED["raflow"], "float32", None),
             "cmflow_t_t1": ("cmflow_t", FAMILY_SEED["cmflow_t"], "float32",
                             1),
             "cmflow_t_t2": ("cmflow_t", FAMILY_SEED["cmflow_t"], "float32",
                             2),
             "cmflow_bf16": ("cmflow", SEED + 1, "bfloat16", None)}
# the cases held to the one-process step at the train bars; CMFlow_T at
# T=2 is held to finiteness (as the JAX package holds its own), the bf16
# step to finiteness with its distance printed
DDP_HELD = ("cmflow", "raflow", "cmflow_t_t1")
DDP_EVAL_DTYPES = {"float32": torch.float32, "bf16": BF16}
DDP_N = 256  # the train batches' points a cloud
# the CLI phase under the launcher: one epoch on two ranks and on one, the
# same batches at learning rate 0, their losses within this
CLI_DDP_LOSS_RTOL = 1e-3
CLI_DDP_METRICS_ATOL = 1e-5


def ddp_batch(case: str) -> dict:
    """The global batch of a case (B=16, N=256), the same in every
    process; CMFlow_T's is a mini-clip of one frame repeated."""
    name, _, _, t = DDP_CASES[case]
    batch = make_train_batch(FAMILY_SEED.get(name, SEED), B, DDP_N)
    if t is not None:
        batch = {k: np.repeat(v[:, None], t, axis=1) for k, v in batch.items()}
    return batch


def ddp_step(case: str, dev, group) -> dict:
    """One train step of a case from its seeded weights: on the whole batch
    without a group, on this rank's rows with one.  Its loss items, the
    gradients it applied (before Adam), the variables after it and the
    launches."""
    name, seed, dtype, t = DDP_CASES[case]
    model = build_model(name, dev, seed=seed, compute_dtype=dtype,
                        group=group)
    state = create_train_state(model)
    if t is None:
        step = make_train_step(name, model, VOD_CAMERA_PROJECTION,
                               VOD_T_CAMERA_RADAR, group=group)
    else:
        step = make_train_step_seq(model, VOD_CAMERA_PROJECTION,
                                   VOD_T_CAMERA_RADAR, group=group)
    batch = ddp_batch(case)
    if group is not None:
        batch = mesh.shard_batch(batch, group)
    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    items = step(state, batch)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return dict(items={k: float(v) for k, v in items.items()},
                grads=export_flax_variables(model, grads=True)["params"],
                after=export_flax_variables(model), launches=counts_now(),
                first_step_ms=1e3 * wall, step=step, state=state,
                batch=batch)


class _CountCollectives:
    """Counts the ``all_reduce`` calls and bytes of one step (patched over
    ``torch.distributed.all_reduce`` while it runs)."""

    def __init__(self):
        self.calls, self.bytes, self.sizes = 0, 0, {}

    def __enter__(self):
        self.real = dist.all_reduce

        def counting(tensor, *args, **kwargs):
            self.calls += 1
            self.bytes += tensor.numel() * tensor.element_size()
            self.sizes[tensor.numel()] = self.sizes.get(tensor.numel(), 0) + 1
            return self.real(tensor, *args, **kwargs)

        dist.all_reduce = counting
        return self

    def __exit__(self, *exc):
        dist.all_reduce = self.real


def timed_steps(res: dict) -> list:
    """DDP_TIMED_STEPS more steps of a case on its batch: wall ms each."""
    times = []
    for _ in range(DDP_TIMED_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res["step"](res["state"], res["batch"])
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return times


def ddp_rank(dp, out_dir: str) -> None:
    """A rank of the ddp phases (``mesh.spawn``): every train case on its
    rows, the float32 CMFlow step timed and its collectives counted, then
    its rows of one B=16 request through the fused engine in each dtype."""
    res = {}
    for case in DDP_CASES:
        r = ddp_step(case, dp.device, dp.group)
        if case == "cmflow":
            r["step_ms"] = timed_steps(r)
            with _CountCollectives() as count:
                r["step"](r["state"], r["batch"])
            r["collectives"] = dict(calls=count.calls, bytes=count.bytes,
                                    by_numel=count.sizes)
        res[case] = {k: v for k, v in r.items()
                     if k not in ("step", "state", "batch")}
    request = mesh.shard_batch(make_request(SEED, B, (200, 256)), dp.group)
    model = build_model("cmflow", dp.device, seed=SEED)
    for dtype, torch_dtype in DDP_EVAL_DTYPES.items():
        step = make_eval_step("cmflow", model, compute_dtype=torch_dtype)
        require(step.fused, "the ranks' eval step must take the fused engine")
        zero_counts()
        out = step(request)
        torch.cuda.synchronize()
        res[f"eval_{dtype}"] = dict(out=[o.cpu() for o in out],
                                    launches=counts_now())
    torch.save(res, os.path.join(out_dir, f"rank{dp.rank}.pt"))


def nccl_rank(dp, out_dir: str) -> None:
    """The one rank of an NCCL group: the float32 CMFlow step with the
    group and without, from the same weights on the same batch; whether
    the variables after them hold the same bits."""
    plain = ddp_step("cmflow", dp.device, None)
    with_group = ddp_step("cmflow", dp.device, dp.group)
    a, b = (dict(leaves(r["after"])) for r in (plain, with_group))
    same = sorted(a) == sorted(b) and all(np.array_equal(a[k], b[k])
                                          for k in a)
    torch.save(dict(backend=dist.get_backend(dp.group), same_bits=same,
                    items_equal=plain["items"] == with_group["items"]),
               os.path.join(out_dir, "nccl.pt"))


def grad_distance(got: dict, want: dict) -> dict:
    """Each leaf's relative L2 error (a leaf exactly zero in ``want`` must
    be exactly zero in ``got``) and the whole gradient's."""
    got, want = dict(leaves(got)), dict(leaves(want))
    require(sorted(got) == sorted(want), "gradient leaves differ")
    zero = [k for k, w in want.items() if not w.any()]
    require(all(not got[k].any() for k in zero),
            f"a gradient leaf exactly zero in one process is not on the "
            f"ranks: {[k for k in zero if got[k].any()]}")
    leaf = {k: float(np.linalg.norm(got[k] - w) / np.linalg.norm(w))
            for k, w in want.items() if k not in zero}
    whole = float(np.sqrt(sum(np.sum((got[k] - w) ** 2)
                              for k, w in want.items())
                          / sum(np.sum(w ** 2) for w in want.values())))
    return dict(grad_leaf_l2_max=max(leaf.values()),
                grad_leaf_l2_median=float(np.median(list(leaf.values()))),
                grad_l2=whole, zero_leaves=len(zero))


def ddp_case_checks(case: str, ranks: list, ref: dict) -> dict:
    """Hold the ranks' step of ``case`` to the one-process step ``ref``."""
    r0, r1 = ranks[0][case], ranks[1][case]
    a, b = dict(leaves(r0["after"])), dict(leaves(r1["after"]))
    require(sorted(a) == sorted(b)
            and all(np.array_equal(a[k], b[k]) for k in a),
            f"ddp {case}: the ranks' variables after the step differ")
    require(r0["items"] == r1["items"], f"ddp {case}: items differ")
    for r in (r0, r1):
        require(r["launches"] == ref["launches"],
                f"ddp {case}: launches {r['launches']}, one process "
                f"{ref['launches']}")
    require(all(np.isfinite(v) for v in r0["items"].values()),
            f"ddp {case}: items {r0['items']}")
    res = dict(launches=r0["launches"],
               first_step_ms=[r["first_step_ms"] for r in (r0, r1)],
               one_process_first_step_ms=ref["first_step_ms"])
    res["loss_max_rel_err"] = max(
        abs(r0["items"][k] - v) / abs(v) for k, v in ref["items"].items())
    res.update(grad_distance(r0["grads"], ref["grads"]))
    want = dict(leaves(ref["after"]))
    res["stats_max_abs_err"] = max(float(np.abs(a[k] - w).max())
                                   for k, w in want.items()
                                   if k.startswith("batch_stats/"))
    if case in DDP_HELD:
        bars = {"loss_max_rel_err": TRAIN_BARS["loss_rtol"],
                "grad_leaf_l2_max": TRAIN_BARS["grad_leaf_l2"],
                "grad_l2": TRAIN_BARS["grad_l2"],
                "stats_max_abs_err": TRAIN_BARS["stats_atol"]}
        missed = {k: (res[k], bar) for k, bar in bars.items()
                  if not res[k] <= bar}
        require(not missed, f"ddp {case} against one process: {missed} "
                            f"(value, bar) in {res}")
    return res


def ddp_phase(dev, card: str) -> dict:
    """Two ranks sharing the one card (gloo): every case's step held to the
    one-process step on the same 16 frames, the ranks' rows of one request
    through the fused engine held to the one-process forward; then one
    NCCL rank, its step against the plain step bit for bit."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        mesh.spawn(ddp_rank, (tmp,), DDP_RANKS)
        ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                            weights_only=False) for r in range(DDP_RANKS)]
    ranks_s = time.perf_counter() - t0
    out = {"cases": {}}
    for case in DDP_CASES:
        ref = ddp_step(case, dev, None)
        if case == "cmflow":
            out["one_process_step_ms"] = timed_steps(ref)
        out["cases"][case] = ddp_case_checks(case, ranks, ref)
        emit(dict(ddp=case, ranks=DDP_RANKS, **out["cases"][case]))
    out["ranks_step_ms"] = [r["cmflow"]["step_ms"] for r in ranks]
    out["collectives"] = ranks[0]["cmflow"]["collectives"]
    request = make_request(SEED, B, (200, 256))
    model = build_model("cmflow", dev, seed=SEED)
    out["eval"] = {}
    for dtype, torch_dtype in DDP_EVAL_DTYPES.items():
        zero_counts()
        ref = make_eval_step("cmflow", model, compute_dtype=torch_dtype)(
            request)
        want_launches = counts_now()
        got = [torch.cat([r[f"eval_{dtype}"]["out"][i] for r in ranks])
               for i in range(4)]
        for r in ranks:
            require(r[f"eval_{dtype}"]["launches"] == want_launches,
                    f"ddp_eval {dtype}: launches "
                    f"{r[f'eval_{dtype}']['launches']}, want {want_launches}")
        out["eval"][dtype] = dict(
            launches=want_launches,
            **compare(request, got, ref, f"ddp_eval {dtype}"))
    emit(dict(ddp_eval=out["eval"]))
    t1 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        mesh.spawn(nccl_rank, (tmp,), 1)
        nccl = torch.load(os.path.join(tmp, "nccl.pt"), weights_only=False)
    require(nccl["backend"] == "nccl" and nccl["same_bits"]
            and nccl["items_equal"],
            f"nccl: the one-rank NCCL step is not the plain step: {nccl}")
    out["nccl"] = dict(nccl, phase_s=time.perf_counter() - t1)
    out.update(ranks_phase_s=ranks_s, card=card,
               note="two ranks sharing one card: contention, not scaling")
    return out


def torchrun(nproc: int, args, cwd: str) -> str:
    """``python -m torch.distributed.run --standalone`` of the CLI with
    ``nproc`` ranks; raises on a non-zero exit, returns the output."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc_per_node={nproc}", "-m", "cmflow_tpu_torch.cli.main",
           *args]
    proc = subprocess.run(cmd, cwd=cwd, capture_output=True, text=True,
                          timeout=600)
    require(proc.returncode == 0,
            f"{' '.join(cmd)}: exit {proc.returncode}\n{proc.stdout[-3000:]}"
            f"\n{proc.stderr[-3000:]}")
    return proc.stdout


def checkpoint_bits(path: str) -> dict:
    """A checkpoint's tensors and counts, flattened."""
    payload = torch.load(path, map_location="cpu", weights_only=True)
    flat = {f"model/{k}": v for k, v in payload["model"].items()}
    for i, s in payload["optimizer"]["state"].items():
        flat.update({f"adam/{i}/{k}": v for k, v in s.items()})
    flat["step"] = torch.tensor(payload["step"])
    return flat


def cli_ddp_phase() -> dict:
    """The CLI under ``torch.distributed.run`` with two ranks on the one
    card: 2 epochs of CMFlow, its run.log written once; an epoch at
    learning rate 0 on two ranks and on one, the same batches, their
    losses within CLI_DDP_LOSS_RTOL; an evaluation of the 2-epoch run's
    checkpoint against the one-process evaluation; two resumes from its
    last checkpoint, bit for bit the same."""
    here = str(Path(__file__).resolve().parent)
    steps_per_epoch = CLI_PARTS["train"] // CLI_BATCH
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        root, ck = os.path.join(tmp, "data"), os.path.join(tmp, "checkpoints")
        write_synthetic_dataset(root, CLI_PARTS, seed=SEED)
        common = ["--config", CLI_CONFIG, "--dataset_path", root,
                  "--checkpoints_dir", ck, "--num_workers", "0"]
        train = common + ["--batch_size", str(CLI_BATCH)]
        timing = {}

        def launch(name, nproc, args):
            t0 = time.perf_counter()
            stdout = torchrun(nproc, args + ["--exp_name", name], here)
            timing[name] = time.perf_counter() - t0
            require(stdout.count("FINISH") == 1,
                    f"{name}: FINISH printed {stdout.count('FINISH')} times")
            return os.path.join(ck, name)

        exp = launch("ddp", 2, train + ["--epochs", str(CLI_EPOCHS)])
        log = open(os.path.join(exp, "run.log")).read()
        counts = {k: log.count(k) for k in (
            "data-parallel over 2 ranks (gloo), 8 rows a rank",
            "mean train loss", "mean RNE score")}
        require(counts == {"data-parallel over 2 ranks (gloo), 8 rows a rank":
                           1, "mean train loss": CLI_EPOCHS,
                           "mean RNE score": CLI_EPOCHS},
                f"cli_ddp: run.log lines {counts}")
        require_finite_rows(os.path.join(exp, "metrics.jsonl"),
                            ["train", "val"] * CLI_EPOCHS)
        # the same batches on two ranks and on one, at learning rate 0: at
        # the config's rate each Adam step moves a parameter by about lr *
        # sign(g), and a sign float32 rounding flips sets a free-running
        # run apart within a few steps, as it sets apart two one-process
        # runs on other thread counts (scripts/dp_drift_torch.py)
        lr0 = os.path.join(tmp, "lr0.yaml")
        with open(CLI_CONFIG) as f:
            lines = [ln for ln in f if not ln.startswith("lr:")]
        with open(lr0, "w") as f:
            f.writelines(lines + ["lr: 0.0\n"])
        lr0_args = ["--config", lr0] + train[2:] + ["--epochs", "1"]
        first = {}
        for name, nproc in (("lr0_ddp", 2), ("lr0_one_rank", 1)):
            rows = require_finite_rows(
                os.path.join(launch(name, nproc, lr0_args), "metrics.jsonl"),
                ["train", "val"])
            first[name] = rows[0]["Loss"]
        loss, one_loss = first["lr0_ddp"], first["lr0_one_rank"]
        loss_rel = abs(loss - one_loss) / abs(one_loss)
        require(loss_rel <= CLI_DDP_LOSS_RTOL,
                f"cli_ddp: first epoch's loss {loss} on 2 ranks, "
                f"{one_loss} on one")
        best, last = (os.path.join(exp, "models", k) for k in ("best", "last"))

        launch("ddp_eval", 2, common + ["--eval", "--model_path", best])
        t0 = time.perf_counter()
        require(cli.main(common + ["--exp_name", "one_eval", "--eval",
                                   "--model_path", best]) == 0,
                "cli_ddp: the one-process eval failed")
        timing["one_eval"] = time.perf_counter() - t0
        means = {k: read_log(os.path.join(ck, k))["means"]
                 for k in ("ddp_eval", "one_eval")}
        require(sorted(means["ddp_eval"]) == sorted(means["one_eval"])
                and len(means["one_eval"]) == 14, f"cli_ddp: means {means}")
        eval_err = {k: abs(v - means["one_eval"][k])
                    for k, v in means["ddp_eval"].items()}
        require(max(eval_err.values()) <= CLI_DDP_METRICS_ATOL,
                f"cli_ddp: the 2-rank eval against one process: {eval_err}")

        saved = torch.load(last, map_location="cpu", weights_only=True)
        resumed = []
        for name in ("resume_a", "resume_b"):
            path = launch(name, 2, train + [
                "--epochs", "1", "--load_checkpoint", "--model_path", last])
            resumed.append(checkpoint_bits(
                os.path.join(path, "models", "last")))
        a, b = resumed
        require(sorted(a) == sorted(b)
                and all(torch.equal(a[k], b[k]) for k in a),
                "cli_ddp: two 2-rank resumes from one checkpoint differ")
        step = saved["step"] + steps_per_epoch
        require(int(a["step"]) == step,
                f"cli_ddp: resumed to step {int(a['step'])}, want {step}")
        out.update(first_epoch_loss=loss, one_rank_first_epoch_loss=one_loss,
                   loss_rel_err=loss_rel, eval_max_abs_err=max(
                       eval_err.values()),
                   eval_rne=means["ddp_eval"]["rne"], resume_step=step,
                   wall_s=timing,
                   train_frames_per_s=read_log(exp)["train_frames_per_s"],
                   one_rank_train_frames_per_s=read_log(os.path.join(
                       ck, "lr0_one_rank"))["train_frames_per_s"],
                   note="two ranks sharing one card: contention, not "
                        "scaling")
    return out


# ---------------------------------------------------------------------------
# the cross-modal preprocessing: RAFT-small on the card, the preprocessing
# CLI, and the codec and packed split that read what it writes
# ---------------------------------------------------------------------------

RAFT_SIZE = (IMG_HEIGHT, IMG_WIDTH)  # VoD's image_2, 1216x1936
RAFT_ITERS = 12
RAFT_TIMED = 5  # timed frame pairs after one warm-up
# the card against the CPU on the same seeded weights: JAX's own bar
# against torch RAFT (tests/test_preprocess.py:352), in pixels
RAFT_CPU_SIZE = (256, 320)
RAFT_CPU_ATOL = 1e-2
RAFT_FEATURES = 128  # the feature net's width: the all-pairs product's D
# the synthetic raw tree: every clip of SCENE_FLOW_SPLITS, 4 frames each
# (13 train clips give 39 pairs: two train steps at B=16), 300 radar points
# a frame before the camera's field of view
PREPROCESS_FRAMES = 4
PREPROCESS_POINTS = 300
PREPROCESS_STEPS = 2  # train steps of the packed split through the CLI
CODEC_ROUNDS = 3  # decode passes over the written train samples


def raft_inputs(size, seed: int):
    rng = np.random.RandomState(seed)
    return [torch.from_numpy(rng.randint(0, 255, (1, 3, *size))
                             .astype(np.uint8)) for _ in range(2)]


def raft_phase(dev) -> dict:
    """RAFT-small with seeded weights at VoD's camera size on the card:
    ms per frame pair (CUDA events, median of ``RAFT_TIMED`` after one
    warm-up), peak memory, the all-pairs product's own time and bound; two
    float32 runs compared bit for bit; float32 against the same module in
    float64 on the card (finite, max and 99.9th percentile |Δ|); the card
    against the CPU at ``RAFT_CPU_SIZE`` within ``RAFT_CPU_ATOL`` px."""
    # built as the preprocessing builds it (TF32 off, seeded weights)
    model = RaftSmallProvider(device=dev, seed=SEED).model
    cpu_model = copy.deepcopy(model).to("cpu")
    img1, img2 = (x.to(dev) for x in raft_inputs(RAFT_SIZE, SEED))
    out = dict(size=list(RAFT_SIZE), iters=RAFT_ITERS)
    def peak_gb():
        """Peak memory of one forward over what was allocated before."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        flow = model(img1, img2, RAFT_ITERS)
        torch.cuda.synchronize()
        return flow, (torch.cuda.max_memory_allocated() - base) / 1e9

    with torch.inference_mode():
        # the first forward autotunes cuDNN's convolutions (trying their
        # algorithms' workspaces); the next is what a frame pair takes
        _, out["first_call_peak_memory_gb"] = peak_gb()
        flow, out["peak_memory_gb"] = peak_gb()
        require(tuple(flow.shape) == (1, 2, *RAFT_SIZE)
                and bool(torch.isfinite(flow).all()),
                f"raft: flow {tuple(flow.shape)} not finite or misshapen")
        times = []
        for _ in range(RAFT_TIMED):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            again = model(img1, img2, RAFT_ITERS)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        out.update(ms_per_pair=float(np.median(times)), ms_runs=times,
                   same_bits_twice=bool(torch.equal(flow, again)))

        # the all-pairs product alone, at the feature maps' shape
        h, w = RAFT_SIZE[0] // 8, RAFT_SIZE[1] // 8
        hw = h * w
        f1, f2 = (torch.randn(1, RAFT_FEATURES, hw, device=dev)
                  for _ in range(2))
        product_ms = event_ms(lambda: torch.matmul(f1.transpose(1, 2), f2),
                              3)
        flops = 2.0 * hw * hw * RAFT_FEATURES
        nbytes = 4.0 * (2 * hw * RAFT_FEATURES + hw * hw)
        bound, bound_by = bound_ms(nbytes, flops)
        out["all_pairs_product"] = dict(
            positions=hw, gflop=flops / 1e9, volume_gb=4.0 * hw * hw / 1e9,
            ms=product_ms, bound_ms=bound, bound_by=bound_by,
            share_of_bound=bound / product_ms)
        del f1, f2

        model64 = copy.deepcopy(model).double()
        flow64 = model64(img1, img2, RAFT_ITERS)
        require(bool(torch.isfinite(flow64).all()),
                "raft: the float64 flow is not finite")
        diff = (flow.double() - flow64).abs().flatten()
        out["vs_float64"] = dict(
            max_abs=float(diff.max()),
            p999_abs=float(torch.quantile(diff, 0.999)),
            flow_max_abs=float(flow64.abs().max()))
        del model64, flow64, diff, again, flow

        small = raft_inputs(RAFT_CPU_SIZE, SEED + 1)
        got = model(*(x.to(dev) for x in small), RAFT_ITERS).cpu()
        want = cpu_model(*small, RAFT_ITERS)
        err = float((got - want).abs().max())
        out["vs_cpu"] = dict(size=list(RAFT_CPU_SIZE), max_abs_px=err,
                             flow_max_abs=float(want.abs().max()),
                             bar=RAFT_CPU_ATOL)
        require(bool(torch.isfinite(got).all()) and err <= RAFT_CPU_ATOL,
                f"raft: the card's flow lies {err} px from the CPU's at "
                f"{RAFT_CPU_SIZE}, bar {RAFT_CPU_ATOL}")
    torch.cuda.empty_cache()
    return out


def clip_counts(text: str) -> dict:
    """``run_preprocess``'s per-clip lines: {(clip, split): samples}."""
    return {(c, s): int(n) for c, s, n in re.findall(
        r"^(\S+) \[(\w+)\]: (\d+) samples$", text, re.M)}


def preprocess_phase(dev) -> dict:
    """The preprocessing path end to end on a synthetic raw VoD tree (every
    clip of ``SCENE_FLOW_SPLITS``, full-size JPEG images): ``python -m
    cmflow_tpu_torch.cli.preprocess`` in a subprocess, RAFT-small with
    seeded weights on the card for the train split; one train clip again
    in-process through ``process_clip`` with the same provider, its flow
    held to the CLI's; the samples read back through the codec (timed
    against ``json``) and packed with ``pack_split``, the packed batches
    equal to the json tree's bit for bit; then the port's CLI trains
    ``PREPROCESS_STEPS`` steps and validates once on the packed split
    (``--dataset vodPackedDataset``), its launches counted."""
    import PIL

    here = Path(__file__).resolve().parent
    out = dict(images=f"JPEG through Pillow {PIL.__version__}",
               route="python -m cmflow_tpu_torch.cli.preprocess, a "
                     "subprocess, RAFT-small on the card for train")
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        paths = write_raw_tree(os.path.join(tmp, "raw"), SCENE_FLOW_SPLITS,
                               frames_per_clip=PREPROCESS_FRAMES,
                               n_points=PREPROCESS_POINTS, seed=SEED)
        out["tree_s"] = time.perf_counter() - t0
        save = os.path.join(tmp, "out")
        cmd = [sys.executable, "-m", "cmflow_tpu_torch.cli.preprocess",
               "--save_dir", save, *(f"--{k}={v}" for k, v in paths.items())]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=here, capture_output=True, text=True,
                              timeout=600)
        wall = time.perf_counter() - t0
        require(proc.returncode == 0,
                f"preprocess CLI: exit {proc.returncode}\n{proc.stderr}")
        counts = clip_counts(proc.stdout)
        want = {(c, s): PREPROCESS_FRAMES - 1
                for s, clips in SCENE_FLOW_SPLITS.items() for c in clips}
        require(counts == want, f"preprocess CLI: samples per clip {counts}")
        pairs = sum(counts.values())
        train_pairs = sum(n for (_, s), n in counts.items() if s == "train")
        out["cli"] = dict(wall_s=wall, pairs=pairs, train_pairs=train_pairs,
                          pairs_per_s=pairs / wall)

        smp = os.path.join(save, "flow_smp")
        train_files = sorted(
            os.path.join(d, f)
            for d, _, fs in os.walk(os.path.join(smp, "train")) for f in fs)
        require(len(train_files) == train_pairs, "train samples on disk")
        for path in train_files:
            s = json.load(open(path))
            opt = np.array(s["opt_info"]["opt_flow"])
            require(opt.shape == (len(s["pc1"]), 2) and len(s["pc1"]) > 0
                    and np.isfinite(opt).all(),
                    f"{path}: opt_flow {opt.shape} for {len(s['pc1'])} "
                    f"points, or not finite")

        # one train clip again in-process: steady pairs/s, flow against the
        # CLI's
        clip = SCENE_FLOW_SPLITS["train"][0]
        provider = RaftSmallProvider(device=dev)
        frames = vod_io.get_frame_list(os.path.join(paths["clips_dir"],
                                                    f"{clip}.txt"))
        again = os.path.join(tmp, "again")
        loc = vod_io.VodLocations(root_dir=paths["root_dir"])
        label = paths["pseudo_label_path"]
        process_clip(loc, frames[:2], again, clip, "train", label, "train",
                     provider, log=lambda text: None)  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        process_clip(loc, frames, again, clip, "train", label, "train",
                     provider, log=lambda text: None)
        torch.cuda.synchronize()
        steady = (len(frames) - 1) / (time.perf_counter() - t0)
        worst, same = 0.0, True
        for a, b in zip(frames[:-1], frames[1:]):
            name = f"{a}_{b}.json"
            mine, cli_s = (json.load(open(os.path.join(d, "train", clip,
                                                       name)))
                           for d in (again, smp))
            got, ref = (np.array(s["opt_info"].pop("opt_flow"))
                        for s in (mine, cli_s))
            require(mine == cli_s, f"{name}: in-process sample differs from "
                                   f"the CLI's beyond opt_flow")
            worst = max(worst, float(np.abs(got - ref).max()))
            same = same and np.array_equal(got, ref)
        require(worst <= RAFT_CPU_ATOL,
                f"opt_flow in-process against the CLI: {worst} px")
        out["in_process"] = dict(train_pairs_per_s=steady,
                                 opt_flow_vs_cli_max_abs_px=worst,
                                 same_bits=same)
        del provider
        torch.cuda.empty_cache()

        # read back: the codec against json, then the packed split
        t0 = time.perf_counter()
        codec.build()
        out["codec_build_s"] = time.perf_counter() - t0
        blobs = [open(p, "rb").read() for p in train_files]

        def json_arrays(blob):  # what the readers make of json's lists
            s = json.loads(blob)
            return {k: np.asarray(v, np.float32) for k, v in s.items()
                    if k != "opt_info"}, {
                k: np.asarray(v, np.float32)
                for k, v in s["opt_info"].items()}

        decode = {}
        for name, fn in (("codec", codec.parse_sample_bytes),
                         ("json", json.loads),
                         ("json_to_float32_arrays", json_arrays)):
            t0 = time.perf_counter()
            for _ in range(CODEC_ROUNDS):
                for blob in blobs:
                    fn(blob)
            decode[name] = ((time.perf_counter() - t0) * 1e6
                            / (CODEC_ROUNDS * len(blobs)))
        out["decode_us_per_sample"] = dict(
            **decode, sample_kb=sum(map(len, blobs)) / len(blobs) / 1e3)

        held = {}
        for part, ds_kw, kw in (
                ("train", dict(eval_mode=False, seed=SEED),
                 dict(batch_size=CLI_BATCH, shuffle=True, drop_last=True)),
                ("val", dict(eval_mode=True),
                 dict(batch_size=8, pad_bucket=256, pad_multiple=128,
                      pad_batch=True))):
            pack = os.path.join(smp, f"{part}.pack")
            t0 = time.perf_counter()
            n = pack_split(smp, part, pack, log=lambda text: None)
            pack_s = time.perf_counter() - t0
            js = VodDataset(smp, part, log=lambda text: None, **ds_kw)
            pk = PackedVodDataset(pack, part, log=lambda text: None, **ds_kw)
            require(n == len(js) == len(pk) and pk.clips_info
                    == js.clips_info, f"{part}: packed {n} of {len(js)}")
            batches = 0
            for _ in range(2):  # two epochs: the shuffle goes on
                for g, w in zip(BatchLoader(pk, num_workers=0, **kw),
                                BatchLoader(js, num_workers=0, **kw)):
                    require(sorted(g) == sorted(w) and all(
                        g[k].dtype == w[k].dtype and np.array_equal(g[k], w[k])
                        for k in w), f"{part}: a packed batch differs from "
                                     f"the json tree's")
                    batches += 1
            held[part] = dict(samples=n, batches_equal=batches,
                              pack_s=pack_s)
        out["packed_vs_json"] = held

        ck = os.path.join(tmp, "checkpoints")
        run = run_cli(["--config", CLI_CONFIG, "--dataset_path", smp,
                       "--dataset", "vodPackedDataset", "--checkpoints_dir",
                       ck, "--num_workers", "0", "--batch_size",
                       str(CLI_BATCH), "--exp_name", "packed", "--epochs",
                       "1"], PREPROCESS_STEPS, 1)
        require_finite_rows(os.path.join(ck, "packed", "metrics.jsonl"),
                            ["train", "val"])
        log = read_log(os.path.join(ck, "packed"))
        out["packed_cli"] = dict(
            **run, train_frames_per_s=log["train_frames_per_s"],
            val_ms_per_frame=log["eval_ms_per_frame"])
    return out


def main() -> int:
    # the kernels must build from this checkout's sources, not from a copy
    # of the package installed elsewhere
    here = Path(__file__).resolve().parent
    if Path(cmflow_tpu_torch.__file__).resolve().parents[1] != here:
        print(f"chip_smoke: cmflow_tpu_torch was imported from "
              f"{cmflow_tpu_torch.__file__}, not from {here}", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    dev = torch.device("cuda")
    t_start = time.perf_counter()

    t0 = time.perf_counter()
    libs = build.build()
    emit(dict(build_s=time.perf_counter() - t0,
              libraries=sorted(p.name for p in libs.values())))
    sass = sass_report(libs)
    emit(dict(sass=sass))

    requests = [make_request(SEED + i, B, (200, 256)) for i in range(3)]
    requests.append(make_request(SEED + 3, B, (300, 384)))
    require([r["pc1"].shape[1] for r in requests] == [256, 256, 256, 384],
            "request buckets")
    gen = torch.Generator().manual_seed(SEED)

    model = build_model("cmflow", device=dev, seed=SEED)
    module_step = make_eval_step("cmflow", model, fused="off")
    randomize_batchnorm(model, module_step,
                        make_request(SEED + 99, B, (200, 256)), gen)
    step = make_eval_step("cmflow", model)
    require(step.fused, "make_eval_step on the card must take the fused "
                        "engine")
    cpu_model = copy.deepcopy(model).to("cpu")

    t0 = time.perf_counter()
    per_forward = {}
    with torch.no_grad():
        for ri, req in enumerate((requests[0], requests[3])):
            check_kernels(fused_cases(model, req, dev), ri == 0, per_forward)
            check_kernels(module_cases(req, dev, gen), ri == 0, per_forward)
        check_large_cloud(dev, gen)
        check_cv_agg_any_k(model, dev, gen)
        check_bf16_tc_any_k(model, dev, gen)
    emit(dict(kernel_phase_s=time.perf_counter() - t0))

    def fused_checks(req, out):
        return dict(
            vs_cpu=compare(req, out, make_eval_step(
                "cmflow", cpu_model, fused="on")(req), "fused vs CPU"),
            vs_module_route=compare(req, out, module_step(req),
                                    "fused vs module route"))

    def module_checks(req, out):
        return dict(vs_cpu=compare(req, out, make_eval_step(
            "cmflow", cpu_model, fused="off")(req), "module vs CPU"))

    t0 = time.perf_counter()
    launches = serve("fused", step, requests, fused_checks)
    launches_module = serve("module", module_step,
                            [requests[0], requests[3]], module_checks)
    emit(dict(serve_phase_s=time.perf_counter() - t0))

    # bf16 serving (compute_dtype bfloat16): the kernels' bf16 arms at every
    # shape of the bf16 forward, then three B=16 requests; the fused
    # forward's device time and CUDA operations in each dtype
    t0 = time.perf_counter()
    with torch.no_grad():
        for ri, req in enumerate((requests[0], requests[3])):
            check_kernels(bf16_cases(model, req, dev), ri == 0, per_forward)
    # with random weights the bf16 forward lies far from the float32 one,
    # in JAX as here (ROADMAP Queue 3): measured, not held
    step_bf16 = make_eval_step("cmflow", model, compute_dtype=BF16)
    emit(dict(bf16_vs_float32_random_weights=compare_bf16(
        "cmflow", requests[0], step_bf16(requests[0]), step(requests[0]),
        "random weights", hold=False)))
    forward = {}
    for dtype, fn in (("float32", step), ("bfloat16", step_bf16)):
        _, ms, _, ops = device_ms(lambda fn=fn: fn(requests[0]), 5)
        forward[dtype] = dict(device_ms=ms, cuda_ops_per_forward=ops)
    emit(dict(fused_forward_device=dict(batch=B, bucket=256, **forward)))
    emit(dict(bf16_phase_s=time.perf_counter() - t0))

    t0 = time.perf_counter()
    batch = make_train_batch(SEED, B, 256)
    with torch.no_grad():
        check_kernels(gather_bwd_cases(batch, dev, gen), True, per_forward)
        check_kernels(train_ball_cases(batch, dev), True, per_forward)
    launches_train = train(dev, batch)
    emit(dict(train_phase_s=time.perf_counter() - t0))

    # bf16 training (compute_dtype bfloat16): the bf16 arms of the gather
    # and its backward at every shape of the bf16 step, twelve bf16 CMFlow
    # steps, a bf16 RaFlow step and CMFlow_T clip step, the bf16 CLI
    t0 = time.perf_counter()
    with torch.no_grad():
        check_kernels(gather_bf16_cases(batch, dev, gen), True, per_forward)
    launches_train_bf16 = train(dev, batch, "bfloat16")
    family_bf16 = family_bf16_steps(dev)
    cli_bf16 = cli_bf16_phase(dev)
    emit(dict(cli_bf16=cli_bf16, card=card))
    emit(dict(bf16_train_phase_s=time.perf_counter() - t0))

    t0 = time.perf_counter()
    trained, cli_run = cli_phase(dev, card)
    emit(dict(cli=cli_run))
    emit(dict(cli_phase_s=time.perf_counter() - t0))

    # bf16 serving of the checkpoint the CLI trained: three B=16 requests,
    # held to its float32 forward and to the CPU's bf16 route
    t0 = time.perf_counter()
    launches_bf16 = serve_bf16("cmflow", trained,
                               copy.deepcopy(trained).to("cpu"),
                               [requests[i] for i in (0, 1, 3)])
    emit(dict(bf16_serve_phase_s=time.perf_counter() - t0))
    by_path = {"fused": launches, "module": launches_module,
               "train": launches_train, "bf16": launches_bf16,
               "train_bf16": launches_train_bf16}

    # RaFlow and CMFlow_T: serving, training and the CLI, each path's
    # counters set to 0 just before it and read just after
    family_paths, held = {}, {}
    t0 = time.perf_counter()
    frames = [make_request(SEED + 50 + i, B, (200, 256))
              for i in range(SEQ_FRAMES)]
    models = {}
    family_paths["raflow_fused"], held["raflow_fused"], models["raflow"] = \
        serve_raflow(dev, gen, frames)
    family_paths["cmflow_t_fused"], held["cmflow_t_fused"], \
        models["cmflow_t"] = serve_cmflow_t(dev, gen, frames)
    for name, fam_model in models.items():
        held[f"{name}_bf16"] = hold_cases(bf16_cases(fam_model, frames[0],
                                                     dev))
    emit(dict(family_serve_phase_s=time.perf_counter() - t0))
    for name, path in (("raflow", "raflow_train"),
                       ("cmflow_t", "cmflow_t_seq_train")):
        t0 = time.perf_counter()
        family_paths[path], held[path] = train_family(name, dev, gen)
        emit({f"{name}_train_phase_s": time.perf_counter() - t0})
    t0 = time.perf_counter()
    family_cli = {}
    for name in FAMILY_CONFIG:
        fam_trained, family_cli[name] = family_cli_phase(name, dev)
        emit(dict(cli=family_cli[name], card=card))
        family_paths[f"{name}_bf16"] = serve_bf16(
            name, fam_trained, copy.deepcopy(fam_trained).to("cpu"),
            [frames[0], frames[1], requests[3]])
    emit(dict(family_cli_phase_s=time.perf_counter() - t0))
    for path, counts in family_paths.items():
        kind = "train" if path.endswith("train") else "fused"
        require(all(counts[k] > 0 for k in CLI_KERNELS[kind]),
                f"{path}: a kernel of its route was not launched: {counts}")
    emit(dict(family_kernel_cases_held=held))

    # data parallelism: two ranks sharing the card, one NCCL rank, the CLI
    # under torch.distributed.run; each rank's counters set to 0 just
    # before each of its steps and forwards and read just after
    t0 = time.perf_counter()
    ddp = ddp_phase(dev, card)
    emit(dict(ddp=ddp, ddp_phase_s=time.perf_counter() - t0))
    t0 = time.perf_counter()
    emit(dict(cli_ddp=cli_ddp_phase(), card=card,
              cli_ddp_phase_s=time.perf_counter() - t0))
    ddp_paths = {**{case: c["launches"] for case, c in ddp["cases"].items()},
                 **{f"eval_{k}": e["launches"]
                    for k, e in ddp["eval"].items()}}

    # the cross-modal preprocessing: RAFT-small on the card, the
    # preprocessing CLI, the codec and the packed split through the CLI
    # (its counters set to 0 just before that run and read just after)
    t0 = time.perf_counter()
    emit(dict(raft=raft_phase(dev), card=card))
    preprocess = preprocess_phase(dev)
    emit(dict(preprocess=preprocess, card=card,
              preprocess_phase_s=time.perf_counter() - t0))

    kernels = []
    for name in (*WRAPPERS, *BF16_ARMS, *GATHER_ARMS):
        source, replaces = SOURCES[name]
        path = SUMMARY_PATH[name]
        sibling, bf16 = BF16_ARMS.get(name, name), name in BF16_ARMS
        require((name, path) in per_forward,
                f"{name}: no case on its route {path}")
        acc = per_forward[(name, path)]
        entry = dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=by_path[path][sibling],
            max_abs_err=acc["max_abs_err"], ms=acc["ms"],
            plain_ms=acc["plain_ms"],
            **bounds(name, acc["nbytes"], acc["flops"]),
            library_ms=acc["library_ms"] if acc["has_library"] else None,
            path=path)
        entry.update(shares(entry, acc["ms"]))
        for key in ("wrapper_ms", "event_ms"):
            if abs(acc[key] - acc["ms"]) > 0.1 * acc["ms"]:
                entry[key] = acc[key]
        if name in KERNELS_PER_CALL:  # every kernel of its calls
            entry["call_ms"] = acc["wrapper_ms"]
        if acc["cublas_products_ms"]:
            entry["cublas_products_ms"] = acc["cublas_products_ms"]
        if name in sass:
            entry["sass"] = sass[name]
        # the float32 and bf16 arms share a counter: each row counts the
        # runs of its own dtype; the gather arms count their own launches
        if name in GATHER_ARMS:
            entry["cli_launches"] = {k: r["launches"][name]
                                     for k, r in cli_bf16["runs"].items()}
            entry["family_launches"] = {p: c[name]
                                        for p, c in family_bf16.items()}
        else:
            entry["cli_launches"] = {k: r["launches"][sibling]
                                     for k, r in cli_run["runs"].items()
                                     if (k == "eval_bf16") == bf16}
            entry["family_launches"] = {p: c[sibling]
                                        for p, c in family_paths.items()
                                        if p.endswith("_bf16") == bf16}
        # rank 0's launches in the ddp phase, per case, on the kernel's
        # arm (a float32 row the float32 cases', a bf16 row the bf16 ones')
        entry["ddp_launches"] = {
            p: c[name if name in GATHER_ARMS else sibling]
            for p, c in ddp_paths.items()
            if ("bf16" in p) == (bf16 or name in GATHER_ARMS)}
        if not bf16 and name not in GATHER_ARMS:
            entry["packed_cli_launches"] = (
                preprocess["packed_cli"]["launches"][name])
            entry["family_cli_launches"] = {
                f"{fam}_{k}": r["launches"][name]
                for fam, run in family_cli.items()
                for k, r in run["runs"].items()}
        # the kernel on each route measured: per forward (per train step)
        routes = {p: a for (n, p), a in per_forward.items() if n == name}
        if len(routes) > 1:
            entry["by_route"] = {
                p: dict(launches_per_forward=LAUNCHES[p][name],
                        launches=by_path[p][name], ms=a["ms"],
                        plain_ms=a["plain_ms"],
                        **bounds(name, a["nbytes"], a["flops"]))
                for p, a in routes.items()}
            for p, r in entry["by_route"].items():
                r.update(shares(r, r["ms"]))
                emit(dict(kernel=name, route=p, **r))
        kernels.append(entry)
    require(all(k["launches"] > 0 for k in kernels),
            "a kernel was not launched on its route")
    emit(dict(total_s=time.perf_counter() - t_start))
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
