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
   where they differ from it by more than 10%.  For the sa encoder, both
   cost-volume kernels (the second's WeightNet) and the propagation
   encoder also cuBLAS float32 on the same products alone, a yardstick the
   port never calls.  For the three tensor-core
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
   volume's first bf16 arms; hold those two arms past one row tile (K=129
   and k=65, a query's rows over two tiles) to their plain versions and to
   themselves; measure, without a
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
   masked, some indices out of range (not timed).  Past the limits these
   kernels once had (no route of the default config reaches them): kNN at
   k = 65 and 128 (a block per query; beside ``torch.topk`` at the same
   k), the ball query with eight radii (two launches), the gather's
   backward at C = 515 and 2,052 in float32 and 8,192 in bf16 (beside
   ``index_add_``): each held to its plain version at its bar and to
   itself bit for bit, its launches a call counted, and timed by CUDA
   graph replays; printed on a ``lifted`` line and in its kernel's row of
   the kernels line;
6b. the fused kernels past their limits, in a process of their own, last
   (``shapes_process``): the sa encoder past K = 32 (its long kernels) at
   K = 33, 48, 64, 100 and 200 in both arms, each alone (``mse.long``,
   ``mse.long.bf16``) and beside the four K <= 32 scales in one call (their
   bits held to a call of them alone), affine scales of both signs, beside
   cuBLAS on their products, and the long kernels' plan at config A beside
   the card's count of blocks an SM and static shared memory (an
   ``mse_long`` line); the cost volume's first kernel at k = 48 and 100
   (its full-tile arm, ``cv_p2p_full_kernel``, each call counted in
   ``launches_full``) and the propagation encoder at K = 65, 128 and 160
   in float32; the bf16 full-tile arms (the bf16 kernels on full tiles
   across query boundaries: K4a at k = 33, 48 and 100, K5 at K = 48, 65, 100
   and 160, each call counted in ``launches_full``) at the bf16 bars, beside
   cuBLAS on bf16 operands; the generic kernel (``csrc/chain.cu``) and the
   cost volume's second kernel at any C
   (``cost_volume.cu::cv_agg_any_kernel``) at widths no tuned kernel takes
   (the sa encoder at (24, 40, 56) with 7 features and ten scales, the
   propagation encoder's chains (200, 100, 36) and (96, 64, 48, 32), both
   cost-volume kernels at C = 100, 768 and 826), each lifted row with a
   digest of its output's bits; the cost volume's and the propagation
   encoder's kernels' registers and spills from the ptxas logs (``ptxas_cv``
   and ``ptxas_plf`` lines); a K5 chain
   of 40 Dense layers 64 wide in float32 (dense kernels) and bf16 (two
   nonzero weights a column), and at each tuned kernel's own shape beside
   it, through its private route: held and
   counted as above, timed with their plain versions by CUDA-graph
   replays, on a ``lifted_fused`` line and in the kernels' rows; the
   40-layer chain in bf16 with dense kernels measured against its plain
   version, not held (a ``deep_bf16_witness`` line: bf16 roundings flipped
   by sums in another order compound through the layers); the tensor-core
   generic kernel's plan at config B beside the card's count of blocks an
   SM and its static shared memory (a ``chain_tc`` line, failing where the
   card holds fewer blocks than planned); its four instantiations must
   hold HGMMA of their type (.TF32, .BF16) in the ``{"sass": ...}`` line;
   then other backbone configurations: CMFlow built with
   config A (``sa_nsamples`` (8, 16, 32, 64), ``fc_nsample`` 64: the tuned
   kernels at K=64) and config C (``sa_nsamples`` (12, 24, 48, 96),
   ``fc_nsample`` 48: K3's tile and long kernels, K4a's and K5's
   full-tile arms, their calls counted exactly; its bf16 forward's device
   time with every fused kernel's share of it), and CMFlow, RaFlow and
   CMFlow_T with config B (three radii,
   ``sa_mlp`` (64, 64, 128), ``sa_mlp2`` (128, 128, 128), ``fc_nsample``
   16: every fused wrapper on the generic kernel), seeded weights and
   BatchNorm statistics, serve one B=16, N=256 request each through
   ``make_eval_step`` in float32 and bf16, launches exact (the generic
   arm's too); float32 held to the module route and, on four elements, to
   the CPU at the serving bars; CMFlow after eight train steps in bf16 to
   the CPU's bf16 route at the JAX bf16 bars; the fused kernels held to
   their plain versions at CMFlow's shapes, config B's generic arms timed
   beside cuBLAS on their products (K3's too: each scale's two products),
   config A's sa encoder calls and its long kernel alone (the K=64 scale's
   weights, a call a cloud) timed, each with its share of the forward,
   every forward's calls of the long kernel counted (config A 2, B 0)
   (their rows of the kernels line, ``mse.generic`` ...
   ``cv_agg.generic.bf16``) (run in the main process before its train
   phases, 6b left its profiler dropping the first kernel of every later
   window);
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
9c. PointNet++ (``nn/extras.py``): farthest-point sampling (FPS,
   ``csrc/sampling.cu``) held to its plain version bit for bit and timed at
   the shapes of the SSG path (B=16: N=1024 to 512 samples, N=512 to 128)
   and at one VoD-size cloud (B=16, N=256 to 64), timed by CUDA events
   around replays of a CUDA graph of 20 calls (whose nodes also count its
   kernels a call: one), not by the profiler; its bound the bytes at
   3.35 TB/s and ten float32 operations per point and step at 67 TFLOP/s,
   though the npoint dependent steps, each an argmax over the cloud, are
   what limit it (``scripts/profile_torch_fps.py`` times each block size
   and another checkout's FPS in one call);
   then one train-mode forward and backward of PointNet++ SSG at its
   published widths (SA 512/0.2/32 [64,64,128], SA 128/0.4/64
   [128,128,256], group-all [256,512,1024], FP [256,128] from level 2 to
   level 1, FP [128,128,128] to the input) at B=16, N=1024 on a unit-sphere
   cloud: launches exact (FPS 2, ball query 2, kNN 2, gather 9, gather
   backward 3), held to the same modules on the CPU (the same centroids,
   outputs 1e-4, running statistics 1e-5, gradients at the train bars).
   Recomputation: the CMFlow float32 train step (B=16, N=256) in each
   ``remat`` mode (False, True, "dots") from the same seeded weights, the
   same bits in all three (loss items, gradients, parameters after Adam,
   BatchNorm statistics), each mode's peak memory, device ms and launches
   ("dots" those of False, gather 17; True more).  Debugging: a 2-step CLI
   run with ``--profile_dir`` whose Chrome trace names the kernels of the
   ball query, kNN, the gather and its backward and, in its val forward,
   the sa encoder, both cost-volume kernels and the propagation encoder
   (run again, up to three times, where the profiler dropped some); a train
   step with a NaN in ``pc1`` under ``nan_check`` raises
   ``FloatingPointError``; a clean ``--nan_check`` CLI run trains to the
   checkpoint bits of the same run without it.  ``three_nn`` at both
   propagation levels' shapes equals the correctly rounded square root of
   ``knn_with_dists`` on the card and ``three_nn`` on the CPU, bit for
   bit.  These three run in a process of their own (``fresh_phases``): in
   the one that runs the other phases the profiler dropped FPS's kernels
   when these came last, and, when they came first, the debug phase's
   traced CLI run left the next phase's windows short;
9d. data parallelism, each rank a process of its own: two ranks sharing
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
9e. the cross-modal preprocessing: RAFT-small with seeded weights at VoD's
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
   kernel also with its launches in each CLI run, on the SSG path and in
   each remat mode; FPS's row with the SSG path's launches; the four bf16
   arms as rows of their own, ``mse.bf16``, ``cv.bf16``, ``cv_agg.bf16``,
   ``plf.bf16``, with the launches of the bf16 serving phase; the sa
   encoder's long kernels as ``mse.long`` and ``mse.long.bf16``, with
   config A's launches of the ``shapes`` phase; the bf16 full-tile arms
   as ``cv_p2p.full.bf16`` and ``plf.full.bf16``, with config C's bf16
   forward's launches and times; the gather's
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
import ctypes
import hashlib
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
from cmflow_tpu_torch.models import (
    CMFlow,
    CMFlowT,
    RaFlow,
    build_model,
    inference,
)
from cmflow_tpu_torch.models.backbone import BackboneConfig
from cmflow_tpu_torch.models.convert import export_flax_variables
from cmflow_tpu_torch.native import build, codec
from cmflow_tpu_torch.nn.blocks import (
    BatchNorm,
    FeatureCorrelator,
    MultiScaleEncoder,
    PointLocalFeature,
    init_parameters,
    masked_global_max,
)
from cmflow_tpu_torch.nn.extras import FeaturePropagation, SetAbstraction
from cmflow_tpu_torch.ops import fused, neighbors, pointops, sampling
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
            "gather_bwd": fused.gather_rows_backward,
            "fps": sampling.farthest_point_sample}
EXACT = ("ball_query", "knn", "gather", "gather.bf16", "fps")
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
# the generic kernel's tensor-core arm (csrc/chain.cu::chain_tc_kernel),
# kinds max (K3, K5) and p2p (K4a), float32 (3xTF32) and bf16: its
# instantiations, each required to hold HGMMA of its type (.TF32, .BF16)
GENERIC_TC_KERNELS = {
    "plf.generic": ("chain", "chain_tc_kernelILNS_4KindE0ELb0E", "HGMMA"),
    "cv.generic": ("chain", "chain_tc_kernelILNS_4KindE1ELb0E", "HGMMA"),
    "plf.generic.bf16": ("chain", "chain_tc_kernelILNS_4KindE0ELb1E",
                         "HGMMA"),
    "cv.generic.bf16": ("chain", "chain_tc_kernelILNS_4KindE1ELb1E",
                        "HGMMA")}
# float32 K4a at a k whose whole queries leave an eighth or more of a tile
# empty (cost_volume.cu's full-tile arm, cv_p2p_full_kernel), behind K4a's
# wrapper, which counts each call
# that launches it in ``launches_full``: no served shape takes it (k = 8,
# 16, 64), the lifted rows do (LIFTED_TUNED)
FULL_TC_KERNELS = {"cv.full": ("cost_volume", "cv_p2p_full_kernel", "HGMMA")}
# the bf16 arms of K4a and K5 (cost_volume.cu::cv_p2p_bf16_kernel,
# plf.cu::plf_bf16_kernel) run full tiles across query boundaries at every
# K (ops/fused.py::cv_p2p_plan, plf_plan), and their wrappers count each
# such call in ``launches_full`` (K4a also in ``launches_full_bf16``); at
# a K whose tiles of whole queries would leave rows empty their cases are
# named ``cv_p2p.full.bf16`` and ``plf.full.bf16``: config C's K4a at k=48
# and K5 scales, no shape of the default config, A or B
FULL_BF16_ARMS = {"cv_p2p.full.bf16": "cv", "plf.full.bf16": "plf"}
# K3 past K = 32 (csrc/mse.cu::mse_long_kernel, mse_bf16_long_kernel), on
# wgmma in 3xTF32 and bf16, behind K3's wrapper, which counts every call
# that launches one also in ``launches_long``: config A's K=64 scale takes
# them (2 a forward, one a cloud), no scale of the default config or of B
LONG_ARMS = {"mse.long": "mse", "mse.long.bf16": "mse"}
LONG_BF16_ARMS = ("mse.long.bf16",)
LONG_TC_KERNELS = {"mse.long": ("mse", "mse_long_kernel", "HGMMA"),
                   "mse.long.bf16": ("mse", "mse_bf16_long_kernel", "HGMMA")}
# the arms whose wgmmas ptxas must not serialise (no register of an operand
# or the accumulator is touched while their products run)
WGMMA_UNSERIALIZED = ("plf.bf16", "cv.bf16", *LONG_TC_KERNELS)
# a bf16 arm against its plain version: max abs error over the output's
# largest magnitude (a float32 sum in another order can flip a bf16
# rounding by one ulp, 2^-8)
BF16_RTOL = 1e-2
# the bf16 arms whose arithmetic stays float32 (K4b's: bf16 p2p widened
# exactly, its WeightNet and sums in float32), held at FUSED_ATOL and
# FUSED_RTOL: it reads ~1.3e-7 of the largest magnitude, where a last layer
# in one TF32 pass read 2.5e-4 (PERF.md)
F32_ACCURATE_ARMS = ("cv_agg.bf16", "cv_agg.generic.bf16")
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
# the generic arm behind each fused wrapper, in float32 and bf16 (K3's, K4a's
# and K5's on csrc/chain.cu, K4b's on cost_volume.cu::cv_agg_any_kernel):
# the wrapper picks it by shape alone (ops/fused.py::*_arm) and counts each
# of its launches (K3's, one a scale) in ``launches`` and
# ``launches_generic``
GENERIC_ARMS = {"mse.generic": "mse", "plf.generic": "plf",
                "cv.generic": "cv", "cv_agg.generic": "cv_agg"}
GENERIC_BF16_ARMS = {f"{k}.bf16": v for k, v in GENERIC_ARMS.items()}
GENERIC = {**GENERIC_ARMS, **GENERIC_BF16_ARMS}
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
             "gather_bwd.bf16", "fps", *GENERIC, *LONG_ARMS,
             *FULL_BF16_ARMS)
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
    # one forward and backward of PointNet++ SSG (extras_phase): FPS and
    # the ball query in each of the two sampling set abstractions, kNN in
    # each feature propagation's three_nn; gathers: the centroids and the
    # grouped offsets of both, the grouped features of the second, and
    # each propagation's neighbours and interpolated features; the
    # backward of the three gathers whose rows take a gradient (the second
    # abstraction's features, the two interpolations)
    "extras": {"ball_query": 2, "knn": 2, "gather": 9, "mse": 0, "cv": 0,
               "cv_agg": 0, "plf": 0, "gather_bwd": 3, "fps": 2},
}
for _path in LAUNCHES.values():
    for _arm in (*GATHER_ARMS, "fps"):
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
                               "gather_rows_backward_sum_kernel"),
                "fps": ("fps_kernel",)}
for _arm, _sibling in GATHER_ARMS.items():
    DEVICE_NAMES[_arm] = DEVICE_NAMES[_sibling]
for _arm in GENERIC:
    DEVICE_NAMES[_arm] = (("cv_agg_any_kernel",) if _arm.startswith("cv_agg")
                          else ("chain_kernel",))
for _arm, (_, _fn, _) in LONG_TC_KERNELS.items():
    DEVICE_NAMES[_arm] = (_fn,)
for _arm, _sibling in FULL_BF16_ARMS.items():
    DEVICE_NAMES[_arm] = DEVICE_NAMES[f"{_sibling}.bf16"]
# the CUDA kernels one call of a wrapper may launch, where that is bounded:
# K7 its CSR build and its sum (exactly), K3's bf16 arm the centroids' mean
# and the kernel (at most)
KERNELS_PER_CALL = {"gather_bwd": (2, 2), "gather_bwd.bf16": (2, 2),
                    "mse.bf16": (1, 2), "mse.long.bf16": (1, 2)}
# one cloud above the 2048 points the neighbour kernels stage at a time
LARGE_N = 4096
# shapes past the limits the kernels once had, which no route reaches: kNN
# past the warp per query's k <= 64 at (N, k), B=16, every point a query;
# the ball query with eight radii (two launches of four); the gather's
# backward past 512 elements of its load type at (C, dtype, B) on the kNN
# indices (k=8) of a B=16, N=256 cloud
LIFTED_KNN = ((1024, 128), (256, 65))
LIFTED_RADII = ((0.5, 1.0, 2.0, 3.0, 4.0, 6.0, 8.0, 16.0),
                (4, 4, 8, 8, 16, 16, 32, 32))
LIFTED_BWD = ((515, torch.float32, 16), (2052, torch.float32, 16),
              (8192, BF16, 4))
# the tuned fused kernels past the K they once took (K3 and K4a 32, K5 64),
# at B=16, N=256 on seeded random neighbours, some outside [0, N): (kernel,
# K); K5 past 128 runs a query over several 128-row tiles
LIFTED_TUNED = (("cv", 48), ("cv", 100), ("plf", 65), ("plf", 128),
                ("plf", 160))
# the bf16 full-tile arms of K4a (k) and K5 (K) at B=16, N=256: a tile
# holds pieces of several queries, a query runs over two or three tiles
LIFTED_FULL_BF16 = {"cv": (33, 48, 100), "plf": (48, 65, 100, 160)}
# K3 past K = 32 at each K, in both dtypes, alone (``mse.long``: only the
# long kernel) and beside the K <= 32 scales in one call (``mse``: both
# kernels; the K <= 32 scales' bits held to a call of them alone)
LIFTED_MSE_K = (33, 48, 64, 100, 200)
LIFTED_MSE_MIXED = (4, 8, 16, 32)
# the generic kernel at widths no tuned kernel takes: K3 at (C1, C2, C3)
# with Cf features and ten scales (K each); K5's chains; K4a and K4b at C
# (at 826 K4a's activations go to device scratch: in shared memory they
# would pass the opt-in limit beside the kernel's static 768 bytes); each
# at LIFTED_GENERIC_K neighbours but K3
LIFTED_MSE = ((24, 40, 56), 7, (4, 8, 16, 32, 48, 4, 8, 16, 32, 64))
LIFTED_PLF = ((200, 100, 36), (96, 64, 48, 32))
LIFTED_CV = (100, 768, 826)
LIFTED_GENERIC_K = 16
# a K5 chain of this many Dense layers, this wide, on the generic kernel
LIFTED_DEPTH, LIFTED_DEPTH_WIDTH = 40, 64
# the route whose forward (train step) each kernel's summary describes
SUMMARY_PATH = {"ball_query": "fused", "knn": "fused", "gather": "module",
                "mse": "fused", "cv": "fused", "cv_agg": "fused",
                "plf": "fused", "gather_bwd": "train", "fps": "extras",
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
    # not a Pallas kernel: the JAX package's lax.fori_loop under jax.jit
    "fps": ("cmflow_tpu_torch/csrc/sampling.cu",
            "cmflow_tpu/ops/pointops.py:270"),
}
SOURCES["mse.long"] = SOURCES["mse"]
SOURCES["mse.long.bf16"] = SOURCES["mse.bf16"]
for _arm, _sibling in FULL_BF16_ARMS.items():
    SOURCES[_arm] = SOURCES[f"{_sibling}.bf16"]
# the generic arms replace their wrappers' Pallas kernels at every width
for _arm, _sibling in GENERIC.items():
    SOURCES[_arm] = ("cmflow_tpu_torch/csrc/" + ("cost_volume.cu"
                                                 if _sibling == "cv_agg"
                                                 else "chain.cu"),
                     SOURCES[f"{_sibling}.bf16" if _arm in GENERIC_BF16_ARMS
                             else _sibling][1])


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def zero_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0
    WRAPPERS["mse"].launches_long = 0
    for arm in set(FULL_BF16_ARMS.values()):
        WRAPPERS[arm].launches_full = 0
    WRAPPERS["cv"].launches_full_bf16 = 0
    for arm in set(GENERIC_ARMS.values()):
        WRAPPERS[arm].launches_generic = 0
    for arm in GATHER_ARMS.values():
        WRAPPERS[arm].launches_bf16 = 0


def counts_now() -> dict:
    counts = {k: fn.launches for k, fn in WRAPPERS.items()}
    counts.update({name: WRAPPERS[arm].launches_bf16
                   for name, arm in GATHER_ARMS.items()})
    return counts


def wrapper_of(name: str):
    """A kernel's wrapper (a bf16 or generic arm's is its float32 tuned
    sibling's)."""
    return WRAPPERS[{**BF16_ARMS, **GATHER_ARMS, **GENERIC,
                     **LONG_ARMS, **FULL_BF16_ARMS}.get(name, name)]


def full_launches() -> dict:
    """The calls in full tiles since the counters were set to 0: float32
    K4a's, K4a's and K5's in bf16."""
    cv = WRAPPERS["cv"]
    return {"cv.full": cv.launches_full - cv.launches_full_bf16,
            "cv_p2p.full.bf16": cv.launches_full_bf16,
            "plf.full.bf16": WRAPPERS["plf"].launches_full}


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


def graph_ms(fn, iters: int) -> tuple:
    """(Milliseconds a call, kernels a call) of ``fn`` from a CUDA graph
    captured from ``iters`` calls: CUDA events around five warmed replays,
    and the graph's kernel, copy and memset nodes over ``iters``.  No
    profiler and no host issue in the time."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    libcuda = ctypes.CDLL("libcuda.so.1")
    raw = ctypes.c_void_p(graph.raw_cuda_graph())
    count = ctypes.c_size_t(0)
    require(libcuda.cuGraphGetNodes(raw, None, ctypes.byref(count)) == 0,
            "cuGraphGetNodes")
    nodes = (ctypes.c_void_p * count.value)()
    require(libcuda.cuGraphGetNodes(raw, nodes, ctypes.byref(count)) == 0,
            "cuGraphGetNodes")
    kinds = []
    for node in nodes:
        kind = ctypes.c_int(-1)
        require(libcuda.cuGraphNodeGetType(ctypes.c_void_p(node),
                                           ctypes.byref(kind)) == 0,
                "cuGraphNodeGetType")
        kinds.append(kind.value)
    # CU_GRAPH_NODE_TYPE_KERNEL, _MEMCPY, _MEMSET
    kernels = sum(kind in (0, 1, 2) for kind in kinds) / iters
    for _ in range(2):
        graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(5):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (5 * iters), kernels


PROFILE_TRIES = 6  # windows traced before device_ms gives up


class ProfilerWindowError(RuntimeError):
    """``device_ms`` traced no window in which the profiler recorded every
    launch."""
SENTINEL = "spin_kernel"  # torch.cuda._sleep's kernel


def device_ms(fn, iters: int, kernels=("",), per_call: int = 0) -> tuple:
    """Device time of one call of ``fn``, from ``torch.profiler``'s CUDA
    activity over ``iters`` warmed calls: (the summed durations of the
    kernels whose names hold one of ``kernels``, of every kernel it
    launches, {each of ``kernels``: its own}, the kernels it launches).

    The profiler now and then records only part of a window's kernels, or
    none; it drops the first or the last most often, so each window starts
    and ends with a throwaway kernel.  A window counts only if it recorded
    each of
    ``kernels`` ``iters * per_call`` times (``per_call``: the launches of
    each a call makes), or, without ``per_call``, every kernel a multiple
    of ``iters`` times (copies and memsets aside: a train step's
    host-to-device copies vary from step to step).  A rejected window is
    printed to stderr and traced again after a pause that doubles, up to
    ``PROFILE_TRIES`` windows; then this raises ``ProfilerWindowError``."""
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
                # ... and now and then the last: let that be this one
                torch.cuda._sleep(1)
                torch.cuda.synchronize()
            events = [e for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA
                      and SENTINEL not in e.key]
        if per_call:
            whole = all(sum(e.count for e in events if k in e.key)
                        == iters * per_call for k in kernels)
        else:
            whole = bool(events) and all(
                e.count % iters == 0 for e in events
                if not e.key.startswith(("Memcpy", "Memset")))
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
    raise ProfilerWindowError(f"the profiler recorded no whole window of "
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
    float32 bound beside it for the 3xTF32 tensor-core kernels.  A generic
    arm is held to its tuned sibling's bound (``mse.generic.bf16`` to
    ``mse.bf16``'s): the card runs the same work at that rate."""
    name = name.replace(".generic", "").replace(".long", "")
    if name in FULL_BF16_ARMS:
        name = f"{FULL_BF16_ARMS[name]}.bf16"
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
    for name, (lib, fn, tc_op) in {**TC_KERNELS, **BF16_TC_KERNELS,
                                   **GENERIC_TC_KERNELS, **LONG_TC_KERNELS,
                                   **FULL_TC_KERNELS}.items():
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
        if (name in BF16_TC_KERNELS or name in GENERIC_BF16_ARMS
                or name in LONG_BF16_ARMS):
            key, pattern = f"{tc_op.lower()}_bf16", rf"\b{tc_op}\.\S*BF16\b"
        elif name in GENERIC_ARMS or name in LONG_ARMS:
            key, pattern = f"{tc_op.lower()}_tf32", rf"\b{tc_op}\.\S*TF32\b"
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


def ptxas_report(libs: dict, lib: str, pattern: str) -> dict:
    """Registers, spill stores and static shared memory of each kernel of
    library ``lib`` whose mangled name matches ``pattern``, from the ptxas
    log beside it."""
    log = libs[lib].with_suffix(".log").read_text()
    out = {}
    for part in log.split("Compiling entry function")[1:]:
        name = part.splitlines()[0].split("'")[1]
        if not re.search(pattern, name):
            continue
        regs, smem = re.search(r"Used (\d+) registers.*?(\d+) bytes smem",
                               part).groups()
        spill = re.search(r"(\d+) bytes spill stores", part)
        out[name] = dict(registers=int(regs),
                         spill_store_bytes=int(spill.group(1)) if spill else 0,
                         static_smem_bytes=int(smem))
    return out


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


def arm_names(model) -> dict:
    """Each fused wrapper's case name for ``model``'s widths: the wrapper's
    own (its tuned kernel), or ``<wrapper>.generic`` where its arm choice
    (``ops/fused.py``) takes the generic kernel."""
    w = model_widths(model)
    arms = {"mse": fused.mse_arm(w["mse"], len(w["ks"]), 3),
            "plf": fused.plf_arm(w["plf"]),
            "cv": fused.cv_p2p_arm(w["cv"]),
            "cv_agg": fused.cv_agg_arm(w["cv"][-1])}
    return {k: k if arm == fused.TUNED else f"{k}.generic"
            for k, arm in arms.items()}


def model_widths(model) -> dict:
    """The fused kernels' widths in ``model``: K3's (C1, C2, C3), K5's chain,
    K4a's (C, C1, C2), the ball query's K and kNN's k."""
    cfg = model.trunk.cfg
    packed, _ = fused.mse_narrow_params_from_variables(model.trunk.mse_layer)
    chain = fused.plf_params_from_variables(model.trunk.mse_layer2.scale_0)[0]
    dense = fused.cv_params_from_variables(model.trunk.fc_layer)[0]
    return dict(mse=(packed[4].shape[1], packed[4].shape[2],
                     packed[7].shape[2]),
                plf=(chain[0].shape[1],) + tuple(w.shape[1]
                                                 for w in chain[3::3]),
                cv=(dense[0].shape[1], dense[2].shape[1], dense[4].shape[1]),
                ks=tuple(cfg.sa_nsamples), k=cfg.fc_nsample,
                radii=tuple(cfg.sa_radii))


def chain_flops(rows: int, k: int, widths) -> int:
    """Operations of a grouped chain's products over ``rows * k`` rows."""
    return 2 * rows * k * sum(a * b for a, b in zip(widths, widths[1:]))


def unit(x):
    """``x`` scaled to a largest magnitude of one, in its dtype."""
    return (x.float() / x.float().abs().max()).to(x.dtype)


def fused_cases(model, req: dict, dev, path: str = "fused",
                unit_cost: bool = False):
    """Every shape of the fused route's forward on this request, with the
    model's packed weights and the forward's own intermediates as inputs;
    the kNN shapes are shared with the module route.  Widths, K and k are
    the model's; a wrapper whose arm is the generic kernel names its cases
    ``<wrapper>.generic``.  With ``unit_cost`` the cost volume's kernels
    take their inputs (``f1c``, ``f2c``; the point-to-patch cost) scaled to
    a largest magnitude of one: with random weights their sums over k
    neighbours reach thousands (1,712 at k=64), where a float32 ulp passes
    the 1e-4 bar whatever the order of the sum."""
    pc1, pc2, ft1, ft2, v1, v2 = request_tensors(req, dev)
    b, n, _ = pc1.shape
    w = model_widths(model)
    names = arm_names(model)
    radii, ks, k = w["radii"], w["ks"], w["k"]
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
            kernel="ball_query", path=path,
            shape=f"B={b} N={n} all radii K={ks} {name} masked", mult=1,
            run=lambda pc=pc, v=v: neighbors.ball_query_multi(
                radii, ks, pc, pc, v),
            plain=lambda pc=pc, v=v: neighbors.ball_query_multi_plain(
                radii, ks, pc, pc, v),
            nbytes=cloud_bytes + rows * sum(ks) * 4,
            flops=PAIR_FLOPS * ball_scan_pairs(radii, ks, pc, v)))
    knn2 = neighbors.knn(k, pc1, pc2, v2)
    knn1 = neighbors.knn(k, pc1, pc1, v1)
    for name, pts, valid in (("pc1->pc2", pc2, v2), ("pc1->pc1", pc1, v1)):
        dist = neighbors.masked_square_distance(pc1, pts, valid)
        cases.append(dict(
            kernel="knn", path=path, shape=f"B={b} N={n} k={k} {name} masked",
            mult=1,
            run=lambda pts=pts, valid=valid: neighbors.knn(k, pc1, pts, valid),
            plain=lambda pts=pts, valid=valid: neighbors.knn_plain(
                k, pc1, pts, valid),
            library=lambda dist=dist: torch.topk(dist, k, largest=False),
            nbytes=cloud_bytes * (1 if pts is pc1 else 2) + rows * k * 4,
            flops=PAIR_FLOPS * b * n * n))

    mse = model.trunk.mse_layer
    packed, _ = fused.mse_narrow_params_from_variables(mse)
    c1, c2, c3 = w["mse"]
    s_cnt = len(ks)
    for name, pc, ft in (("pc1", pc1, ft1), ("pc2", pc2, ft2)):
        cases.append(dict(
            kernel=names["mse"], path=path,
            shape=f"B={b} N={n} K={ks} {name} masked", mult=1,
            run=lambda pc=pc, ft=ft, i=idx[name]:
                fused.fused_multi_scale_encoder(ft, i, pc, packed),
            plain=lambda pc=pc, ft=ft, i=idx[name]:
                fused.fused_multi_scale_encoder_plain(ft, i, pc, packed),
            **mse_yardstick(names["mse"], ks, w["mse"], yardstick),
            nbytes=4 * (rows * (6 + sum(ks) + s_cnt * c3)
                        + numel(packed[0] + packed[1] + packed[2:])),
            # the folded first layer, then the chain per (query, neighbour)
            flops=2 * (rows * s_cnt * c1 * 9
                       + rows * sum(ks) * (c1 * c2 + c2 * c3))))

    f1 = inference._mse_fused(mse, pc1, ft1, v1, idx["pc1"])
    f2 = inference._mse_fused(mse, pc2, ft2, v2, idx["pc2"])
    g1, g2 = masked_global_max(f1, v1), masked_global_max(f2, v2)
    fc = model.trunk.fc_layer
    d = model.trunk.cfg.fc_inch
    f1t = inference._fanin_dot((f1, g1), fc.w0[:d])
    f2t = inference._fanin_dot((f2, g2), fc.w0[d:2 * d])
    dense, wn1, wn2 = fused.cv_params_from_variables(fc)
    f1c, f2c, z1, z2, zq = fused.cost_volume_folds(
        f1t, f2t, pc1, pc2, dense[0], wn1[0], wn2[0])
    if unit_cost:
        f1c, f2c = unit(f1c), unit(f2c)
    c, h = w["cv"][-1], fused.WEIGHTNET_HIDDEN
    cv_args = (f1c, f2c, knn2, z1, z2, dense[1:], wn1[1:])
    cases.append(dict(
        kernel=full_arm(names["cv"], k), path=path,
        shape=f"B={b} N={n} C={c} k={k} masked",
        mult=1, run=lambda: fused.cost_volume_p2p(*cv_args),
        plain=lambda: fused.cost_volume_p2p_plain(*cv_args),
        cublas=yardstick(k, w["cv"]),
        nbytes=4 * (rows * (3 * c + k + 2 * h) + numel(dense[1:] + wn1[1:])),
        flops=chain_flops(rows, k, w["cv"]) + 2 * rows * k * (h * h + h * c)))
    p2p = fused.cost_volume_p2p(*cv_args)
    agg_args = (unit(p2p) if unit_cost else p2p, knn1, zq, wn2[1:])
    cases.append(dict(
        kernel=names["cv_agg"], path=path,
        shape=f"B={b} N={n} C={c} k={k} masked",
        mult=1, run=lambda: fused.cost_volume_agg(*agg_args),
        plain=lambda: fused.cost_volume_agg_plain(*agg_args),
        # its WeightNet's two products (8 -> 8 -> C) at k rows a query
        cublas=yardstick(k, (h, h, c)),
        nbytes=4 * (rows * (2 * c + k + h) + numel(wn2[1:])),
        flops=2 * rows * k * (h * h + h * c + c)))
    cor = fused.cost_volume_agg(*agg_args)

    parts = (ft1, f1, g1, cor)
    widths = w["plf"]
    for s, scale in enumerate(inference._scales(model.trunk.mse_layer2)):
        chain, feat_w, _ = fused.plf_params_from_variables(scale)
        feat_tx = inference._fanin_dot(parts, feat_w)
        kk = ks[s]
        plf_args = (feat_tx, idx["pc1"][s], pc1, chain)
        cases.append(dict(
            kernel=names["plf"], path=path, shape=f"B={b} N={n} K={kk} masked",
            mult=1, run=lambda a=plf_args: fused.fused_point_local_feature(*a),
            plain=lambda a=plf_args:
                fused.fused_point_local_feature_plain(*a),
            cublas=yardstick(kk, widths),
            nbytes=4 * (rows * (widths[0] + kk + 3 + widths[-1])
                        + numel(chain)),
            # the folded first layer, then the chain per (query, neighbour)
            flops=2 * rows * widths[0] * 6 + chain_flops(rows, kk, widths)))
    return cases


def mse_yardstick(name: str, ks, widths, yardstick) -> dict:
    """K3's ``cublas`` yardstick: cuBLAS on each scale's two products, K_s
    rows a query (``yardstick`` of the case's dtype), in either arm (the
    tuned arm's first layer, part of its kernel, left out)."""
    runs = [yardstick(k, widths) for k in ks]
    return dict(cublas=lambda: [run() for run in runs])


def long_cases(model, req: dict, dev, path: str, dtype) -> list:
    """K3's scales past K = 32 of this request's fused forward alone (the
    long kernel's launches, one a cloud), in ``dtype``: each cloud's call
    with those scales' weights on the forward's ball-query indices, timed
    by the long kernel's own device time, its plain version and cuBLAS on
    their two products beside by CUDA-graph replays (at config C the
    profiler dropped the plain version's last kernel in every window)."""
    pc1, pc2, ft1, ft2, v1, v2 = request_tensors(req, dev)
    b, n, _ = pc1.shape
    w = model_widths(model)
    radii, ks = w["radii"], w["ks"]
    keep = [s for s, k in enumerate(ks) if k > fused.MSE_TILE_MAX_K]
    packed, _ = fused.mse_narrow_params_from_variables(
        model.trunk.mse_layer, dtype)
    packed = mse_scales(packed, keep)
    c1, c2, c3 = w["mse"]
    rows = b * n
    long_ks = [ks[s] for s in keep]
    xs = [torch.randn((rows * sum(long_ks), c), device=dev).to(dtype)
          for c in (c1, c2)]
    ws = [torch.randn((c, o), device=dev).to(dtype)
          for c, o in ((c1, c2), (c2, c3))]
    if dtype == BF16:
        def cublas():
            return [torch.mm(x, w, out_dtype=torch.float32)
                    for x, w in zip(xs, ws)]
    else:
        def cublas():
            return [x @ w for x, w in zip(xs, ws)]
    cases = []
    for cloud, pc, ft, v in (("pc1", pc1, ft1, v1), ("pc2", pc2, ft2, v2)):
        idx = inference._ball_query_all(radii, ks, pc, v)
        i = [idx[s] for s in keep]
        f = ft.to(dtype)
        cases.append(dict(
            kernel="mse.long" + (".bf16" if dtype == BF16 else ""),
            path=path, shape=f"B={b} N={n} K={tuple(long_ks)} {cloud} "
                             f"masked", mult=1,
            run=lambda pc=pc, f=f, i=i: fused.fused_multi_scale_encoder(
                f, i, pc, packed),
            plain=lambda pc=pc, f=f, i=i:
                fused.fused_multi_scale_encoder_plain(f, i, pc, packed),
            cublas=cublas, graph_references=True,
            nbytes=nbytes(pc, f, i, packed) + rows * len(keep) * c3 * 4,
            flops=2 * (rows * len(keep) * c1 * 9
                       + rows * sum(long_ks) * (c1 * c2 + c2 * c3))))
    return cases


def nbytes(*tensors) -> int:
    """Bytes of ``tensors`` (nested sequences flattened), each read or
    written once."""
    out = 0
    for t in tensors:
        out += nbytes(*t) if isinstance(t, (list, tuple)) else (
            t.numel() * t.element_size())
    return out


def part_empty(k: int, rows: int) -> bool:
    """Whether tiles of ``rows`` rows of whole queries of ``k`` neighbours
    (or one query over several tiles, past ``rows``) leave rows empty."""
    return (rows % k if k <= rows else k % rows) != 0


def full_arm(name: str, k: int) -> str:
    """A tuned bf16 arm's case name at ``k`` neighbours: where tiles of
    whole queries would leave rows empty, the rows its full tiles fill
    (``cv_p2p.full.bf16``, ``plf.full.bf16``), else its own."""
    if name == "cv.bf16" and part_empty(k, fused.CV_P2P_ROWS):
        return "cv_p2p.full.bf16"
    if name == "plf.bf16" and part_empty(k, fused.PLF_ROWS):
        return "plf.full.bf16"
    return name


def bf16_cases(model, req: dict, dev, path: str = "bf16",
               unit_cost: bool = False):
    """Every shape of the bf16 fused forward (``compute_dtype`` bfloat16)
    on this request: the bf16 arms of K3, K4a, K4b and K5 on the forward's
    own bf16 operands, with the same operation counts as their float32
    siblings and the bytes of their own inputs and outputs; beside K4a and
    K5, cuBLAS on bf16 operands with float32 sums (``torch.mm(...,
    out_dtype=)``, as ``_dot32`` calls it) on their products alone.  A
    wrapper whose arm is the generic kernel names its cases
    ``<wrapper>.generic.bf16``; ``unit_cost`` as :func:`fused_cases`."""
    pc1, pc2, ft1, ft2, v1, v2 = request_tensors(req, dev)
    b, n, _ = pc1.shape
    w = model_widths(model)
    names = {k: f"{v}.bf16" for k, v in arm_names(model).items()}
    radii, ks, k = w["radii"], w["ks"], w["k"]
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
    c1, c2, c3 = w["mse"]
    s_cnt = len(ks)
    for name, pc, ft in (("pc1", pc1, ft1), ("pc2", pc2, ft2)):
        ftb = ft.to(BF16)
        cases.append(dict(
            kernel=names["mse"], path=path,
            shape=f"B={b} N={n} K={ks} {name} masked", mult=1,
            run=lambda pc=pc, ft=ftb, i=idx[name]:
                fused.fused_multi_scale_encoder(ft, i, pc, packed),
            plain=lambda pc=pc, ft=ftb, i=idx[name]:
                fused.fused_multi_scale_encoder_plain(ft, i, pc, packed),
            **mse_yardstick(names["mse"], ks, w["mse"], yardstick),
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
    d = model.trunk.cfg.fc_inch
    f1t = inference._fanin_dot((f1, g1), fc.w0[:d], BF16).to(BF16)
    f2t = inference._fanin_dot((f2, g2), fc.w0[d:2 * d], BF16).to(BF16)
    dense, wn1, wn2 = fused.cv_params_from_variables(fc)
    dense = [t.to(BF16) if i % 2 == 0 else t for i, t in enumerate(dense)]
    knn2 = neighbors.knn(k, pc1, pc2, v2)
    knn1 = neighbors.knn(k, pc1, pc1, v1)
    f1c, f2c, z1, z2, zq = fused.cost_volume_folds(
        f1t, f2t, pc1, pc2, dense[0], wn1[0], wn2[0], BF16)
    if unit_cost:
        f1c, f2c = unit(f1c), unit(f2c)
    c, h = w["cv"][-1], fused.WEIGHTNET_HIDDEN
    cv_args = (f1c, f2c, knn2, z1, z2, dense[1:], wn1[1:])
    cases.append(dict(
        kernel=full_arm(names["cv"], k), path=path,
        shape=f"B={b} N={n} C={c} k={k} masked", mult=1,
        run=lambda: fused.cost_volume_p2p(*cv_args),
        plain=lambda: fused.cost_volume_p2p_plain(*cv_args),
        cublas=yardstick(k, w["cv"]),
        nbytes=nbytes(cv_args) + rows * c * 2,
        flops=chain_flops(rows, k, w["cv"]) + 2 * rows * k * (h * h + h * c)))
    p2p = fused.cost_volume_p2p(*cv_args)
    agg_args = (unit(p2p) if unit_cost else p2p, knn1, zq, wn2[1:])
    wn_x = [torch.randn((rows * k, h), device=dev) for _ in range(2)]
    wn_w = [torch.randn((h, o), device=dev) for o in (h, c)]
    cases.append(dict(
        kernel=names["cv_agg"], path=path,
        shape=f"B={b} N={n} C={c} k={k} masked", mult=1,
        run=lambda: fused.cost_volume_agg(*agg_args),
        plain=lambda: fused.cost_volume_agg_plain(*agg_args),
        # its WeightNet's two products in float32, as the arm computes them
        cublas=lambda: [x @ w for x, w in zip(wn_x, wn_w)],
        nbytes=nbytes(agg_args) + rows * c * 4,
        flops=2 * rows * k * (h * h + h * c + c)))
    cor = fused.cost_volume_agg(*agg_args)

    parts = (ft1, f1, g1, cor)
    widths = w["plf"]
    for s, scale in enumerate(inference._scales(model.trunk.mse_layer2)):
        chain, feat_w, _ = fused.plf_params_from_variables(scale)
        chain = inference._cast_chain(chain, BF16)
        feat_tx = inference._fanin_dot(parts, feat_w, BF16).to(BF16)
        kk = ks[s]
        plf_args = (feat_tx, idx["pc1"][s], pc1, chain)
        cases.append(dict(
            kernel=full_arm(names["plf"], kk), path=path,
            shape=f"B={b} N={n} K={kk} masked",
            mult=1, run=lambda a=plf_args: fused.fused_point_local_feature(*a),
            plain=lambda a=plf_args:
                fused.fused_point_local_feature_plain(*a),
            cublas=yardstick(kk, widths),
            nbytes=nbytes(plf_args) + rows * widths[-1] * 4,
            flops=2 * rows * widths[0] * 6 + chain_flops(rows, kk, widths)))
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
    """K4b at one B=16, N=384 cloud with k=33 neighbours, in both arms:
    masked kNN indices, three of them out of range,
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
    propagation-encoder scale, K4a at k=65 (over two 64-row tiles) with
    its cost volume's weights, bf16 operands, seeded random indices with
    some outside [0, N); each held to its plain version at BF16_RTOL and
    to itself bit for bit; not part of any route's time."""
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


def lifted_cases(dev, gen: torch.Generator) -> list:
    """The LIFTED_* shapes as check_kernels cases, each with the launches
    one call of its wrapper must make."""
    cases = []
    for n, k in LIFTED_KNN:
        pc = (20.0 * torch.rand((B, n, 3), generator=gen)).to(dev)
        valid = (torch.rand((B, n), generator=gen) > 0.2).to(dev)
        dist = neighbors.masked_square_distance(pc, pc, valid)
        cases.append(dict(
            kernel="knn", path="lifted",
            shape=f"B={B} N={n} k={k} masked (block per query)", mult=0,
            run=lambda pc=pc, v=valid, k=k: neighbors.knn(k, pc, pc, v),
            plain=lambda pc=pc, v=valid, k=k: neighbors.knn_plain(
                k, pc, pc, v),
            library=lambda dist=dist, k=k: torch.topk(dist, k,
                                                      largest=False),
            nbytes=B * n * (3 * 4 + 1) + B * n * k * 4,
            flops=PAIR_FLOPS * B * n * n, graph_timed=True, same_bits=True,
            launches=1))
    radii, ks = LIFTED_RADII
    n = 256
    pc = (20.0 * torch.rand((B, n, 3), generator=gen)).to(dev)
    valid = (torch.rand((B, n), generator=gen) > 0.2).to(dev)
    pairs = sum(ball_scan_pairs(radii[g:g + 4], ks[g:g + 4], pc, valid)
                for g in range(0, len(radii), 4))
    cases.append(dict(
        kernel="ball_query", path="lifted",
        shape=f"B={B} N={n} {len(radii)} radii K={ks} masked", mult=0,
        run=lambda: neighbors.ball_query_multi(radii, ks, pc, pc, valid),
        plain=lambda: neighbors.ball_query_multi_plain(radii, ks, pc, pc,
                                                       valid),
        nbytes=B * n * (3 * 4 + 1) + B * n * sum(ks) * 4,
        flops=PAIR_FLOPS * pairs, graph_timed=True, same_bits=True,
        launches=2))
    idx = neighbors.knn(8, pc, pc, valid)
    for c, dtype, b in LIFTED_BWD:
        flat = idx[:b].reshape(b, -1).contiguous()
        m = flat.shape[1]
        g = torch.randn((b, m, c), generator=gen).to(dev).to(dtype)
        rows = (flat.long() + n * torch.arange(b, device=dev)[:, None]
                ).reshape(-1)
        g_rows = g.reshape(b * m, c)
        bf16 = dtype == BF16
        cases.append(dict(
            kernel="gather_bwd.bf16" if bf16 else "gather_bwd",
            path="lifted", shape=f"B={b} N={n} M={m} C={c} {dtype}", mult=0,
            run=lambda g=g, flat=flat: fused.gather_rows_backward(g, flat, n),
            plain=lambda g=g, flat=flat: fused.gather_rows_backward_plain(
                g, flat, n),
            # index_add_ in float32 (then one cast for bf16)
            library=lambda rows=rows, g_rows=g_rows, c=c, b=b: torch.zeros(
                (b * n, c), device=dev).index_add_(
                    0, rows, g_rows.float()).to(g_rows.dtype),
            nbytes=g.element_size() * (b * m * c + b * n * c) + 4 * b * m,
            flops=b * m * c, graph_timed=True, launches=1))
    return cases


def seeded_module(module, gen: torch.Generator, dev):
    """``module`` with seeded weights and BatchNorm statistics near the
    identity (activations of order one), on ``dev``."""
    init_parameters(module, gen)
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, BatchNorm):
                m.weight.uniform_(0.7, 1.3, generator=gen)
                m.bias.uniform_(-0.2, 0.2, generator=gen)
                m.running_mean.uniform_(-0.1, 0.1, generator=gen)
                m.running_var.uniform_(0.5, 2.0, generator=gen)
    return module.to(dev)


def mse_scales(packed: tuple, keep) -> tuple:
    """K3's packed weights of the scales ``keep`` alone, in that order."""
    w0rel, w0feat, s0, b0, w1, s1, b1, w2, s2, b2 = packed
    c1, c2, c3 = w1.shape[1], w1.shape[2], w2.shape[2]

    def cols(a, c):
        return torch.cat([a[s * c:(s + 1) * c] for s in keep])

    return (tuple(w0rel[s] for s in keep), tuple(w0feat[s] for s in keep),
            cols(s0, c1), cols(b0, c1), w1[list(keep)], cols(s1, c2),
            cols(b1, c2), w2[list(keep)], cols(s2, c3), cols(b2, c3))


def check_tile_bits(feats, idx, pc, packed, tile) -> str:
    """Hold the scales ``tile`` (K <= 32, the tile kernel's) of a call that
    also runs the long kernel to a call of those scales alone, bit for
    bit; returns a digest of their bits."""
    c3 = packed[7].shape[2]
    with torch.no_grad():
        both = fused.fused_multi_scale_encoder(feats, idx, pc, packed)
        alone = fused.fused_multi_scale_encoder(
            feats, [idx[s] for s in tile], pc, mse_scales(packed, tile))
    part = torch.cat([both[..., s * c3:(s + 1) * c3] for s in tile], -1)
    require(torch.equal(part, alone),
            f"K3 K={[i.shape[2] for i in idx]}: the K <= 32 scales' bits "
            f"differ from a call of them alone")
    return hashlib.sha1(alone.cpu().numpy().tobytes()).hexdigest()


def fused_lifted_cases(dev, gen: torch.Generator) -> list:
    """LIFTED_TUNED, LIFTED_MSE, LIFTED_PLF, LIFTED_CV and LIFTED_FULL_BF16
    as check_kernels cases, and each generic arm at the tuned kernel's own
    shape (the fused route's widths, K3 at its four scales, the others at
    LIFTED_GENERIC_K) through its private route, the tuned arm beside it
    on the same inputs.  Every generic launch counts as its wrapper's, a
    launch a scale for K3.  B=16, N=256, seeded random inputs."""
    b, n = B, 256
    rows = b * n
    h = fused.WEIGHTNET_HIDDEN
    pc = (20.0 * torch.rand((b, n, 3), generator=gen)).to(dev)
    cases = []

    def rand(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen).to(dev).to(dtype)

    def idx_of(k):
        return torch.randint(-2, n + 2, (b, n, k), generator=gen,
                             dtype=torch.int32).to(dev)

    def case(kernel, shape, run, plain, nbytes_, flops, launches):
        # the generic arm and the tuned arms past their old K take
        # milliseconds a call: five calls a timing window
        return dict(kernel=kernel, path="lifted", shape=shape, mult=0,
                    run=run, plain=plain, nbytes=nbytes_, flops=flops,
                    graph_timed=True, graph_references=True, same_bits=True,
                    launches=launches, iters=5)

    def products(rows_k, widths, dtype):
        """cuBLAS on a chain's products alone at ``rows_k`` rows (bf16
        operands with float32 sums, as ``_dot32`` calls it)."""
        xs = [torch.randn((rows_k, c), device=dev).to(dtype)
              for c in widths[:-1]]
        ws = [torch.randn((c, o), device=dev).to(dtype)
              for c, o in zip(widths[:-1], widths[1:])]
        if dtype == BF16:
            return lambda: [torch.mm(x, w, out_dtype=torch.float32)
                            for x, w in zip(xs, ws)]
        return lambda: [x @ w for x, w in zip(xs, ws)]

    def mse_cases(widths, cf, ks, dtype, names):
        radii = tuple(2.0 * (i + 1) for i in range(len(ks)))
        mse = seeded_module(MultiScaleEncoder(radii, ks, cf, widths,
                                              (16,)), gen, dev)
        with torch.no_grad():
            packed, _ = fused.mse_narrow_params_from_variables(mse, dtype)
        c1, c2, c3 = widths
        tuned = fused.mse_arm(widths, len(ks), cf) == fused.TUNED
        if tuned:  # affine scales of both signs (a trained BatchNorm's)
            packed = list(packed)
            for slot in (2, 5, 8):
                sign = torch.where(torch.rand(packed[slot].shape,
                                              generator=gen) < 0.5, -1.0, 1.0)
                packed[slot] = packed[slot] * sign.to(dev)
            packed = tuple(packed)
        feats = rand(b, cf, n, dtype=dtype).transpose(1, 2)
        idx = [idx_of(k) for k in ks]
        extra = {}
        if tuned:  # the tuned arm: cuBLAS on every scale's two products
            extra = dict(cublas=products(rows * sum(ks), widths[1:], dtype),
                         launches_long=int(max(ks) > fused.MSE_TILE_MAX_K))
            tile = [s for s, k in enumerate(ks) if k <= fused.MSE_TILE_MAX_K]
            if tile and len(tile) < len(ks):
                extra["tile_bits"] = check_tile_bits(feats, idx, pc, packed,
                                                     tile)
                # both kernels beside the centroids' mean (and, in float32,
                # the weight image)
                extra["kernels_per_call"] = (1, math.inf if dtype !=
                                             BF16 else 3)
        out = []
        for name, fn, launches in names:
            out.append(dict(case(
                name, f"B={b} N={n} K={ks} Cf={cf} widths={widths} {dtype}",
                lambda fn=fn: fn(feats, idx, pc, packed),
                lambda: fused.fused_multi_scale_encoder_plain(
                    feats, idx, pc, packed),
                nbytes(pc, feats, idx, packed) + rows * len(ks) * c3 * 4,
                2 * (rows * len(ks) * c1 * (3 + cf)
                     + rows * sum(ks) * (c1 * c2 + c2 * c3)), launches),
                **(extra if fn is mse_fn else {})))
        return out

    def plf_cases(widths, k, names, dtype=torch.float32):
        plf = seeded_module(PointLocalFeature(8.0, k, 40, widths, (16,)),
                            gen, dev)
        with torch.no_grad():
            chain, _, _ = fused.plf_params_from_variables(plf)
        chain = inference._cast_chain(chain, dtype)
        feat_tx = rand(b, n, widths[0], dtype=dtype)
        idx = idx_of(k)
        out = [case(name, f"B={b} N={n} K={k} chain={widths}",
                    lambda fn=fn: fn(feat_tx, idx, pc, chain),
                    lambda: fused.fused_point_local_feature_plain(
                        feat_tx, idx, pc, chain),
                    nbytes(feat_tx, idx, pc, chain) + rows * widths[-1] * 4,
                    2 * rows * widths[0] * 6 + chain_flops(rows, k, widths),
                    launches)
               for name, fn, launches in names]
        for row in out:  # the tuned arm: cuBLAS on its two products (the
            # bf16 full-tile arm's calls on it counted)
            if (row["kernel"] in ("plf", "plf.full.bf16")
                    and tuple(widths) == fused.PLF_WIDTHS):
                row["cublas"] = products(rows * k, widths, dtype)
            if row["kernel"] == "plf.full.bf16":
                row["launches_full"] = 1
        return out

    def cv_cases(c, k, names, agg_names=(), dtype=torch.float32):
        fc = seeded_module(FeatureCorrelator(k, c, c, (c, c, c)), gen, dev)
        with torch.no_grad():
            dense, wn1, wn2 = fused.cv_params_from_variables(fc)
        # (b0, w1, b1, w2, b2), the Dense kernels in ``dtype``
        chain = [t.to(dtype) if i % 2 else t for i, t in enumerate(dense[1:])]
        args = (rand(b, n, c, dtype=dtype), rand(b, n, c, dtype=dtype),
                idx_of(k), rand(b, n, h), rand(b, n, h), chain, wn1[1:])
        out = [case(name, f"B={b} N={n} C={c} k={k} {dtype}",
                    lambda fn=fn: fn(*args),
                    lambda: fused.cost_volume_p2p_plain(*args),
                    nbytes(args) + rows * c * args[0].element_size(),
                    chain_flops(rows, k, (c, c, c))
                    + 2 * rows * k * (h * h + h * c), launches)
               for name, fn, launches in names]
        for row in out:  # the tuned arm: its calls on its full-tile arms,
            # and cuBLAS on its two products
            if (row["kernel"] in ("cv", "cv_p2p.full.bf16")
                    and c == fused.CV_WIDTH):
                row["launches_full"] = int(dtype == BF16
                                           or fused.cv_p2p_full(k))
                row["cublas"] = products(rows * k, (c, c, c), dtype)
        agg_args = (rand(b, n, c), idx_of(k), rand(b, n, h), wn2[1:])
        out += [case(name, f"B={b} N={n} C={c} k={k}",
                     lambda fn=fn: fn(*agg_args),
                     lambda: fused.cost_volume_agg_plain(*agg_args),
                     nbytes(agg_args) + rows * c * 4,
                     2 * rows * k * (h * h + h * c + c), launches)
                for name, fn, launches in agg_names]
        return out

    mse_fn, plf_fn = (fused.fused_multi_scale_encoder,
                      fused.fused_point_local_feature)
    cv_fn, agg_fn = fused.cost_volume_p2p, fused.cost_volume_agg
    for dtype in (torch.float32, BF16):
        sfx = ".bf16" if dtype == BF16 else ""
        for k in LIFTED_MSE_K:
            cases += mse_cases(fused.MSE_WIDTHS, 3, (k,), dtype,
                               [(f"mse.long{sfx}", mse_fn, 1)])
            cases += mse_cases(fused.MSE_WIDTHS, 3, LIFTED_MSE_MIXED + (k,),
                               dtype, [(f"mse{sfx}", mse_fn, 1)])
    for name, k in LIFTED_TUNED:
        if name == "cv":
            cases += cv_cases(fused.CV_WIDTH, k, [(name, cv_fn, 1)])
        else:
            cases += plf_cases(fused.PLF_WIDTHS, k, [(name, plf_fn, 1)])
    widths, cf, ks = LIFTED_MSE
    cases += mse_cases(widths, cf, ks, torch.float32,
                       [("mse.generic", mse_fn, len(ks))])
    for widths in LIFTED_PLF:
        cases += plf_cases(widths, LIFTED_GENERIC_K,
                           [("plf.generic", plf_fn, 1)])
    for c in LIFTED_CV:
        cases += cv_cases(c, LIFTED_GENERIC_K, [("cv.generic", cv_fn, 1)],
                          [("cv_agg.generic", agg_fn, 1)])
    # a K5 chain of LIFTED_DEPTH Dense layers (the generic kernel's layer
    # table is a device array: no limit), float32 and bf16
    widths = (LIFTED_DEPTH_WIDTH,) * (LIFTED_DEPTH + 1)
    for dtype in (torch.float32, BF16):
        chain = deep_chain(gen, LIFTED_DEPTH_WIDTH, LIFTED_DEPTH, dtype, dev,
                           two_terms=dtype == BF16)
        feat_tx = rand(b, n, widths[0], dtype=dtype)
        idx = idx_of(LIFTED_GENERIC_K)
        cases.append(case(
            "plf.generic" + (".bf16" if dtype == BF16 else ""),
            f"B={b} N={n} K={LIFTED_GENERIC_K} chain=({widths[0]},)*"
            f"{len(widths)} {dtype}",
            lambda fn=plf_fn, a=(feat_tx, idx, pc, chain): fn(*a),
            lambda a=(feat_tx, idx, pc, chain):
                fused.fused_point_local_feature_plain(*a),
            nbytes(feat_tx, idx, pc, chain) + rows * widths[-1] * 4,
            2 * rows * widths[0] * 6
            + chain_flops(rows, LIFTED_GENERIC_K, widths), 1))
    # each generic arm at its tuned sibling's shape, the tuned arm beside
    cases += mse_cases(fused.MSE_WIDTHS, 3, (4, 8, 16, 32), torch.float32,
                       [("mse", mse_fn, 1),
                        ("mse.generic", fused._mse_generic, 4)])
    cases += plf_cases(fused.PLF_WIDTHS, LIFTED_GENERIC_K,
                       [("plf", plf_fn, 1),
                        ("plf.generic", fused._plf_generic, 1)])
    cases += cv_cases(fused.CV_WIDTH, LIFTED_GENERIC_K,
                      [("cv", cv_fn, 1),
                       ("cv.generic", fused._cv_p2p_generic, 1)],
                      [("cv_agg", agg_fn, 1),
                       ("cv_agg.generic", fused._cv_agg_generic, 1)])
    # the bf16 full-tile arms at the K whose tiles of whole queries leave
    # rows empty (last, so that the cases above draw the inputs they drew)
    for k in LIFTED_FULL_BF16["cv"]:
        cases += cv_cases(fused.CV_WIDTH, k,
                          [("cv_p2p.full.bf16", cv_fn, 1)], dtype=BF16)
    for k in LIFTED_FULL_BF16["plf"]:
        cases += plf_cases(fused.PLF_WIDTHS, k,
                           [("plf.full.bf16", plf_fn, 1)], dtype=BF16)
    return cases


def deep_chain(gen: torch.Generator, width: int, depth: int, dtype, dev,
               two_terms: bool = False) -> list:
    """A K5 chain ``(wrel, s0, b0, w1, s1, b1, ...)`` of ``depth`` Dense
    layers ``width`` wide: He-scaled kernels in ``dtype``, affines near the
    identity, so activations stay of order one at any depth.  With
    ``two_terms`` each output column has two nonzero weights (0.75, 1 or
    1.25 and +-0.5, exact in bf16): every float32 sum of a product then has
    two terms, the same in any order, and two bf16 chains that sum in other
    orders do not drift apart through the layers (deep_bf16_witness)."""
    def uniform(lo, hi, *shape):
        return lo + (hi - lo) * torch.rand(shape, generator=gen)

    c = width
    chain = [torch.randn((3, c), generator=gen) * 0.3, uniform(0.8, 1.2, c),
             uniform(-0.1, 0.1, c)]
    cols = torch.arange(c)
    for _ in range(depth):
        if two_terms:
            w = torch.zeros((c, c))
            pick = torch.stack([torch.randperm(c, generator=gen)[:2]
                                for _ in range(c)])
            w[pick[:, 0], cols] = torch.tensor([0.75, 1.0, 1.25])[
                torch.randint(0, 3, (c,), generator=gen)]
            w[pick[:, 1], cols] = torch.where(
                torch.rand(c, generator=gen) < 0.5, -0.5, 0.5)
        else:
            w = torch.randn((c, c), generator=gen) * math.sqrt(2.0 / c)
        chain += [w, uniform(0.8, 1.2, c), uniform(-0.1, 0.1, c)]
    return [(t.to(dtype) if i % 3 == 0 else t).to(dev)
            for i, t in enumerate(chain)]


def deep_bf16_witness(dev, gen: torch.Generator) -> dict:
    """The depth-LIFTED_DEPTH chain in bf16 with dense He-scaled kernels,
    the generic kernel against its plain version, measured and not held:
    bf16 roundings that a float32 sum in another order flips compound
    through the layers (any two implementations drift apart so, the JAX
    kernel's too); float32 at that depth is held (lifted_fused)."""
    b, n = B, 256
    chain = deep_chain(gen, LIFTED_DEPTH_WIDTH, LIFTED_DEPTH, BF16, dev)
    feat_tx = torch.randn((b, n, LIFTED_DEPTH_WIDTH), generator=gen).to(
        dev).to(BF16)
    idx = torch.randint(-2, n + 2, (b, n, LIFTED_GENERIC_K), generator=gen,
                        dtype=torch.int32).to(dev)
    pc = (20.0 * torch.rand((b, n, 3), generator=gen)).to(dev)
    got = fused.fused_point_local_feature(feat_tx, idx, pc, chain)
    want = fused.fused_point_local_feature_plain(feat_tx, idx, pc, chain)
    err, scale = errors(got, want)
    out = dict(depth=LIFTED_DEPTH, width=LIFTED_DEPTH_WIDTH,
               k=LIFTED_GENERIC_K, max_abs_err=err, plain_max_abs=scale,
               rel_err=err / scale, bar=BF16_RTOL, held=False)
    emit({"deep_bf16_witness": out})
    return out


def chain_tc_report() -> dict:
    """The tensor-core generic kernel's plan at config B's chains (K=16,
    B=16, N=256) beside the card's own count of blocks an SM at its shared
    memory, and each instantiation's static shared memory against the
    plan's bound; fails where the card holds fewer blocks than planned."""
    out = {}
    for kind in ("max", "p2p"):
        for bf16 in (False, True):
            got = fused.chain_tc_static_smem(kind, bf16)
            require(0 < got <= fused.CHAIN_TC_STATIC_SMEM,
                    f"chain_tc {kind} bf16={bf16}: {got} bytes of static "
                    f"shared memory, the plan counts "
                    f"{fused.CHAIN_TC_STATIC_SMEM}")
            out[f"static_smem_{kind}{'_bf16' if bf16 else ''}"] = got
    for name, kind, c0, widths in (("K5", "max", 768, (384, 96)),
                                   ("K4a", "p2p", 768, (768, 768)),
                                   ("K3", "max", 64, (64, 128))):
        for bf16 in (False, True):
            plan = fused.chain_tc_plan(bf16, c0, widths, 16, B * 256)
            card = fused.chain_tc_occupancy(kind, bf16, plan["smem"])
            require(card >= plan["blocks_per_sm"],
                    f"chain_tc {name} bf16={bf16}: the card holds {card} "
                    f"blocks an SM, the plan {plan['blocks_per_sm']}")
            out[f"{name}{'_bf16' if bf16 else ''}"] = dict(
                smem=plan["smem"], blocks_per_sm_planned=plan[
                    "blocks_per_sm"], blocks_per_sm_card=card,
                x_global=plan["x_global"], y_global=plan["y_global"],
                grid=plan["grid"], iters=plan["iters"],
                period=plan["period"])
    emit({"chain_tc": out})
    return out


def mse_long_report() -> dict:
    """K3's long kernels' plan at config A's scales (B=16, N=256) beside
    the card's own count of blocks an SM at its shared memory and each
    instantiation's static shared memory; fails where the card holds fewer
    blocks than planned or more static shared memory than the plan
    counts."""
    out = {}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for bf16 in (False, True):
        plan = fused.mse_long_plan(SHAPE_CONFIGS["A"]["sa_nsamples"],
                                   B * 256, 256, bf16, sms)
        card = fused.mse_long_occupancy(bf16, plan["span"], plan["smem"])
        static = fused.mse_long_static_smem(bf16, plan["span"])
        require(card >= plan["blocks_per_sm"],
                f"K3 long bf16={bf16}: the card holds {card} blocks an SM, "
                f"the plan {plan['blocks_per_sm']}")
        require(0 < static <= fused.MSE_LONG_STATIC_SMEM[bf16],
                f"K3 long bf16={bf16}: {static} bytes of static shared "
                f"memory, the plan counts "
                f"{fused.MSE_LONG_STATIC_SMEM[bf16]}")
        out["bf16" if bf16 else "float32"] = dict(
            grid=plan["grid"], qpb=plan["qpb"], span=plan["span"],
            smem=plan["smem"], blocks_per_sm_planned=plan["blocks_per_sm"],
            blocks_per_sm_card=card, static_smem=static)
    emit({"mse_long": out})
    return out


def check_lifted(cases, key: str = "lifted") -> dict:
    """Each case of :func:`lifted_cases` or :func:`fused_lifted_cases`: its
    wrapper's launches a call, then check_kernels; prints a ``key`` line;
    returns {kernel: rows}."""
    for case in cases:
        wrapper = wrapper_of(case["kernel"])
        before = wrapper.launches
        long_before = getattr(wrapper, "launches_long", 0)
        full_before = getattr(wrapper, "launches_full", 0)
        case["run"]()
        require(wrapper.launches - before == case["launches"],
                f"{case['kernel']} {case['shape']}: "
                f"{wrapper.launches - before} launches a call, not "
                f"{case['launches']}")
        if "launches_long" in case:  # K3's calls that took the long kernel
            got = wrapper.launches_long - long_before
            require(got == case["launches_long"],
                    f"{case['kernel']} {case['shape']}: {got} calls of the "
                    f"long kernel, not {case['launches_long']}")
        if "launches_full" in case:  # K4a's calls on its full-tile arm
            got = wrapper.launches_full - full_before
            require(got == case["launches_full"],
                    f"{case['kernel']} {case['shape']}: {got} calls of the "
                    f"full-tile arm, not {case['launches_full']}")
    rows = check_kernels(cases, False, {})
    out = {}
    for case in cases:  # the output's bits, to compare trees
        got = case["run"]()
        torch.cuda.synchronize()
        case["digest"] = hashlib.sha1(b"".join(
            x.contiguous().view(torch.uint8).cpu().numpy().tobytes()
            for x in (got if isinstance(got, tuple) else (got,)))
        ).hexdigest()[:16]
    for case, row in zip(cases, rows):
        entry = dict(
            shape=row["shape"], launches_per_call=case["launches"],
            kernels_per_call=row["kernels_per_call"], ms=row["kernel_ms"],
            plain_ms=row["plain_ms"], library_ms=row["library_ms"],
            bound_ms=row["bound_ms"], bound_by=row["bound_by"],
            share_of_bound=row["share_of_bound"],
            max_abs_err=row["max_abs_err"],
            plain_max_abs=row.get("plain_max_abs"), same_bits=True,
            digest=case["digest"])
        for extra in ("cublas_products_ms", "tile_bits", "launches_full"):
            if extra in row or extra in case:
                entry[extra] = row.get(extra, case.get(extra))
        out.setdefault(case["kernel"], []).append(entry)
    emit({key: out})
    return out


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
    elif (name in BF16_ARMS or name in GENERIC_BF16_ARMS
          or name in LONG_BF16_ARMS or name in FULL_BF16_ARMS
          ) and name not in F32_ACCURATE_ARMS:
        require(got.dtype == want.dtype and err <= BF16_RTOL * scale,
                f"{name} {case['shape']}: kernel and plain version "
                f"differ by {err} at a largest magnitude of {scale}")
    else:
        require(err <= FUSED_ATOL and err <= FUSED_RTOL * scale,
                f"{name} {case['shape']}: kernel and plain version "
                f"differ by {err} at a largest magnitude of {scale}")
    if name in SAME_BITS or case.get("same_bits"):
        again = case["run"]()
        torch.cuda.synchronize()
        pairs = zip(got, again) if isinstance(got, tuple) else [(got, again)]
        require(all(torch.equal(a, b) for a, b in pairs),
                f"{name} {case['shape']}: two runs differ")
    if "csr" in case:  # K7's first kernel alone, exactly
        for a, b in zip(case["csr"](), case["csr_plain"]()):
            require(torch.equal(a, b), f"{name} {case['shape']}: "
                                       f"gather_rows_csr and its plain "
                                       f"version differ")
    return err, scale


def reference_ms(case, key: str, iters: int):
    """Device ms of one call of a case's plain version or yardstick
    (``key``), or None where it has none: by ``torch.profiler`` over
    ``iters`` calls, or, for a case with ``graph_references``, by replays
    of a CUDA graph of three (a fresh process's profiler dropped a
    window's first kernel, every window).  Where the profiler records no
    whole window, the graph's replays time it too."""
    fn = case.get(key)
    if fn is None:
        return None
    if case.get("graph_references"):
        return graph_ms(fn, 3)[0]
    try:
        return device_ms(fn, iters)[1]
    except ProfilerWindowError as e:
        print(json.dumps(dict(timed_by_graph=dict(
            kernel=case["kernel"], shape=case["shape"], key=key,
            reason=str(e)))), file=sys.stderr, flush=True)
        return graph_ms(fn, 3)[0]


def kernel_ms(case, name: str, iters: int) -> tuple:
    """(The case's kernels' device ms a call, every kernel's, each of its
    kernels' own, the kernels a call launches) of its wrapper, from the
    profiler.  Where the profiler records no whole window and the wrapper
    launches only the case's own kernels, from replays of a CUDA graph of
    ``iters`` calls instead (parts not split); the row then says so."""
    before = wrapper_of(name).launches
    case["run"]()
    per_call = wrapper_of(name).launches - before
    try:
        return device_ms(case["run"], 20, DEVICE_NAMES[name], per_call)
    except ProfilerWindowError as e:
        ms, call_kernels = graph_ms(case["run"], iters)
        require(call_kernels == per_call * len(DEVICE_NAMES[name]),
                f"{name} {case['shape']}: {e}, and its call launches "
                f"{call_kernels} kernels, not only its own")
        case["timed_by"] = "cuda_graph"
        print(json.dumps(dict(timed_by_graph=dict(
            kernel=name, shape=case["shape"], key="run", reason=str(e)))),
            file=sys.stderr, flush=True)
        return ms, ms, {}, call_kernels


def check_kernels(cases, first: bool, per_forward: dict) -> list:
    """Hold each case to its plain version, time it, print it, and sum the
    first request's cases per forward or step of their route into
    ``per_forward[(kernel, route)]``; returns the printed rows."""
    rows = []
    for case in cases:
        name = case["kernel"]
        err, scale = hold_to_plain(case)
        # calls a timing window takes (fewer for the slow generic arms)
        iters = case.get("iters", 20)
        if case.get("graph_timed"):
            own, call_kernels = graph_ms(case["run"], iters)
            wrapper, parts = own, {}
        else:
            own, wrapper, parts, call_kernels = kernel_ms(case, name, iters)
        lo, hi = case.get("kernels_per_call",
                          KERNELS_PER_CALL.get(name, (1, math.inf)))
        require(lo <= call_kernels <= hi,
                f"{name} {case['shape']}: {call_kernels} kernels a call, "
                f"not {lo}..{hi}")
        row = dict(kernel=name, path=case["path"], shape=case["shape"],
                   kernel_ms=own, wrapper_device_ms=wrapper,
                   kernels_per_call=call_kernels,
                   kernel_event_ms=event_ms(case["run"], 5 * iters // 2),
                   plain_ms=reference_ms(case, "plain", 5),
                   library_ms=reference_ms(case, "library", 10),
                   max_abs_err=err)
        if len(parts) > 1:
            row["kernel_parts_ms"] = parts
        if "timed_by" in case:
            row["timed_by"] = case["timed_by"]
        if name not in EXACT:
            row["plain_max_abs"] = scale
        if "cublas" in case:
            row["cublas_products_ms"] = reference_ms(case, "cublas", 10)
        row.update(bounds(name, case["nbytes"], case["flops"]))
        row.update(shares(row, row["kernel_ms"]))
        row["launches_per_forward"] = (case["mult"]
                                       * case.get("launches_per_call", 1))
        emit(row)
        rows.append(row)
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
    return rows


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
                 hold: bool = True, hold_masks: bool = True) -> dict:
    """Hold a bf16 forward's outputs to ``ref`` at BF16_BARS (or, without
    ``hold``, only measure them; without ``hold_masks``, all but the masks'
    agreement), on the valid points (sf_agg where the masks agree, as
    :func:`compare`); CMFlow_T's new carry is reported."""
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
            and (res["mask_agreement"] >= BF16_BARS["agree"]
                 or not hold_masks)
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


# backbone configurations whose shapes the tuned fused kernels were not
# written for: A past their old K at the default widths (the tuned arms at
# K=64), B at other widths (fc_inch 768, ep_mlp (768, 384, 96); every fused
# wrapper on the generic kernel), C at the default widths with K that leave
# tiles of whole queries part empty (K3 at 12 and 24 and its long kernel at
# 48 and 96; in bf16 K4a at k=48 and K5's scales on their full-tile arms)
SHAPE_CONFIGS = {
    "A": dict(sa_nsamples=(8, 16, 32, 64), fc_nsample=64),
    "B": dict(sa_radii=(2.0, 4.0, 8.0), sa_nsamples=(16, 32, 64),
              sa_mlp=(64, 64, 128), sa_mlp2=(128, 128, 128), fc_nsample=16),
    "C": dict(sa_nsamples=(12, 24, 48, 96), fc_nsample=48),
}
SHAPE_FAMILIES = {"cmflow": CMFlow, "raflow": RaFlow, "cmflow_t": CMFlowT}
# the families served at each config: all three at B; at A and C, whose
# kernels and shapes the three share, CMFlow
SHAPE_SERVED = {"A": ("cmflow",), "B": tuple(SHAPE_FAMILIES),
                "C": ("cmflow",)}
# the configs whose bf16 forward has every fused kernel timed, each with
# its share of the forward's device time
SHAPE_BREAKDOWN = ("C",)
# the batch elements of each request the CPU's forward is held on (the
# engines treat each element on its own; a B=16 CPU forward at config B
# takes seconds)
SHAPE_CPU_ROWS = 4
# CMFlow's train steps, from seeded weights and fresh BatchNorm statistics
# as the CLI's 2-epoch run takes them, before its bf16 forward is held to
# the CPU's: on random weights (flows of metres, stat_cls near 0.5) bf16
# flipped 1.3% of config A's masks between the card and the CPU and moved
# pre_trans 0.034, as bf16 moves JAX's own forward from float32 (ROADMAP
# Queue 3); the bf16 serving phase holds CLI-trained checkpoints for the
# same reason
SHAPE_TRAIN_STEPS = 8
# the configs whose trained CMFlow's bf16 masks are measured against the
# CPU's bf16 route, not held (stat_cls, pre_trans and sf_agg held): at C
# the 8 steps leave stat_cls within ~0.002 of its 0.5 threshold, so masks
# flipped on 3.5% of the points while stat_cls lay 3e-4 apart, a hundredth
# of its bar (24 steps flipped 1.02% of config A's, at 5.5e-3 apart)
SHAPE_MASKS_MEASURED = ("C",)
# the configs at which CMFlow's random-weight model is also served in bf16
# and measured, not held: the card against the CPU's bf16 route, and each
# against the CPU's float32 route, a second witness of how far bf16's
# rounding alone moves the outputs on those weights
SHAPE_WITNESS = ("A",)


def shapes_phase(dev, gen: torch.Generator, per_forward: dict) -> dict:
    """The families of SHAPE_SERVED built with each of SHAPE_CONFIGS,
    seeded weights and BatchNorm statistics (randomize_batchnorm), serve
    one B=16, N=256 request through ``make_eval_step`` on the card in
    float32 and in bf16, each forward's counters set to 0 just before it
    and read just after: the fused launches of the default config (the
    propagation encoder once a scale), of which config B's K3 (a launch a
    scale), K4a, K4b and K5 on the generic kernel and config A's none.  Float32 is held to the
    module route on the card and, on its first SHAPE_CPU_ROWS elements, to
    the CPU's fused route at the serving bars.
    A CMFlow of the config from seeded weights then takes SHAPE_TRAIN_STEPS
    train steps on the card (module route, synthetic B=16 batches, as the
    CLI's 2-epoch run) and its bf16 forward is held to the CPU's bf16 fused
    route (every kernel's plain version; the same elements) at BF16_BARS
    (at SHAPE_WITNESS's configs the random-weight CMFlow's bf16 forward is
    first measured too, :func:`rounding_witness`); every bf16 forward is measured, not held, against the card's float32
    forward of the same weights (RaFlow's and CMFlow_T's, on random
    weights, only that: ROADMAP Queue 3); CMFlow's forwards are timed by
    their device time.  On CMFlow's request the fused
    kernels are held to their plain versions at the config's shapes in
    both dtypes (the cost volume's on inputs of unit magnitude,
    ``fused_cases``' ``unit_cost``): config B's generic arms timed, each
    call, its plain version and cuBLAS on its products by CUDA-graph
    replays (their rows of the kernels line, paths ``shapes_B`` and
    ``shapes_B_bf16``; ``reference_ms``), the rest untimed.
    At configs A and C K3's calls (both kernels) and its long kernel alone
    (:func:`long_cases`) are timed too, and each forward's share of them
    printed; every forward's calls of the long kernel counted (config A
    and C 2, B 0), and of the full-tile arms (at config C in float32 K4a's
    1, in bf16 K4a's 1 and K5's one a scale whose K leaves a tile of whole
    queries part empty; none elsewhere).  At SHAPE_BREAKDOWN's configs
    every kernel of the bf16 forward is timed, each with its share of the
    forward (the bf16 full-tile arms' rows of the kernels line, path
    ``shapes_C_bf16``).  Returns ({path: each wrapper's generic launches
    summed over the path's forwards}, {path: the long kernel's calls},
    {path: each full-tile arm's calls})."""
    req = make_request(SEED + 70, B, (200, 256))
    calib = make_request(SEED + 71, B, (200, 256))
    head = {k: v[:SHAPE_CPU_ROWS] for k, v in req.items()}

    def cut(out):
        return tuple(x[:SHAPE_CPU_ROWS] for x in out)

    generic, long_launches, full = {}, {}, {}
    t_start = time.perf_counter()
    for cfg_name, kw in SHAPE_CONFIGS.items():
        cfg = BackboneConfig(**kw)
        for fi, family in enumerate(SHAPE_FAMILIES):
            if family not in SHAPE_SERVED[cfg_name]:
                continue
            cls = SHAPE_FAMILIES[family]
            # K3's tuned arm with a scale past K = 32: its long kernel
            k3_long = (fused.mse_arm(cfg.sa_mlp, len(cfg.sa_radii), 3)
                       == fused.TUNED
                       and max(cfg.sa_nsamples) > fused.MSE_TILE_MAX_K)
            model = cls(cfg=cfg)
            init_parameters(model, torch.Generator().manual_seed(
                SEED + 72 + fi))
            model = model.to(dev).eval()
            carry = ((torch.zeros((B, cfg.prop_width), device=dev),)
                     if family == "cmflow_t" else ())
            cpu_carry = tuple(c[:SHAPE_CPU_ROWS].cpu() for c in carry)
            module_step = make_eval_step(family, model, fused="off")
            randomize_batchnorm(model, lambda r: module_step(r, *carry),
                                calib, gen)
            cpu_model = copy.deepcopy(model).to("cpu")
            if family == "cmflow":
                with torch.no_grad():
                    for path, cases in (
                            (f"shapes_{cfg_name}",
                             fused_cases(model, req, dev, unit_cost=True)),
                            (f"shapes_{cfg_name}_bf16",
                             bf16_cases(model, req, dev, unit_cost=True))):
                        # K3's calls timed where a scale is past K = 32,
                        # and its long kernel alone
                        if k3_long:
                            cases = cases + long_cases(
                                model, req, dev, path,
                                BF16 if path.endswith("bf16")
                                else torch.float32)
                        longs = [c for c in cases if c["kernel"] in LONG_ARMS]
                        every = (cfg_name in SHAPE_BREAKDOWN
                                 and path.endswith("bf16"))
                        timed = [c for c in cases if c["kernel"] in GENERIC
                                 or c["kernel"] in FULL_BF16_ARMS or every
                                 or (k3_long and c["kernel"] in (
                                     "mse", "mse.bf16"))]
                        check_kernels(longs, True, per_forward)
                        for c in timed:
                            if c["kernel"] == "mse.bf16":
                                # both kernels beside the centroids' mean
                                c["kernels_per_call"] = (1, 3)
                            # K3's generic arm launches once a scale
                            c.update(path=path, graph_timed=True,
                                     graph_references=True, iters=5,
                                     launches_per_call=len(cfg.sa_radii)
                                     if c["kernel"].startswith("mse.gen")
                                     else 1)
                        check_kernels(timed, True, per_forward)
                        hold_cases([c for c in cases
                                    if c not in timed and c not in longs])
            f32_out = None
            for dtype in (torch.float32, BF16):
                bf16 = dtype == BF16
                path = f"shapes_{cfg_name}{'_bf16' if bf16 else ''}"
                trained = bf16 and family == "cmflow"
                witness = (rounding_witness(family, model, cpu_model, req,
                                            head, cut)
                           if trained and cfg_name in SHAPE_WITNESS
                           else None)
                if trained:
                    model = shape_trained_cmflow(cfg, cfg_name, dev)
                    cpu_model = copy.deepcopy(model).to("cpu")
                    f32_out = make_eval_step(family, model)(req, *carry)
                step = make_eval_step(family, model, compute_dtype=dtype)
                require(step.fused, f"{family} config {cfg_name}: the eval "
                                    f"step on the card must be fused")
                zero_counts()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = step(req, *carry)
                torch.cuda.synchronize()
                latency = time.perf_counter() - t0
                counts = counts_now()
                arms = {k: WRAPPERS[k].launches_generic
                        for k in set(GENERIC_ARMS.values())}
                # K3's calls that took the long kernel: one a cloud where a
                # scale is past K = 32 on the tuned arm
                n_long = WRAPPERS["mse"].launches_long
                want_long = 2 if k3_long else 0
                require(n_long == want_long,
                        f"{family} config {cfg_name} {dtype}: {n_long} "
                        f"calls of K3's long kernel, want {want_long}")
                long_launches[path] = long_launches.get(path, 0) + n_long
                # the calls in full tiles: float32 K4a's where its k
                # leaves a tile of whole queries part empty, the bf16
                # arms' every call
                fulls = full_launches()
                names = arm_names(model)
                want_full = {
                    "cv.full": int(names["cv"] == "cv" and not bf16
                                   and fused.cv_p2p_full(cfg.fc_nsample)),
                    "cv_p2p.full.bf16": int(names["cv"] == "cv" and bf16),
                    "plf.full.bf16": (len(cfg.sa_nsamples)
                                      if names["plf"] == "plf" and bf16
                                      else 0)}
                require(fulls == want_full,
                        f"{family} config {cfg_name} {dtype}: full-tile "
                        f"launches {fulls}, want {want_full}")
                for k, v in fulls.items():
                    full.setdefault(path, {}).setdefault(k, 0)
                    full[path][k] += v
                want = dict(LAUNCHES["fused"], plf=len(cfg.sa_radii))
                if cfg_name == "B":  # K3's generic arm: a launch a scale
                    want["mse"] *= len(cfg.sa_radii)
                want_arms = {k: want[k] if cfg_name == "B" else 0
                             for k in arms}
                require(counts == want and arms == want_arms,
                        f"{family} config {cfg_name} {dtype}: launches "
                        f"{counts}, generic {arms}; want {want}, "
                        f"{want_arms}")
                require(all(bool(torch.isfinite(x).all())
                            for x in out if x.is_floating_point()),
                        f"{family} config {cfg_name} {dtype}: non-finite "
                        f"output")
                for k, v in arms.items():
                    generic.setdefault(path, {}).setdefault(k, 0)
                    generic[path][k] += v
                what = f"{family} config {cfg_name} {dtype}"
                row = dict(config=cfg_name, family=family, dtype=str(dtype),
                           batch=B, bucket=int(req["pc1"].shape[1]),
                           latency_ms=1e3 * latency, launches=counts,
                           generic_launches=arms,
                           mse_long_launches=n_long, full_launches=fulls)
                cpu_step = make_eval_step(family, cpu_model, fused="on",
                                          compute_dtype=dtype)
                if witness:
                    row["random_weights"] = witness
                if bf16:
                    if trained:
                        row["train_steps"] = SHAPE_TRAIN_STEPS
                        row["vs_cpu_bf16"] = compare_bf16(
                            family, head, cut(out),
                            cpu_step(head, *cpu_carry),
                            f"{what} vs the CPU's bf16 route",
                            hold_masks=cfg_name not in SHAPE_MASKS_MEASURED)
                    row["vs_card_float32"] = compare_bf16(
                        family, req, out, f32_out, what, hold=False)
                else:
                    f32_out = out
                    # the family's comparison at the serving bars
                    cmp = {"cmflow": compare, "raflow": compare_raflow,
                           "cmflow_t": compare_temporal}[family]
                    row["vs_module_route"] = cmp(
                        req, out, module_step(req, *carry),
                        f"{what} vs module route")
                    row["vs_cpu"] = cmp(head, cut(out),
                                        cpu_step(head, *cpu_carry),
                                        f"{what} vs CPU")
                if family == "cmflow":  # the whole forward's device time
                    _, ms, _, ops = device_ms(lambda: step(req), 3)
                    row.update(device_ms=ms, cuda_ops_per_forward=ops)
                    # K3's calls and its long kernel, and their shares
                    sfx = ".bf16" if bf16 else ""
                    for key, name in (("k3_calls", f"mse{sfx}"),
                                      ("k3_calls", f"mse.generic{sfx}"),
                                      ("k3_long_kernel", f"mse.long{sfx}")):
                        if (name, path) in per_forward:
                            k3 = per_forward[(name, path)]["ms"]
                            row[f"{key}_ms"] = k3
                            row[f"{key}_share"] = k3 / ms
                    # each timed kernel's device ms a forward and share
                    row["kernels"] = {
                        name: dict(ms=acc["ms"], share=acc["ms"] / ms)
                        for (name, p), acc in per_forward.items()
                        if p == path}
                row["elapsed_s"] = time.perf_counter() - t_start
                emit(dict(shapes=row))
    return generic, long_launches, full


def rounding_witness(family: str, model, cpu_model, req, head,
                     cut) -> dict:
    """``model`` (on the card) and ``cpu_model`` (its copy) in bf16 on
    ``req``, measured at BF16_BARS' quantities, not held: the card's bf16
    fused route against the CPU's (``head``, the elements ``cut`` keeps),
    and each against the CPU's float32 fused route."""
    card = cut(make_eval_step(family, model, compute_dtype=BF16)(req))
    cpu_bf16 = make_eval_step(family, cpu_model, fused="on",
                              compute_dtype=BF16)(head)
    cpu_f32 = make_eval_step(family, cpu_model, fused="on")(head)
    what = f"{family} on random weights"
    return dict(
        card_bf16_vs_cpu_bf16=compare_bf16(family, head, card, cpu_bf16,
                                           what, hold=False),
        cpu_bf16_vs_cpu_float32=compare_bf16(family, head, cpu_bf16,
                                             cpu_f32, what, hold=False),
        card_bf16_vs_cpu_float32=compare_bf16(family, head, card, cpu_f32,
                                              what, hold=False))


def shape_trained_cmflow(cfg, cfg_name: str, dev):
    """A CMFlow of ``cfg`` from seeded weights after SHAPE_TRAIN_STEPS train
    steps on the card, each on its own synthetic B=16, N=256 batch, every
    loss item finite; in eval mode."""
    model = CMFlow(cfg=cfg)
    init_parameters(model, torch.Generator().manual_seed(SEED + 79))
    model = model.to(dev)
    state = create_train_state(model)
    step = make_train_step("cmflow", model, VOD_CAMERA_PROJECTION,
                           VOD_T_CAMERA_RADAR)
    for i in range(SHAPE_TRAIN_STEPS):
        items = step(state, make_train_batch(SEED + 80 + i, B, 256))
        require(all(np.isfinite(float(v)) for v in items.values()),
                f"cmflow config {cfg_name} train step {i}: non-finite "
                f"loss items")
    return model.eval()


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


# ---------------------------------------------------------------------------
# PointNet++ modules and farthest-point sampling, recomputation, debugging
# ---------------------------------------------------------------------------

# PointNet++ SSG at its published widths (Qi et al. 2017;
# charlesq34/pointnet2 pointnet2_cls_ssg.py and pointnet2_part_seg_ssg.py):
# three set abstractions, then feature propagation from level 2 to level 1
# and from level 1 to the input (the one from the group-all level is left
# out: FeaturePropagation takes three neighbours and that level has one
# point)
SSG_B, SSG_N = 16, 1024
SSG_SA = ((512, 0.2, 32, 0, (64, 64, 128)),
          (128, 0.4, 64, 128, (128, 128, 256)),
          (None, None, None, 256, (256, 512, 1024)))
SSG_FP = ((256 + 128, (256, 128)), (128, (128, 128, 128)))
# FPS at the SSG path's shapes (SA1, SA2), summed per forward, and at one
# VoD-size cloud (B=16, 256 points), held and timed alone
FPS_PATH_CASES = ((SSG_B, SSG_N, 512), (SSG_B, 512, 128))
FPS_VOD_CASE = (B, 256, 64)
# three_nn at SSG's propagation levels: (queries, known points)
THREE_NN_CASES = ((512, 128), (SSG_N, 512))
# float32 operations per point per FPS step: 3 differences, 3 squares, 2
# sums, the running minimum and the argmax comparison
FPS_FLOPS = 10
# the card's SSG step against the CPU's: outputs, running statistics,
# gradients (relative L2 a leaf, whole)
SSG_BARS = {"out_atol": 1e-4, "stats_atol": 1e-5, "grad_leaf_l2": 3e-2,
            "grad_l2": 1e-2}
REMAT_MODES = (False, True, "dots")
# the kernels the profiled CLI run's trace must name: the train step's and
# the val forward's
TRACED = ("ball_query", "knn", "gather", "gather_bwd", "mse", "cv", "cv_agg",
          "plf")
DEBUG_PARTS = {"train": 32, "val": 16, "test": 16}
PROFILE_TRIES_CLI = 3


def unit_sphere(gen: torch.Generator, b: int, n: int) -> torch.Tensor:
    """``[b, n, 3]`` points on the unit sphere, from ``gen``."""
    x = torch.randn((b, n, 3), generator=gen)
    return x / x.norm(dim=-1, keepdim=True)


def fps_case(b, n, npoint, dev, gen, mult):
    xyz = unit_sphere(gen, b, n).to(dev)
    return dict(
        kernel="fps", path="extras", shape=f"B={b} N={n} npoint={npoint}",
        mult=mult,
        run=lambda: sampling.farthest_point_sample(xyz, npoint),
        plain=lambda: sampling.farthest_point_sample_plain(xyz, npoint),
        nbytes=b * n * 3 * 4 + b * npoint * 4,
        flops=FPS_FLOPS * b * n * npoint, graph_timed=True)


def check_three_nn(dev, gen: torch.Generator) -> list:
    """``three_nn`` at the shapes of SSG's two propagation levels on the
    card (indices from K2, distances from K6's neighbours) against the
    correctly rounded square root of ``knn_with_dists`` on the card and
    ``three_nn`` on the CPU, bit for bit; returns the shapes held."""
    held = []
    for s, n in THREE_NN_CASES:
        query, points = unit_sphere(gen, SSG_B, s), unit_sphere(gen, SSG_B, n)
        dist, idx = pointops.three_nn(query.to(dev), points.to(dev))
        d2, kidx = pointops.knn_with_dists(3, query.to(dev), points.to(dev))
        cdist, cidx = pointops.three_nn(query, points)
        torch.cuda.synchronize()
        require(torch.equal(idx, kidx) and torch.equal(
            dist, pointops.sqrt_rn(torch.clamp_min(d2, 0.0))),
            f"three_nn S={s} N={n}: the card's differs from its "
            f"knn_with_dists")
        require(torch.equal(idx.cpu(), cidx) and torch.equal(dist.cpu(),
                                                             cdist),
                f"three_nn S={s} N={n}: the card's differs from the CPU's")
        held.append(f"B={SSG_B} S={s} N={n}")
    return held


def ssg_modules() -> torch.nn.ModuleDict:
    mods = {f"sa{i + 1}": SetAbstraction(*args)
            for i, args in enumerate(SSG_SA)}
    mods.update({f"fp{2 - i}": FeaturePropagation(*args)
                 for i, args in enumerate(SSG_FP)})
    return torch.nn.ModuleDict(mods)


def ssg_forward(m, xyz):
    """SSG's train-mode forward: (level-1 and level-2 centroids, the global
    feature, the features propagated back to the input)."""
    l1_xyz, l1 = m["sa1"](xyz, None, True)
    l2_xyz, l2 = m["sa2"](l1_xyz, l1, True)
    _, l3 = m["sa3"](l2_xyz, l2, True)
    up1 = m["fp2"](l1_xyz, l2_xyz, l1, l2, True)
    up0 = m["fp1"](xyz, l1_xyz, None, up1, True)
    return l1_xyz, l2_xyz, l3, up0


def ssg_step(m, xyz, r3, r0):
    """Forward and backward of ``sum(l3 * r3) + sum(up0 * r0)``."""
    m.zero_grad(set_to_none=True)
    out = ssg_forward(m, xyz)
    ((out[2] * r3).sum() + (out[3] * r0).sum()).backward()
    return out


def extras_phase(dev, gen, per_forward: dict) -> tuple:
    """FPS against its plain version bit for bit (the SSG path's shapes,
    summed per forward, and one VoD-size cloud), then one train-mode
    forward and backward of PointNet++ SSG at B=16, N=1024 on the card,
    its launches counted and required, held to the same modules on the
    CPU at SSG_BARS; returns (the numbers, the path's launches)."""
    with torch.no_grad():
        check_kernels([fps_case(*c, dev, gen, 1) for c in FPS_PATH_CASES],
                      True, per_forward)
        check_kernels([fps_case(*FPS_VOD_CASE, dev, gen, 0)], False,
                      per_forward)
        three_nn_held = check_three_nn(dev, gen)
    cpu = ssg_modules()
    init_parameters(cpu, torch.Generator().manual_seed(SEED + 60))
    card = copy.deepcopy(cpu).to(dev)
    xyz = unit_sphere(gen, SSG_B, SSG_N)
    r3 = torch.randn((SSG_B, 1, SSG_SA[2][4][-1]), generator=gen)
    r0 = torch.randn((SSG_B, SSG_N, SSG_FP[1][1][-1]), generator=gen)
    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = ssg_step(card, xyz.to(dev), r3.to(dev), r0.to(dev))
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = counts_now()
    require(launches == LAUNCHES["extras"],
            f"extras: launches {launches}, want {LAUNCHES['extras']}")
    want = ssg_step(cpu, xyz, r3, r0)
    require(all(torch.equal(a.cpu(), b) for a, b in zip(out[:2], want[:2])),
            "extras: the card's centroids differ from the CPU's")
    res = dict(out_max_abs_err=max(
        float((a.detach().cpu() - b.detach()).abs().max())
        for a, b in zip(out[2:], want[2:])))
    res["stats_max_abs_err"] = max(
        float((a.cpu() - b).abs().max()) for (k, a), (_, b) in zip(
            card.state_dict().items(), cpu.state_dict().items())
        if "running" in k)
    leaf_l2 = gradient_errors(card, cpu, res)
    require(res["out_max_abs_err"] <= SSG_BARS["out_atol"]
            and res["stats_max_abs_err"] <= SSG_BARS["stats_atol"]
            and res["grad_leaf_l2_max"] <= SSG_BARS["grad_leaf_l2"]
            and res["grad_l2"] <= SSG_BARS["grad_l2"],
            f"extras: the card's SSG step against the CPU's: {res}, worst "
            f"leaf {max(leaf_l2, key=leaf_l2.get)}")
    require(all(torch.isfinite(o).all() for o in out[2:]),
            "extras: non-finite outputs")
    step_ms = event_ms(lambda: ssg_step(card, xyz.to(dev), r3.to(dev),
                                        r0.to(dev)), 5)
    return dict(batch=SSG_B, num_points=SSG_N, sa=SSG_SA, fp=SSG_FP,
                three_nn_same_bits=three_nn_held, launches=launches,
                first_step_s=first_s, step_ms=step_ms,
                peak_memory_mb=torch.cuda.max_memory_allocated(dev) / 1e6,
                vs_cpu=res), launches


def remat_phase(dev, batch: dict) -> dict:
    """The CMFlow float32 train step (B=16, N=256) in each remat mode from
    the same seeded weights: the same loss items, gradients, parameters and
    BatchNorm statistics (bits) in all three; each mode's peak memory,
    device ms a step and launches ("dots" the gathers of False, True
    more)."""
    runs, ref = {}, None
    for mode in REMAT_MODES:
        model = build_model("cmflow", device=dev, seed=SEED + 40, remat=mode)
        state = create_train_state(model)
        step = make_train_step("cmflow", model, VOD_CAMERA_PROJECTION,
                               VOD_T_CAMERA_RADAR)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        zero_counts()
        items = step(state, batch)
        torch.cuda.synchronize()
        counts = counts_now()
        peak = torch.cuda.max_memory_allocated(dev)
        bits = ({k: float(v) for k, v in items.items()},
                dict(leaves(export_flax_variables(model, grads=True))),
                {k: v.detach().cpu().clone()
                 for k, v in model.state_dict().items()})
        if ref is None:
            ref = bits
        else:
            require(bits[0] == ref[0], f"remat {mode}: loss items {bits[0]} "
                                       f"against {ref[0]}")
            require(all(np.array_equal(bits[1][k], v)
                        for k, v in ref[1].items()),
                    f"remat {mode}: gradients differ from remat False")
            require(all(torch.equal(bits[2][k], v)
                        for k, v in ref[2].items()),
                    f"remat {mode}: parameters or statistics differ from "
                    f"remat False")
        _, dev_ms, _, ops = device_ms(lambda: step(state, batch), 3)
        runs[str(mode)] = dict(
            launches=counts, peak_memory_gb=peak / 1e9,
            peak_over_weights_gb=(peak - base) / 1e9, device_ms=dev_ms,
            cuda_ops_per_step=ops,
            step_event_ms=event_ms(lambda: step(state, batch), 3))
    plain = runs["False"]["launches"]
    require(plain == LAUNCHES["train"], f"remat False: launches {plain}")
    require(runs["dots"]["launches"] == plain,
            f"remat dots: launches {runs['dots']['launches']}, want those "
            f"of remat False {plain}")
    require(runs["True"]["launches"]["gather"] > plain["gather"],
            f"remat True: {runs['True']['launches']['gather']} gathers")
    return dict(batch=int(batch["pc1"].shape[0]),
                num_points=int(batch["pc1"].shape[1]), same_bits=True,
                modes=runs)


def trace_kernels(path: str) -> set:
    """The names of the CUDA kernels in a Chrome trace."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return {e["name"] for e in events if e.get("cat") == "kernel"}


def debug_phase(dev) -> dict:
    """A 2-step CLI run with ``--profile_dir`` whose trace names every
    kernel of the train step and of the val forward (traced again, up to
    PROFILE_TRIES_CLI runs, where the profiler dropped some); a poisoned
    train step under ``nan_check`` raises FloatingPointError; a clean
    ``--nan_check`` CLI run trains to the checkpoint bits of the same run
    without it."""
    steps = DEBUG_PARTS["train"] // CLI_BATCH
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        root, ck = os.path.join(tmp, "data"), os.path.join(tmp, "checkpoints")
        write_synthetic_dataset(root, DEBUG_PARTS, seed=SEED + 70)
        common = ["--config", CLI_CONFIG, "--dataset_path", root,
                  "--checkpoints_dir", ck, "--num_workers", "0",
                  "--batch_size", str(CLI_BATCH), "--epochs", "1"]
        want = {k: DEVICE_NAMES[k] for k in TRACED}
        for t in range(PROFILE_TRIES_CLI):
            prof = os.path.join(tmp, f"profile{t}")
            run = run_cli(common + ["--exp_name", f"profile{t}",
                                    "--profile_dir", prof], steps, 1)
            trace = os.path.join(prof, "trace.json")
            names = trace_kernels(trace)
            missing = [k for k, subs in want.items()
                       if not all(any(s in n for n in names) for s in subs)]
            out["profile"] = dict(run, tries=t + 1, trace_mb=os.path.getsize(
                trace) / 1e6, kernel_names=len(names), missing=missing)
            if not missing:
                break
        require(not missing, f"profile_dir: the trace names no kernel of "
                             f"{missing} in {PROFILE_TRIES_CLI} runs")

        model = build_model("cmflow", device=dev, seed=SEED + 71)
        step = make_train_step("cmflow", model, VOD_CAMERA_PROJECTION,
                               VOD_T_CAMERA_RADAR, nan_check=True)
        batch = make_train_batch(SEED + 72, B, 256)
        batch["pc1"] = batch["pc1"].copy()
        batch["pc1"][3, 17, 0] = np.nan
        raised = None
        with torch.autograd.set_detect_anomaly(True):
            try:
                step(create_train_state(model), batch)
            except FloatingPointError as e:
                raised = str(e)
        require(raised is not None, "nan_check: a NaN in pc1 did not raise "
                                    "FloatingPointError")
        out["poisoned_step_raised"] = raised

        runs = {}
        for name, extra in (("unchecked", []), ("checked", ["--nan_check"])):
            runs[name] = run_cli(common + ["--exp_name", name] + extra,
                                 steps, 1)
        a, b = (torch.load(os.path.join(ck, k, "models", "last"),
                           map_location="cpu", weights_only=True)["model"]
                for k in ("unchecked", "checked"))
        require(sorted(a) == sorted(b) and all(torch.equal(a[k], b[k])
                                               for k in a),
                "nan_check: the checked run's checkpoint differs from the "
                "unchecked run's")
        out["nan_check_cli"] = dict(runs=runs, same_bits=True)
    return out




def fresh_phases(card: str) -> None:
    """The PointNet++, remat and debug phases, each path's counters set to 0
    just before it and read just after, then one ``{"fresh_phases": ...}``
    line with what ``main`` needs of them.  ``main`` runs this in a process
    of its own: run in the main process after the other phases, the
    profiler recorded none of FPS's kernels in six windows running; run
    first, right after the build, they passed, but after the debug phase's
    traced CLI run the profiler recorded no whole window of a plain
    version in the kernel phase, six times running."""
    dev = torch.device("cuda")
    per_forward = {}
    t0 = time.perf_counter()
    extras, launches = extras_phase(
        dev, torch.Generator().manual_seed(SEED + 61), per_forward)
    emit(dict(extras=extras, card=card,
              extras_phase_s=time.perf_counter() - t0))
    t0 = time.perf_counter()
    remat = remat_phase(dev, make_train_batch(SEED, B, 256))
    emit(dict(remat=remat, card=card, remat_phase_s=time.perf_counter() - t0))
    t0 = time.perf_counter()
    emit(dict(debug=debug_phase(dev), card=card,
              debug_phase_s=time.perf_counter() - t0))
    emit({"fresh_phases": dict(extras_launches=launches, remat=remat,
                               fps=per_forward[("fps", "extras")])})


def shapes_process(card: str) -> None:
    """The fused kernels' shapes past the default configuration in a
    process of their own: :func:`fused_lifted_cases` (a ``lifted_fused``
    line) and :func:`shapes_phase`, then one ``{"shapes_process": ...}``
    line with the generic launches, the lifted rows and the kernels' sums
    per forward.  ``main`` runs it last: run in the main process before
    its train phases, these left its profiler dropping the first kernel of
    every later window (K7's CSR build, K6 bf16; six windows running)."""
    dev = torch.device("cuda")
    per_forward = {}
    with torch.no_grad():
        lifted = check_lifted(fused_lifted_cases(
            dev, torch.Generator().manual_seed(SEED + 68)), "lifted_fused")
        witness = deep_bf16_witness(dev, torch.Generator().manual_seed(
            SEED + 67))
    plan = chain_tc_report()
    long_plan = mse_long_report()
    generic, long_launches, full = shapes_phase(
        dev, torch.Generator().manual_seed(SEED + 69), per_forward)
    emit({"shapes_process": dict(
        card=card, generic=generic, long=long_launches, full=full,
        lifted=lifted,
        chain_tc=plan, mse_long=long_plan,
        deep_bf16_witness=witness,
        per_forward={f"{k}|{path}": acc
                     for (k, path), acc in per_forward.items()})})


def run_in_process(name: str, card: str) -> dict:
    """``chip_smoke.<name>(card)`` (:func:`fresh_phases`,
    :func:`shapes_process`) in a new process from this checkout (the
    kernels already built), its lines printed here; returns its last
    line's ``name``."""
    here = Path(__file__).resolve().parent
    proc = subprocess.run(
        [sys.executable, "-c",
         f"import chip_smoke; chip_smoke.{name}({card!r})"],
        cwd=here, capture_output=True, text=True, timeout=900)
    sys.stderr.write(proc.stderr)
    lines = proc.stdout.splitlines()
    for line in lines[:-1]:
        print(line, flush=True)
    require(proc.returncode == 0 and lines
            and lines[-1].startswith(f'{{"{name}"'),
            f"{name} in its own process failed (exit {proc.returncode})")
    return json.loads(lines[-1])[name]


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
    emit(dict(ptxas_cv=ptxas_report(libs, "cost_volume", r"cv_(p2p|agg)")))
    emit(dict(ptxas_plf=ptxas_report(libs, "plf", r"plf")))

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
        lifted = check_lifted(lifted_cases(dev, gen))
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

    # PointNet++ SSG with FPS, the train step in each remat mode and the
    # debugging switches, in a process of their own (fresh_phases)
    t0 = time.perf_counter()
    fresh = run_in_process("fresh_phases", card)
    by_path["extras"] = fresh["extras_launches"]
    per_forward[("fps", "extras")] = fresh["fps"]
    remat = fresh["remat"]
    emit(dict(fresh_phases_s=time.perf_counter() - t0))

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

    # the fused kernels past their old K and the generic kernel at other
    # widths (lifted_fused), then other backbone configurations served in
    # both dtypes; last, in a process of its own (shapes_process)
    t0 = time.perf_counter()
    shapes = run_in_process("shapes_process", card)
    shape_launches = shapes["generic"]
    shape_long = shapes["long"]
    shape_full = shapes["full"]
    lifted.update(shapes["lifted"])
    per_forward.update({tuple(key.split("|")): acc
                        for key, acc in shapes["per_forward"].items()})
    emit(dict(shapes_phase_s=time.perf_counter() - t0))

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
        counter = name if name in GATHER_ARMS else sibling
        entry["extras_launches"] = by_path["extras"][counter]
        entry["remat_launches"] = {m: r["launches"][counter]
                                   for m, r in remat["modes"].items()}
        if name == "fps":
            # the bound counts each step's arithmetic; the npoint dependent
            # steps, each an argmax over the cloud, are what limit it
            entry["limited_by"] = "npoint dependent steps, each an argmax"
        if name in lifted:  # shapes past the kernel's old limits
            entry["lifted"] = lifted[name]
        # the kernel on each route measured: per forward (per train step)
        routes = {p: a for (n, p), a in per_forward.items()
                  if n == name and p in LAUNCHES}
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
    # the generic kernel behind each wrapper, in each dtype: served by the
    # three families at config B (shapes_phase)
    for name, sibling in GENERIC.items():
        source, replaces = SOURCES[name]
        path = "shapes_B_bf16" if name in GENERIC_BF16_ARMS else "shapes_B"
        require((name, path) in per_forward,
                f"{name}: no case on its route {path}")
        acc = per_forward[(name, path)]
        entry = dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=shape_launches[path][sibling],
            max_abs_err=acc["max_abs_err"], ms=acc["ms"],
            plain_ms=acc["plain_ms"],
            **bounds(name, acc["nbytes"], acc["flops"]),
            library_ms=acc["library_ms"] if acc["has_library"] else None,
            path=path)
        entry.update(shares(entry, acc["ms"]))
        if acc["cublas_products_ms"]:
            entry["cublas_products_ms"] = acc["cublas_products_ms"]
        if name in lifted:
            entry["lifted"] = lifted[name]
        kernels.append(entry)
    # K3's long kernel in each dtype: served at config A (shapes_phase)
    for name in LONG_ARMS:
        source, replaces = SOURCES[name]
        path = "shapes_A_bf16" if name in LONG_BF16_ARMS else "shapes_A"
        require((name, path) in per_forward,
                f"{name}: no case on its route {path}")
        acc = per_forward[(name, path)]
        entry = dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=shape_long[path], max_abs_err=acc["max_abs_err"],
            ms=acc["ms"], plain_ms=acc["plain_ms"],
            **bounds(name, acc["nbytes"], acc["flops"]),
            library_ms=acc["library_ms"] if acc["has_library"] else None,
            path=path, cublas_products_ms=acc["cublas_products_ms"])
        entry.update(shares(entry, acc["ms"]))
        if name in sass:
            entry["sass"] = sass[name]
        if name in lifted:
            entry["lifted"] = lifted[name]
        kernels.append(entry)
    # the bf16 full-tile arms: served at config C (shapes_phase)
    for name in FULL_BF16_ARMS:
        source, replaces = SOURCES[name]
        path = "shapes_C_bf16"
        require((name, path) in per_forward,
                f"{name}: no case on its route {path}")
        acc = per_forward[(name, path)]
        entry = dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=shape_full[path][name], max_abs_err=acc["max_abs_err"],
            ms=acc["ms"], plain_ms=acc["plain_ms"],
            **bounds(name, acc["nbytes"], acc["flops"]),
            library_ms=acc["library_ms"] if acc["has_library"] else None,
            path=path, cublas_products_ms=acc["cublas_products_ms"])
        entry.update(shares(entry, acc["ms"]))
        entry["sass"] = sass[f"{FULL_BF16_ARMS[name]}.bf16"]
        if name in lifted:
            entry["lifted"] = lifted[name]
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
