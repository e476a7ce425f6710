#!/usr/bin/env python3
"""The hand-written kernels off the routes' timing, one at a time, on one
GPU: the tensor-core kernels K5 (``csrc/plf.cu``), K4a
(``csrc/cost_volume.cu::cv_p2p_kernel``) and K3 (``csrc/mse.cu``) across
neighbour counts, then the neighbour kernels K1 and K2 and the gather's
backward K7 at the train step's shapes.

    python scripts/profile_torch_tc.py [TREE]

``TREE`` is the root of a checkout whose ``cmflow_tpu_torch`` is imported
and built (default: this script's own), so that one machine can time two
versions of the kernels in turns, e.g. a parent commit unpacked beside the
repository: ``parent, this, this, parent``.  The wrappers' signatures are
the same in both.

At B=16, N=256, with seeded full-width weights and random features:
- K5 at k in {1, 3, 4, 8, 16, 32, 33, 64} and K4a at k in {1, 5, 8, 32},
  on random neighbour indices (some outside [0, N), which gather a zero
  row): the kernel's own device time, cuBLAS float32 on the same products
  alone, and the bound of its arithmetic in 3xTF32 at 495 TFLOP/s;
- K3 on the ball-query indices of a random 20 m cloud, all four scales
  (K = 4, 8, 16, 32) in one launch as the fused route calls it, then each
  scale alone: the kernel's own device time and its wrapper's (every kernel
  the call launches), beside the bounds of its arithmetic in float32 at 67
  TFLOP/s and in 3xTF32 at 495;
- K4b (``csrc/cost_volume.cu::cv_agg_kernel``) at N=256 and at the padded
  N=384 bucket, k=8, on masked kNN indices of a random cloud, as the fused
  route calls it: the kernel's own device time beside its bound (bytes at
  3.35 TB/s, operations at 67 TFLOP/s, as ``chip_smoke.py`` counts them).
On one synthetic train batch (``make_train_batch``, B=16, N=256), as
``chip_smoke.py`` takes it:
- K7 at the train step's 15 shapes (sa encoder C=32 and propagation encoder
  C=512 on the ball query's indices at K = 4, 8, 16, 32; the cost volume's
  C=512 on kNN indices; the smoothness loss's C=3), seeded random
  cotangents, then its bf16 arm at the 14 of them a bf16 step gives it
  bf16 cotangents (all but C=3): every kernel the wrapper launches, each
  of them (the CSR build, the sum, and in older trees the combine), and
  ``index_add_`` in float32 on the same rows (for bf16 with a cast each
  way), a yardstick the port never calls; summed per train step with the
  launches per step;
- K1 one radius per launch, as the train step calls it (r = 2, 4, 8, 16,
  K = 4, 8, 16, 32 on pc1), and all four radii in one launch, as the fused
  route calls it; K2 at k=8, pc1 -> pc2 and pc1 -> pc1.
Then the bf16 arms of K5 at k in {1, 3, 4, 8, 16, 32, 33, 64, 65, 128} and
of K4a at k in {1, 5, 8, 32, 33, 64}, on random indices as above, with
bf16 features and seeded weights rounded to bf16: the kernel's own device
time, cuBLAS bf16 on the same products alone (``torch.mm`` with float32
sums, as ``_dot32`` calls it) and the bound of the products at the dense
bf16 peak of 989 TFLOP/s; within 1e-2 of the output's largest magnitude;
and K3's bf16 arm at K = 4, 8, 16, 32 (its kernel and its whole call).
A tree whose wrapper refuses a k (older trees' bf16 arms took K5 k <= 64
and K4a k <= 32) gets a ``refused`` line for it.
Each case also gives the kernel's max abs error against its plain version
and the output's largest magnitude (exact for K1 and K2; K3-K5 within 1e-4
and 1e-5 of it; K7 within 1e-5 of it, its bf16 arm within a bf16 ulp);
the tensor-core kernels and K7 also whether two launches give the same
bits, and K3-K5 and both arms of K7 a digest of the output's bits, so
that two trees' outputs on the same inputs can be compared.  Device times from
``torch.profiler`` over 20 warmed calls, each window checked for every
launch (see :func:`device_ms`).  One JSON line per case, then the sums.
Needs a CUDA device; exits with code 1 without one.
"""

from __future__ import annotations

import hashlib
import json
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

TREE = Path(sys.argv[1] if len(sys.argv) > 1
            else Path(__file__).resolve().parents[1]).resolve()
sys.path.insert(0, str(TREE))

from cmflow_tpu_torch.data.synthetic import make_train_batch  # noqa: E402
from cmflow_tpu_torch.nn import blocks  # noqa: E402
from cmflow_tpu_torch.ops import fused, neighbors  # noqa: E402

B, N = 16, 256
ITERS = 20
PROFILE_TRIES = 6  # windows traced before device_ms gives up
SENTINEL = "spin_kernel"  # torch.cuda._sleep's kernel
TF32_FLOP_PER_S = 495e12
BF16_FLOP_PER_S = 989e12
BF16 = torch.bfloat16
F32_FLOP_PER_S = 67e12
HBM_BYTES_PER_S = 3.35e12
RADII, KS = (2.0, 4.0, 8.0, 16.0), (4, 8, 16, 32)
# K7's kernels (the combine only in trees before its fold into the sum)
K7_PARTS = ("csr_kernel", "sum_kernel", "combine_kernel")


def seeded(module, seed: int, dev):
    gen = torch.Generator().manual_seed(seed)
    blocks.init_parameters(module, gen)
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, blocks.BatchNorm):
                m.weight.uniform_(0.7, 1.3, generator=gen)
                m.bias.uniform_(-0.2, 0.2, generator=gen)
                m.running_mean.uniform_(-0.1, 0.1, generator=gen)
                m.running_var.uniform_(0.5, 2.0, generator=gen)
    return module.to(dev)


def device_ms(fn, kernel: str = "", wrapper=None, parts=()) -> tuple:
    """(summed durations of the kernels of one ``fn()`` whose names hold
    ``kernel``, of all its kernels), over ``ITERS`` warmed calls; with
    ``parts``, a third item: {each of ``parts``: the durations of the
    kernels whose names hold it}.

    The profiler now and then records only part of a window's kernels, or
    none; it drops the first most often, so each window starts with a
    throwaway kernel.  A window counts only if it recorded every kernel a
    multiple of ``ITERS`` times and, given the ``wrapper`` whose launch
    counter ``fn`` moves, each kernel whose name holds ``kernel`` ``ITERS``
    times per launch of a call (and at least one such).  A rejected window
    is printed to stderr and traced again after a pause that doubles, up
    to ``PROFILE_TRIES`` windows; then this raises."""
    for _ in range(3):
        fn()
    per_call = 0
    if wrapper is not None:
        before = wrapper.launches
        fn()
        per_call = wrapper.launches - before
    torch.cuda.synchronize()
    for t in range(PROFILE_TRIES):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                # the profiler often drops a window's first kernel: let it
                # be this one, which is left out below
                torch.cuda._sleep(1)
                torch.cuda.synchronize()
                for _ in range(ITERS):
                    fn()
                torch.cuda.synchronize()
            events = [e for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA
                      and SENTINEL not in e.key]
        named = [e for e in events if kernel in e.key]
        whole = bool(named) and all(e.count % ITERS == 0 for e in events)
        if per_call:
            whole = whole and all(e.count == ITERS * per_call for e in named)
        if whole:
            own = sum(e.self_device_time_total for e in named)
            total = sum(e.self_device_time_total for e in events)
            if not parts:
                return own / 1e3 / ITERS, total / 1e3 / ITERS
            return own / 1e3 / ITERS, total / 1e3 / ITERS, {
                k: sum(e.self_device_time_total for e in named if k in e.key)
                / 1e3 / ITERS for k in parts}
        print(json.dumps(dict(profiler_window_rejected=dict(
            kernel=kernel, per_call=per_call, window=t,
            counts={e.key[:80]: e.count for e in events}))),
            file=sys.stderr, flush=True)
        time.sleep(0.1 * 2 ** t)
    raise RuntimeError(f"the profiler recorded no whole window of "
                       f"{kernel!r} in {PROFILE_TRIES} tries")


def checks(run, plain) -> dict:
    """The kernel against its plain version, against itself, and a digest
    of its output's bits, to compare two trees on the same inputs."""
    got, again, want = run(), run(), plain()
    torch.cuda.synchronize()
    bits = got.cpu()
    if bits.dtype == torch.bfloat16:  # numpy has no bf16
        bits = bits.view(torch.int16)
    return dict(max_abs_err=float((got.double() - want.double()).abs().max()),
                plain_max_abs=float(want.abs().max()),
                same_bits=bool(torch.equal(got, again)),
                digest=hashlib.sha1(bits.numpy().tobytes()).hexdigest())


def case(name, k, run, plain, widths, kernel, wrapper, dev):
    rows = B * N * k
    xs = [torch.randn((rows, c), device=dev) for c in widths[:-1]]
    ws = [torch.randn((c, o), device=dev)
          for c, o in zip(widths[:-1], widths[1:])]
    flops = 2 * rows * sum(c * o for c, o in zip(widths[:-1], widths[1:]))
    print(json.dumps(dict(
        kernel=name, k=k, **checks(run, plain),
        kernel_ms=device_ms(run, kernel, wrapper)[0],
        cublas_products_ms=device_ms(
            lambda: [x @ w for x, w in zip(xs, ws)])[1],
        bound_3xtf32_ms=1e3 * 3 * flops / TF32_FLOP_PER_S)), flush=True)


def bf16_case(name, k, run, plain, widths, kernel, wrapper, dev):
    """A bf16 arm at one k beside cuBLAS bf16 on its products alone."""
    rows = B * N * k
    xs = [torch.randn((rows, c), device=dev).to(BF16) for c in widths[:-1]]
    ws = [torch.randn((c, o), device=dev).to(BF16)
          for c, o in zip(widths[:-1], widths[1:])]
    flops = 2 * rows * sum(c * o for c, o in zip(widths[:-1], widths[1:]))
    try:
        checked = checks(run, plain)
    except ValueError as e:  # the wrapper refuses this k
        print(json.dumps(dict(kernel=name, k=k, refused=str(e))), flush=True)
        return
    print(json.dumps(dict(
        kernel=name, k=k, **checked,
        kernel_ms=device_ms(run, kernel, wrapper)[0],
        cublas_bf16_products_ms=device_ms(
            lambda: [torch.mm(x, w, out_dtype=torch.float32)
                     for x, w in zip(xs, ws)])[1],
        bound_bf16_ms=1e3 * flops / BF16_FLOP_PER_S)), flush=True)


def bf16_cases(dev) -> None:
    """K5's and K4a's bf16 arms across k; K3's at the fused route's K."""
    rs = np.random.RandomState(12)

    def randn(*shape):
        return torch.from_numpy(rs.randn(*shape).astype(np.float32)).to(dev)

    pc = torch.from_numpy((rs.rand(B, N, 3) * 20).astype(np.float32)).to(dev)
    f1, f2 = randn(B, N, 512).to(BF16), randn(B, N, 512).to(BF16)
    z1, z2 = randn(B, N, 8), randn(B, N, 8)
    plf = seeded(blocks.PointLocalFeature(4.0, 8, 1027, (512, 256, 64),
                                          (64, 64, 64)), 2, dev)
    chain, _, _ = fused.plf_params_from_variables(plf)
    chain = [t.to(BF16) if i % 3 == 0 else t for i, t in enumerate(chain)]
    for k in (1, 3, 4, 8, 16, 32, 33, 64, 65, 128):
        idx = torch.from_numpy(rs.randint(-1, N, (B, N, k)).astype(
            np.int32)).to(dev)
        bf16_case("plf.bf16", k,
                  lambda: fused.fused_point_local_feature(f1, idx, pc, chain),
                  lambda: fused.fused_point_local_feature_plain(f1, idx, pc,
                                                                chain),
                  fused.PLF_WIDTHS, "plf_bf16_kernel",
                  fused.fused_point_local_feature, dev)
    fc = seeded(blocks.FeatureCorrelator(8, 512, 512, (512, 512, 512)),
                3, dev)
    dense, wn1, _ = fused.cv_params_from_variables(fc)
    dense = [t.to(BF16) if i % 2 == 0 else t for i, t in enumerate(dense)]
    for k in (1, 5, 8, 32, 33, 64):
        idx = torch.from_numpy(rs.randint(-1, N, (B, N, k)).astype(
            np.int32)).to(dev)
        args = (f1, f2, idx, z1, z2, dense[1:], wn1[1:])
        bf16_case("cv.bf16", k, lambda: fused.cost_volume_p2p(*args),
                  lambda: fused.cost_volume_p2p_plain(*args), (512,) * 3,
                  "cv_p2p_bf16_kernel", fused.cost_volume_p2p, dev)
    # K3's bf16 arm, all four scales on the ball query's indices, as the
    # fused route calls it: the kernel, the whole call, and the digest
    mse = seeded(blocks.MultiScaleEncoder(RADII, KS, 3, (32, 32, 64),
                                          (64, 64, 64)), 1, dev)
    packed, _ = fused.mse_narrow_params_from_variables(mse, BF16)
    feats = randn(B, 3, N).to(BF16).transpose(1, 2)  # strided, as collated
    idx = list(neighbors.ball_query_multi(RADII, KS, pc, pc))
    run = lambda: fused.fused_multi_scale_encoder(  # noqa: E731
        feats, idx, pc, packed)
    plain = lambda: fused.fused_multi_scale_encoder_plain(  # noqa: E731
        feats, idx, pc, packed)
    own, call = device_ms(run, "mse_bf16_kernel",
                          fused.fused_multi_scale_encoder)
    print(json.dumps(dict(kernel="mse.bf16", k=list(KS), **checks(run, plain),
                          kernel_ms=own, call_ms=call)), flush=True)


def mse_case(ks, run, plain):
    c1, c2, c3 = fused.MSE_WIDTHS
    # the first layer per point (3 + 3 inputs) and the query's offset, then
    # the chain per (query, neighbour) row, as chip_smoke.py counts it
    flops = 2 * B * N * (len(ks) * c1 * 9 + sum(ks) * (c1 * c2 + c2 * c3))
    own, wrapper = device_ms(run, "mse_kernel",
                             fused.fused_multi_scale_encoder)
    print(json.dumps(dict(
        kernel="mse", k=list(ks), **checks(run, plain), kernel_ms=own,
        wrapper_device_ms=wrapper,
        bound_f32_ms=1e3 * flops / F32_FLOP_PER_S,
        bound_3xtf32_ms=1e3 * 3 * flops / TF32_FLOP_PER_S)), flush=True)


def cv_agg_cases(dev) -> None:
    """K4b at the fused route's two buckets, k=8."""
    rs = np.random.RandomState(7)
    c, h, k = fused.CV_WIDTH, fused.WEIGHTNET_HIDDEN, 8
    fc = seeded(blocks.FeatureCorrelator(8, 512, 512, (512, 512, 512)),
                3, dev)
    _, _, wn2 = fused.cv_params_from_variables(fc)
    wn = wn2[1:]
    for n in (256, 384):
        pc = torch.from_numpy((rs.rand(B, n, 3) * 20).astype(
            np.float32)).to(dev)
        valid = torch.from_numpy(rs.rand(B, n) > 0.2).to(dev)
        idx = neighbors.knn(k, pc, pc, valid)
        p2p = torch.from_numpy(rs.randn(B, n, c).astype(np.float32)).to(dev)
        zq = torch.from_numpy(rs.randn(B, n, h).astype(np.float32)).to(dev)
        rows = B * n
        nbytes = 4 * (rows * (2 * c + k + h) + sum(t.numel() for t in wn))
        flops = 2 * rows * k * (h * h + h * c + c)
        bound = 1e3 * max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOP_PER_S)
        run = lambda: fused.cost_volume_agg(p2p, idx, zq, wn)  # noqa: E731
        ms = device_ms(run, "cv_agg_kernel", fused.cost_volume_agg)[0]
        print(json.dumps(dict(
            kernel="K4b", shape=f"B={B} N={n} k={k} masked", ms=ms,
            bound_ms=bound, share_of_bound=bound / ms,
            **checks(run, lambda: fused.cost_volume_agg_plain(
                p2p, idx, zq, wn)))), flush=True)


def err(got, want) -> float:
    if isinstance(got, tuple):
        return max(err(a, b) for a, b in zip(got, want))
    return float((got.double() - want.double()).abs().max())


def k7_shapes(pc1, pc2) -> list:
    """K7's calls in a train step: (C, indices [B, S, K], calls a step,
    what), on one batch's own neighbours."""
    ball = [neighbors.ball_query_multi((r,), (k,), pc1, pc1)[0]
            for r, k in zip(RADII, KS)]
    smooth = torch.sort(neighbors.square_distance(pc1, pc1), dim=-1,
                        stable=True).indices[..., 1:9].to(torch.int32)
    shapes = [(32, ball[i], 2, f"sa encoder K={k}") for i, k in enumerate(KS)]
    shapes += [(512, ball[i], 1, f"propagation encoder K={k}")
               for i, k in enumerate(KS)]
    return shapes + [
        (512, neighbors.knn(8, pc1, pc2), 1, "cost volume pc1->pc2"),
        (512, neighbors.knn(8, pc1, pc1), 1, "cost volume pc1->pc1"),
        (3, smooth, 1, "smoothness loss")]


def train_batch_cases(dev) -> None:
    """K7, K1 and K2 at the train step's shapes; then their sums per train
    step."""
    batch = make_train_batch(0, B, N)
    pc1 = torch.as_tensor(batch["pc1"], device=dev)
    pc2 = torch.as_tensor(batch["pc2"], device=dev)
    gen = torch.Generator().manual_seed(0)
    sums = {"K1 train": 0.0}

    shapes = k7_shapes(pc1, pc2)
    for dtype in (torch.float32, BF16):
        arm = "K7" if dtype == torch.float32 else "K7 bf16"
        for c, idx, mult, what in shapes:
            if dtype == BF16 and c == 3:  # the smoothness loss: float32
                continue
            flat = idx.reshape(B, -1).contiguous()
            m = flat.shape[1]
            g = torch.randn((B, m, c), generator=gen).to(dev).to(dtype)
            rows = (flat.long() + N * torch.arange(B, device=dev)[:, None]
                    ).reshape(-1)
            g_rows = g.reshape(B * m, c)
            run = lambda: fused.gather_rows_backward(g, flat, N)  # noqa: E731
            ms, _, parts = device_ms(run, "gather_rows_backward",
                                     fused.gather_rows_backward, K7_PARTS)
            # index_add_ in float32, and for bf16 one cast each way
            lib = device_ms(lambda: torch.zeros((B * N, c), device=dev)
                            .index_add_(0, rows, g_rows.float()).to(dtype))[1]
            for name, t in parts.items():
                sums[f"{arm} {name}"] = sums.get(f"{arm} {name}", 0.0) + (
                    mult * t)
            sums[arm] = sums.get(arm, 0.0) + mult * ms
            sums[f"{arm} index_add_"] = sums.get(f"{arm} index_add_",
                                                 0.0) + mult * lib
            print(json.dumps(dict(
                kernel=arm, shape=f"M={m} C={c} ({what})",
                launches_per_step=mult, ms=ms, parts_ms=parts,
                index_add_ms=lib,
                **checks(run, lambda: fused.gather_rows_backward_plain(
                    g, flat, N)))), flush=True)
    for r, k in zip(RADII, KS):
        run = lambda r=r, k=k: neighbors.ball_query_multi(  # noqa: E731
            (r,), (k,), pc1, pc1)
        ms = device_ms(run, "ball_query_kernel",
                       neighbors.ball_query_multi)[0]
        sums["K1 train"] += 3 * ms  # sa encoder on pc1 and pc2, propagation
        print(json.dumps(dict(
            kernel="K1", shape=f"r={r} K={k}", launches_per_step=3, ms=ms,
            max_abs_err=err(run(), neighbors.ball_query_multi_plain(
                (r,), (k,), pc1, pc1)))), flush=True)
    run = lambda: neighbors.ball_query_multi(RADII, KS, pc1, pc1)  # noqa: E731
    print(json.dumps(dict(
        kernel="K1", shape=f"all radii K={KS}",
        ms=device_ms(run, "ball_query_kernel", neighbors.ball_query_multi)[0],
        max_abs_err=err(run(), neighbors.ball_query_multi_plain(
            RADII, KS, pc1, pc1)))), flush=True)
    for name, pts in (("pc1->pc2", pc2), ("pc1->pc1", pc1)):
        run = lambda pts=pts: neighbors.knn(8, pc1, pts)  # noqa: E731
        print(json.dumps(dict(
            kernel="K2", shape=f"k=8 {name}",
            ms=device_ms(run, "knn_kernel", neighbors.knn)[0],
            max_abs_err=err(run(), neighbors.knn_plain(8, pc1, pts)))),
            flush=True)
    print(json.dumps(dict(tree=str(TREE), per_train_step_ms=sums)),
          flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip(),
        flush=True)
    print(json.dumps(dict(tree=str(TREE), package=fused.__file__)),
          flush=True)
    dev = torch.device("cuda")
    rs = np.random.RandomState(0)

    def randn(*shape):
        return torch.from_numpy(rs.randn(*shape).astype(np.float32)).to(dev)

    pc = torch.from_numpy((rs.rand(B, N, 3) * 20).astype(np.float32)).to(dev)
    f1, f2, z1, z2 = randn(B, N, 512), randn(B, N, 512), randn(B, N, 8), \
        randn(B, N, 8)
    with torch.no_grad():
        plf = seeded(blocks.PointLocalFeature(4.0, 8, 1027, (512, 256, 64),
                                              (64, 64, 64)), 2, dev)
        chain, _, _ = fused.plf_params_from_variables(plf)
        for k in (1, 3, 4, 8, 16, 32, 33, 64):
            idx = torch.from_numpy(rs.randint(-1, N, (B, N, k)).astype(
                np.int32)).to(dev)
            case("plf", k,
                 lambda: fused.fused_point_local_feature(f1, idx, pc, chain),
                 lambda: fused.fused_point_local_feature_plain(f1, idx, pc,
                                                               chain),
                 fused.PLF_WIDTHS, "plf_kernel",
                 fused.fused_point_local_feature, dev)
        fc = seeded(blocks.FeatureCorrelator(8, 512, 512, (512, 512, 512)),
                    3, dev)
        dense, wn1, _ = fused.cv_params_from_variables(fc)
        for k in (1, 5, 8, 32):
            idx = torch.from_numpy(rs.randint(-1, N, (B, N, k)).astype(
                np.int32)).to(dev)
            args = (f1, f2, idx, z1, z2, dense[1:], wn1[1:])
            case("cv", k, lambda: fused.cost_volume_p2p(*args),
                 lambda: fused.cost_volume_p2p_plain(*args), (512,) * 3,
                 "cv_p2p_kernel", fused.cost_volume_p2p, dev)

        mse = seeded(blocks.MultiScaleEncoder(RADII, KS, 3, (32, 32, 64),
                                              (64, 64, 64)), 1, dev)
        packed, _ = fused.mse_narrow_params_from_variables(mse)
        feats = randn(B, 3, N).transpose(1, 2)  # strided, as collated
        idx = list(neighbors.ball_query_multi(RADII, KS, pc, pc))
        mse_case(KS, lambda: fused.fused_multi_scale_encoder(
                     feats, idx, pc, packed),
                 lambda: fused.fused_multi_scale_encoder_plain(
                     feats, idx, pc, packed))
        for s, k in enumerate(KS):
            one = (packed[0][s:s + 1], packed[1][s:s + 1]) + tuple(
                p.reshape(len(KS), -1)[s] if p.dim() == 1 else p[s:s + 1]
                for p in packed[2:])
            sub = idx[s:s + 1]
            mse_case((k,), lambda one=one, sub=sub:
                     fused.fused_multi_scale_encoder(feats, sub, pc, one),
                     lambda one=one, sub=sub:
                     fused.fused_multi_scale_encoder_plain(feats, sub, pc,
                                                           one))
        cv_agg_cases(dev)
    train_batch_cases(dev)
    with torch.no_grad():
        bf16_cases(dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
