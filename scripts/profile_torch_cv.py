#!/usr/bin/env python3
"""Device time of the cost volume's two kernels (``csrc/cost_volume.cu``) on
one GPU at the shapes their last redesign took, beside cuBLAS.

    python scripts/profile_torch_cv.py [TREE] [REPEATS] [bf16]
    python scripts/profile_torch_cv.py ablate [REPEATS [VARIANT,...]]

``TREE`` is the root of a checkout whose ``cmflow_tpu_torch`` is imported
and built (default: this script's own), so that one call can time two
versions in turns, e.g. the parent commit unpacked with ``git archive``
into ``build/parent``::

    for t in build/parent . . build/parent; do
        python scripts/profile_torch_cv.py $t; done

It calls only ``cost_volume_p2p``, ``cost_volume_agg``,
``fused_point_local_feature`` and their plain versions, whose signatures
every tree since the generic arms shares.  At
B=16, N=256, seeded weights (``FeatureCorrelator``) and random neighbours
(some outside [0, N)), the same in every tree:

- K4a float32 at k = 5, 8, 33, 48, 64, 65, 100 and 130 (the full-tile arm
  at every k that does not divide 64; 8 and 64 keep their arm), and the
  bf16 arm at k = 5, 7, 8, 12, 16, 24, 33, 48, 64, 65, 100 and 130: its
  kernel's device time, the whole call's (the per-call weight split),
  cuBLAS on its two 512x512 products at k rows a query (float32, or bf16
  operands with float32 sums), and the bound of its arithmetic (3xTF32 at
  495 TFLOP/s, bf16 at 989);
- K5 bf16 (the default widths, 512 -> 256 -> 64) at K = 4, 8, 16, 24, 32,
  33, 48, 65, 100, 128, 160 and 200, the same figures (cuBLAS on its two
  products);
- K4b at C = 100, 512, 768 and 826, k = 16, p2p in float32 and bf16 (the
  tuned kernel at 512, the generic arm elsewhere; ``chip_smoke.py``'s
  ``lifted_fused`` and config B's ``shapes`` rows): its kernel's time,
  cuBLAS on the WeightNet's two products alone, and the larger of its
  bytes at 3.35 TB/s and its float32 operations at 67 TFLOP/s.

``bf16`` (after ``TREE``) times only the two bf16 lists.  Each case
gives the max abs error against the plain version, the plain output's
largest magnitude, whether two calls give the same bits, and a digest of
the output's bits (equal between trees where the kernels sum in
the same order).  Device times from ``torch.profiler`` over REPEATS warmed
calls (default 20), a window counted only if it recorded the kernel once
a call (``profile_torch_mse.device_ms``).  One JSON line per case, then
the card's name and power limit.

``ablate`` builds copies of this tree's ``csrc/cost_volume.cu`` (into
``build/cv_variants/``) and times K4a's full-tile cases with each:
``package`` (as built), ``x0_direct`` (x0's rows loaded where they are
used, not staged ahead), ``no_mma`` (the products left out, their operands
kept live) and ``timeline`` (block 0's thread 0 stamps its cycle counter
at each tile's start and after each of its phases; after a call at k = 48
it prints the median cycles between marks).  ``arms``: float32 K4a at
every k of ``ARM_K`` (below 64) on both arms called directly, the
full-tile arm and the tile of whole queries, whichever the wrapper would
take, with the share of a tile of whole queries that holds rows.  Then
``agg_chunks``: K4b's any-C cases at C = 768 and 826 with other chunks of
the row forced on the plan (cells of four channels a block, queries a
thread), timed by replays of a CUDA graph of ten calls.  The bf16
full-tile arms (K4a at k = 33, 48, 100, K5 at K = 48, 65, 160) with copies
of ``cost_volume.cu`` and ``plf.cu``: ``bf16_package`` (as built),
``bf16_no_mma`` (the products left out), ``bf16_timeline`` (a tile's
cycle timeline at K4a k=48 and K5 K=65: marks at its start, after its
first product, after its second (K5: x2 stored), after its sums or max)
and ``bf16_cluster1`` (K4a's bf16 kernel in clusters of one, no multicast).
``bf16_arms``: K4a bf16 and K5 bf16 at every K of the lists above in
full tiles (the wrappers' plans) and in tiles of whole queries (the plans
replaced), which put every K on full tiles.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
# its timing helpers; it takes the same arguments and imports TREE's package
import profile_torch_mse as pm  # noqa: E402

from cmflow_tpu_torch.native import build  # noqa: E402
from cmflow_tpu_torch.nn import blocks  # noqa: E402
from cmflow_tpu_torch.ops import fused  # noqa: E402

TREE = pm.TREE
B, N, H = 16, 256, 8
C = 512
P2P_K = (5, 8, 33, 48, 64, 65, 100, 130)
P2P_BF16_K = (5, 7, 8, 12, 16, 24, 33, 48, 64, 65, 100, 130)
# K5 (csrc/plf.cu) in bf16 at the default widths
PLF_WIDTHS = (512, 256, 64)
PLF_BF16_K = (4, 8, 16, 24, 32, 33, 48, 65, 100, 128, 160, 200)
AGG_C = (100, 512, 768, 826)
AGG_K = 16
BF16 = torch.bfloat16
HBM = 3.35e12
PEAK = {torch.float32: 495e12 / 3, BF16: 989e12}  # 3xTF32: three passes
F32_PEAK = 67e12
# K4a's kernel in any tree: the whole-query or, where a tree has it, the
# full-tile arm
P2P_KERNEL = {torch.float32: "cv_p2p(?:_full)?_kernel",
              BF16: "cv_p2p_bf16_kernel"}
# K5's bf16 kernel, on either plan
PLF_KERNEL = {BF16: "plf_bf16_kernel"}
# K4b's kernel in any tree: the tuned one at 512, else the any-C kernel or,
# before it, the generic chain kernel
AGG_KERNEL = ("(?:cv_agg_kernel|cv_agg_bf16_kernel|cv_agg_any_kernel"
              "|chain_kernel)")
# the ablation copies: {source: its build switches} of each variant
FLAGS = {"x0_direct": {"cost_volume": ["-DCV_P2P_X0_DIRECT"]},
         "no_mma": {"cost_volume": ["-DCV_P2P_NO_MMA"]},
         "timeline": {"cost_volume": ["-DCV_P2P_TIMELINE"]},
         "bf16_no_mma": {"cost_volume": ["-DCV_P2P_NO_MMA"],
                         "plf": ["-DPLF_BF16_NO_MMA"]},
         "bf16_timeline": {"cost_volume": ["-DCV_P2P_TIMELINE"],
                           "plf": ["-DPLF_BF16_TIMELINE"]},
         "bf16_cluster1": {"cost_volume": ["-DCV_P2P_BF16_CLUSTER=1"]}}
VARIANTS = ("package", "x0_direct", "no_mma", "timeline", "arms",
            "agg_chunks", "bf16_package", "bf16_no_mma", "bf16_timeline",
            "bf16_cluster1", "bf16_arms")
# the bf16 full-tile cases the bf16 variants time: K4a's k, K5's K
BF16_ABLATE_K = {"cv": (33, 48, 100), "plf": (48, 65, 160)}
# the k below 64 that ``arms`` times on both K4a arms: on either side of
# the wrapper's choice
ARM_K = (5, 7, 9, 10, 11, 12, 13, 14, 15, 17, 20, 21, 24, 28, 31, 33, 48,
         56, 60)
# K4b chunks forced on the plan in the ablation: (cells, queries a thread)
AGG_CHUNKS = ((64, 4), (64, 5), (64, 6), (64, 7), (64, 8), (128, 6),
              (128, 8), (32, 6), (32, 8), (52, 6), (52, 8), (207, 6),
              (207, 8))
AGG_ABLATE_C = (768, 826)


def seeded(module, dev, seed):
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


def rand(rs, dev, *shape, dtype=torch.float32):
    return torch.from_numpy(rs.randn(*shape).astype(np.float32)).to(dev).to(
        dtype)


def indices(rs, dev, k):
    return torch.from_numpy(rs.randint(-2, N + 2, (B, N, k)).astype(
        np.int32)).to(dev)


def products(dev, rows, widths, dtype):
    """cuBLAS on a chain's products alone at ``rows`` rows."""
    xs = [torch.randn((rows, c), device=dev).to(dtype) for c in widths[:-1]]
    ws = [torch.randn((c, o), device=dev).to(dtype)
          for c, o in zip(widths[:-1], widths[1:])]
    if dtype == BF16:
        return lambda: [torch.mm(x, w, out_dtype=torch.float32)
                        for x, w in zip(xs, ws)]
    return lambda: [x @ w for x, w in zip(xs, ws)]


def p2p_cases(dev, dtype, ks):
    """(name, k, call, plain, cuBLAS, bound ms, kernel) of K4a."""
    out = []
    for k in ks:
        rs = np.random.RandomState(200 + k)
        fc = seeded(blocks.FeatureCorrelator(k, C, C, (C, C, C)), dev, 5)
        with torch.no_grad():
            dense, wn1, _ = fused.cv_params_from_variables(fc)
        dense = [t.to(dtype) if i % 2 == 0 else t
                 for i, t in enumerate(dense)]
        args = (rand(rs, dev, B, N, C, dtype=dtype),
                rand(rs, dev, B, N, C, dtype=dtype), indices(rs, dev, k),
                rand(rs, dev, B, N, H), rand(rs, dev, B, N, H), dense[1:],
                wn1[1:])
        rows = B * N * k
        flops = 2 * rows * (2 * C * C + H * H + H * C)
        out.append((f"cv k={k}", k,
                    lambda a=args: fused.cost_volume_p2p(*a),
                    lambda a=args: fused.cost_volume_p2p_plain(*a),
                    products(dev, rows, (C, C, C), dtype),
                    1e3 * flops / PEAK[dtype], P2P_KERNEL[dtype]))
    return out


def plf_cases(dev, dtype, ks):
    """(name, K, call, plain, cuBLAS, bound ms, kernel) of K5."""
    out = []
    c1, c2, c3 = PLF_WIDTHS
    for k in ks:
        rs = np.random.RandomState(400 + k)
        plf = seeded(blocks.PointLocalFeature(8.0, k, 40, PLF_WIDTHS, (16,)),
                     dev, 7)
        with torch.no_grad():
            chain = fused.plf_params_from_variables(plf)[0]
        chain = [t.to(dtype) if i % 3 == 0 else t
                 for i, t in enumerate(chain)]
        pc = torch.from_numpy((20.0 * rs.rand(B, N, 3)).astype(
            np.float32)).to(dev)
        args = (rand(rs, dev, B, N, c1, dtype=dtype), indices(rs, dev, k),
                pc, chain)
        rows = B * N * k
        flops = 2 * B * N * c1 * 6 + 2 * rows * (c1 * c2 + c2 * c3)
        out.append((f"plf K={k}", k,
                    lambda a=args: fused.fused_point_local_feature(*a),
                    lambda a=args: fused.fused_point_local_feature_plain(*a),
                    products(dev, rows, PLF_WIDTHS, dtype),
                    1e3 * flops / PEAK[dtype], PLF_KERNEL[dtype]))
    return out


def agg_cases(dev, dtype):
    """(name, C, call, plain, cuBLAS, bound ms, kernel) of K4b."""
    out = []
    for c in AGG_C:
        rs = np.random.RandomState(300 + c)
        fc = seeded(blocks.FeatureCorrelator(AGG_K, c, c, (c, c, c)), dev, 6)
        with torch.no_grad():
            wn = fused.cv_params_from_variables(fc)[2][1:]
        args = (rand(rs, dev, B, N, c, dtype=dtype), indices(rs, dev, AGG_K),
                rand(rs, dev, B, N, H), wn)
        rows = B * N * AGG_K
        flops = 2 * rows * (H * H + H * c + c)
        nbytes = (sum(t.numel() * t.element_size() for t in args[:3])
                  + B * N * c * 4)
        out.append((f"cv_agg C={c} k={AGG_K}", c,
                    lambda a=args: fused.cost_volume_agg(*a),
                    lambda a=args: fused.cost_volume_agg_plain(*a),
                    products(dev, rows, (H, H, c), torch.float32),
                    1e3 * max(nbytes / HBM, flops / F32_PEAK), AGG_KERNEL))
    return out


def digest(x: torch.Tensor) -> str:
    """A digest of a tensor's bits, whatever its dtype."""
    return hashlib.sha1(x.contiguous().view(torch.uint8).cpu().numpy()
                        .tobytes()).hexdigest()[:16]


def time_case(case, dtype, repeats, **extra) -> dict:
    name, size, run, plain, cublas, bound, kernel = case
    wrappers = (fused.cost_volume_p2p, fused.fused_point_local_feature)
    with torch.no_grad():
        full0 = sum(getattr(w, "launches_full", 0) for w in wrappers)
        got, again, want = run(), run(), plain()
        torch.cuda.synchronize()
        row = dict(case=name, dtype=str(dtype), tree=str(TREE), **extra,
                   max_abs_err=float((got.double() - want.double())
                                     .abs().max()),
                   plain_max_abs=float(want.double().abs().max()),
                   same_bits=bool(torch.equal(got, again)),
                   digest=digest(got))
        if any(hasattr(w, "launches_full") for w in wrappers):
            row["full_tile_calls"] = sum(getattr(w, "launches_full", 0)
                                         for w in wrappers) - full0
        row["kernel_ms"], row["call_ms"] = pm.device_ms(run, repeats, kernel,
                                                        1)
        row["call_event_ms"] = pm.event_ms(run, repeats)
        row["cublas_products_ms"] = pm.event_ms(cublas, repeats)
        row["bound_ms"] = bound
        row["share_of_bound"] = bound / row["kernel_ms"]
    print(json.dumps(row), flush=True)
    return row


def graph_ms(fn, iters: int) -> float:
    """Milliseconds a call of ``fn`` from replays of a CUDA graph of
    ``iters`` calls (no profiler, no host issue in the time)."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    for _ in range(2):
        graph.replay()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(5):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (5 * iters)


def build_variant(name: str, source: str = "cost_volume") -> Path:
    """``csrc/<source>.cu`` built with variant ``name``'s switches; prints
    its K4a or K5 kernels' registers and spills."""
    out = TREE / "build" / "cv_variants"
    out.mkdir(parents=True, exist_ok=True)
    so = out / f"{source}_{name}.so"
    proc = subprocess.run(
        [build._nvcc(), *build.NVCC_FLAGS,
         *FLAGS.get(name, {}).get(source, []), f"-I{build.CSRC}", "-o",
         str(so), str(build.CSRC / f"{source}.cu")],
        capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on {name}:\n{proc.stdout}"
                           f"{proc.stderr}")
    report = {}
    for chunk in (proc.stdout + proc.stderr).split(
            "Compiling entry function")[1:]:
        fn = chunk.split("'")[1]
        regs = re.search(r"Used (\d+) registers", chunk)
        spills = re.search(r"(\d+) bytes spill stores", chunk)
        if ("cv_p2p" in fn or "plf" in fn) and regs:
            report[fn] = dict(registers=int(regs.group(1)),
                              spill_stores=int(spills.group(1))
                              if spills else None)
    print(json.dumps(dict(variant=name, source=source, ptxas=report)),
          flush=True)
    return so


def load_variant(so: Path, source: str = "cost_volume"):
    lib = ctypes.CDLL(str(so))
    for fn, argtypes in fused._SIGNATURES[source].items():
        getattr(lib, fn).argtypes = list(argtypes)
        getattr(lib, fn).restype = ctypes.c_int
    lib.cmflow_error_string.argtypes = [ctypes.c_int]
    lib.cmflow_error_string.restype = ctypes.c_char_p
    build._loaded[source] = lib
    getattr(fused, "_CV_P2P_BF16_SLOTS", {}).clear()
    return lib


def on_arm(case, full: bool):
    """The same K4a case on one arm called directly: the full-tile arm, or
    the tile of whole queries (k <= 64)."""
    args = case[2].__defaults__[0]
    f1c, f2c, idx, z1, z2, dense, wn = args
    b0, w1, b1, w2, b2 = dense
    wpack = fused.tc_weights(w1, w2)
    out = torch.empty_like(f1c)
    lib = build.load("cost_volume", fused._SIGNATURES["cost_volume"])
    k = idx.shape[2]
    plan = [fused.cv_p2p_plan(B * N, k, fused._sms(f1c.device))["qpb"]
            ] if full else []

    def run():
        build.check(lib, (lib.cmflow_cv_p2p_full if full
                          else lib.cmflow_cv_p2p)(
            f1c.data_ptr(), f2c.data_ptr(), idx.data_ptr(), z1.data_ptr(),
            z2.data_ptr(), b0.data_ptr(), wpack.data_ptr(), b1.data_ptr(),
            b2.data_ptr(), *[t.data_ptr() for t in wn], out.data_ptr(), B, N,
            k, C, *plan, torch.cuda.current_stream().cuda_stream),
            "cv_p2p_full_kernel" if full else "cv_p2p_kernel")
        return out
    return (f"{case[0]} {'full' if full else 'whole'} tiles", *case[1:2],
            run, *case[3:])


def arms(repeats: int) -> None:
    """Float32 K4a at each k of ARM_K on both arms."""
    dev = torch.device("cuda")
    for case in p2p_cases(dev, torch.float32, ARM_K):
        k = case[1]
        for full in (True, False):
            time_case(on_arm(case, full), torch.float32, repeats,
                      variant="arms", wrapper_full=fused.cv_p2p_full(k),
                      whole_fill=fused.CV_P2P_ROWS // k * k
                      / fused.CV_P2P_ROWS)


def agg_chunks(variant: str = "package") -> None:
    """K4b's any-C cases at AGG_ABLATE_C with each of AGG_CHUNKS forced on
    the plan, timed by CUDA-graph replays of ten calls."""
    dev = torch.device("cuda")
    plan = fused.cv_agg_plan
    cases = {dtype: [c for c in agg_cases(dev, dtype)
                     if c[1] in AGG_ABLATE_C] for dtype in (torch.float32,
                                                            BF16)}
    try:
        for cells, per in AGG_CHUNKS:
            fused.cv_agg_plan = (lambda *a, cells=cells, per=per:
                                 dict(plan(*a), cells=cells, per=per))
            for dtype, dcases in cases.items():
                for name, _, run, *_ in dcases:
                    with torch.no_grad():
                        ms = graph_ms(run, 10)
                        bits = digest(run())
                    print(json.dumps(dict(variant=variant, case=name,
                                          dtype=str(dtype), cells=cells,
                                          per=per, graph_ms=ms,
                                          digest=bits)), flush=True)
    finally:
        fused.cv_agg_plan = plan


def bf16_cases(dev, ks=None) -> list:
    """K4a's and K5's bf16 cases at ``ks`` ({"cv": k, "plf": K}; default
    step 0's lists), with the wrapper that times each."""
    ks = ks or {"cv": P2P_BF16_K, "plf": PLF_BF16_K}
    return ([("cv", c) for c in p2p_cases(dev, BF16, ks["cv"])]
            + [("plf", c) for c in plf_cases(dev, BF16, ks["plf"])])


def whole_fill(k: int, rows: int) -> float:
    """The share of the rows of tiles of ``rows`` rows that hold a (query,
    neighbour) when each tile takes whole queries of ``k`` neighbours, or
    one query takes ``ceil(k / rows)`` tiles (``k > rows``)."""
    if k <= rows:
        return rows // k * k / rows
    return k / (-(-k // rows) * rows)


def whole_plan(total: int, k: int, rows: int) -> dict:
    """The bf16 kernels' launch in tiles of whole queries, the layout of
    their whole-query arms before PR 23: ``max(1, rows // k)`` queries a
    block, or one query over ``ceil(k / rows)`` tiles."""
    qpb = max(1, rows // k)
    return dict(qpb=qpb, tiles=-(-qpb * k // rows))


def on_whole_tiles():
    """The bf16 wrappers' plans replaced by :func:`whole_plan`; returns the
    plans to put back."""
    saved = (fused.cv_p2p_plan, fused.plf_plan)
    fused.cv_p2p_plan = lambda total, k, *a: whole_plan(
        total, k, fused.CV_P2P_ROWS)
    fused.plf_plan = lambda total, k, *a: whole_plan(total, k,
                                                     fused.PLF_ROWS)
    return saved


def bf16_arms(repeats: int) -> None:
    """K4a bf16 and K5 bf16 at every K of step 0 in full tiles (the
    wrappers' plans) and in tiles of whole queries, with the share of a
    tile of whole queries that holds rows."""
    dev = torch.device("cuda")
    for kernel, case in bf16_cases(dev):
        k = case[1]
        rows = fused.CV_P2P_ROWS if kernel == "cv" else fused.PLF_ROWS
        for full in (True, False):
            saved = None if full else on_whole_tiles()
            try:
                time_case(case, BF16, repeats, variant="bf16_arms",
                          arm="full" if full else "whole",
                          whole_fill=whole_fill(k, rows))
            finally:
                if saved:
                    fused.cv_p2p_plan, fused.plf_plan = saved


def bf16_variant(name: str, repeats: int) -> None:
    """The bf16 full-tile cases of BF16_ABLATE_K with both sources built
    with variant ``name``'s switches (``bf16_package``: as built); the
    timeline variant prints the median cycles between a tile's marks at
    K4a k=48 and K5 K=65."""
    dev = torch.device("cuda")
    libs = {src: load_variant(build_variant(name, src), src)
            for src in ("cost_volume", "plf")}
    try:
        for kernel, case in bf16_cases(dev, BF16_ABLATE_K):
            if name == "bf16_timeline":
                if case[1] in (48, 65):
                    with torch.no_grad():
                        case[2]()
                        print(json.dumps(dict(
                            variant=name, case=case[0], **pm.timeline(
                                libs[{"cv": "cost_volume"}.get(kernel,
                                                               kernel)],
                                case[2], "cmflow_cv_p2p_timeline"
                                if kernel == "cv"
                                else "cmflow_plf_bf16_timeline"))),
                              flush=True)
                continue
            time_case(case, BF16, repeats, variant=name)
    finally:
        for src in libs:
            build._loaded.pop(src, None)
        fused._CV_P2P_BF16_SLOTS.clear()


def ablate(repeats: int, names=VARIANTS) -> None:
    dev = torch.device("cuda")
    full = [c for c in p2p_cases(dev, torch.float32, P2P_K)
            if fused.cv_p2p_full(c[1])]
    for name in names:
        if name == "agg_chunks":
            agg_chunks()
            continue
        if name == "arms":
            arms(repeats)
            continue
        if name == "bf16_arms":
            bf16_arms(repeats)
            continue
        if name.startswith("bf16_"):
            bf16_variant(name, repeats)
            continue
        lib = load_variant(build_variant(name))
        if name == "timeline":
            run = next(c[2] for c in full if c[1] == 48)
            with torch.no_grad():
                run()
                print(json.dumps(dict(variant=name, case="cv k=48",
                                      **pm.timeline(
                                          lib, run,
                                          "cmflow_cv_p2p_timeline"))),
                      flush=True)
            continue
        for case in full:
            time_case(case, torch.float32, repeats, variant=name)
        build._loaded.pop("cost_volume", None)
    pm.print_card()


def main(repeats: int, bf16_only: bool = False) -> None:
    dev = torch.device("cuda")
    print(json.dumps(dict(tree=str(TREE), package=fused.__file__)),
          flush=True)
    if not bf16_only:
        for case in p2p_cases(dev, torch.float32, P2P_K):
            time_case(case, torch.float32, repeats)
    for case in p2p_cases(dev, BF16, P2P_BF16_K):
        time_case(case, BF16, repeats)
    for case in plf_cases(dev, BF16, PLF_BF16_K):
        time_case(case, BF16, repeats)
    if not bf16_only:
        for dtype in (torch.float32, BF16):
            for case in agg_cases(dev, dtype):
                time_case(case, dtype, repeats)
    pm.print_card()


if __name__ == "__main__":
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    nums = [a for a in pm.ARGS if a.isdigit()]
    if pm.ABLATE:
        ablate(int(nums[0]) if nums else 10,
               *([pm.ARGS[2].split(",")] if len(pm.ARGS) > 2 else []))
    else:
        main(int(nums[0]) if nums else 20, "bf16" in pm.ARGS)
