#!/usr/bin/env python3
"""Device time of the cost volume's two kernels (``csrc/cost_volume.cu``) on
one GPU at the shapes their last redesign took, beside cuBLAS.

    python scripts/profile_torch_cv.py [TREE] [REPEATS]
    python scripts/profile_torch_cv.py ablate [REPEATS [VARIANT,...]]

``TREE`` is the root of a checkout whose ``cmflow_tpu_torch`` is imported
and built (default: this script's own), so that one call can time two
versions in turns, e.g. the parent commit unpacked with ``git archive``
into ``build/parent``::

    for t in build/parent . . build/parent; do
        python scripts/profile_torch_cv.py $t; done

It calls only ``cost_volume_p2p``, ``cost_volume_agg`` and their plain
versions, whose signatures every tree since the generic arms shares.  At
B=16, N=256, seeded weights (``FeatureCorrelator``) and random neighbours
(some outside [0, N)), the same in every tree:

- K4a float32 at k = 5, 8, 33, 48, 64, 65, 100 and 130 (the full-tile arm
  at every k that does not divide 64; 8 and 64 keep their arm), and the
  bf16 arm at k = 48 and 100: its kernel's device time, the whole call's
  (the per-call weight split), cuBLAS on its two 512x512 products at k
  rows a query (float32, or bf16 operands with float32 sums), and the
  bound of its arithmetic (3xTF32 at 495 TFLOP/s, bf16 at 989);
- K4b at C = 100, 512, 768 and 826, k = 16, p2p in float32 and bf16 (the
  tuned kernel at 512, the generic arm elsewhere; ``chip_smoke.py``'s
  ``lifted_fused`` and config B's ``shapes`` rows): its kernel's time,
  cuBLAS on the WeightNet's two products alone, and the larger of its
  bytes at 3.35 TB/s and its float32 operations at 67 TFLOP/s.

Each case gives the max abs error against the plain version, the plain
output's largest magnitude, whether two calls give the same bits, and a
digest of the output's bits (equal between trees where the kernels sum in
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
thread), timed by replays of a CUDA graph of ten calls.
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
P2P_BF16_K = (48, 100)
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
# K4b's kernel in any tree: the tuned one at 512, else the any-C kernel or,
# before it, the generic chain kernel
AGG_KERNEL = ("(?:cv_agg_kernel|cv_agg_bf16_kernel|cv_agg_any_kernel"
              "|chain_kernel)")
FLAGS = {"x0_direct": ["-DCV_P2P_X0_DIRECT"],
         "no_mma": ["-DCV_P2P_NO_MMA"], "timeline": ["-DCV_P2P_TIMELINE"]}
VARIANTS = ("package", "x0_direct", "no_mma", "timeline", "arms",
            "agg_chunks")
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
    with torch.no_grad():
        full0 = getattr(fused.cost_volume_p2p, "launches_full", 0)
        got, again, want = run(), run(), plain()
        torch.cuda.synchronize()
        row = dict(case=name, dtype=str(dtype), tree=str(TREE), **extra,
                   max_abs_err=float((got.double() - want.double())
                                     .abs().max()),
                   plain_max_abs=float(want.double().abs().max()),
                   same_bits=bool(torch.equal(got, again)),
                   digest=digest(got))
        if hasattr(fused.cost_volume_p2p, "launches_full"):
            row["full_tile_calls"] = (fused.cost_volume_p2p.launches_full
                                      - full0)
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


def build_variant(name: str) -> Path:
    out = TREE / "build" / "cv_variants"
    out.mkdir(parents=True, exist_ok=True)
    so = out / f"cost_volume_{name}.so"
    proc = subprocess.run(
        [build._nvcc(), *build.NVCC_FLAGS, *FLAGS.get(name, []),
         f"-I{build.CSRC}", "-o", str(so), str(build.CSRC / "cost_volume.cu")],
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
        if "cv_p2p" in fn and "bf16" not in fn and regs:
            report[fn] = dict(registers=int(regs.group(1)),
                              spill_stores=int(spills.group(1))
                              if spills else None)
    print(json.dumps(dict(variant=name, ptxas=report)), flush=True)
    return so


def load_variant(so: Path):
    lib = ctypes.CDLL(str(so))
    for fn, argtypes in fused._SIGNATURES["cost_volume"].items():
        getattr(lib, fn).argtypes = list(argtypes)
        getattr(lib, fn).restype = ctypes.c_int
    lib.cmflow_error_string.argtypes = [ctypes.c_int]
    lib.cmflow_error_string.restype = ctypes.c_char_p
    build._loaded["cost_volume"] = lib
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


def main(repeats: int) -> None:
    dev = torch.device("cuda")
    print(json.dumps(dict(tree=str(TREE), package=fused.__file__)),
          flush=True)
    for case in p2p_cases(dev, torch.float32, P2P_K):
        time_case(case, torch.float32, repeats)
    for case in p2p_cases(dev, BF16, P2P_BF16_K):
        time_case(case, BF16, repeats)
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
        main(int(nums[0]) if nums else 20)
