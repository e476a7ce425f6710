"""Device time of the generic kernel (``csrc/chain.cu``) at config B's
shapes, on the card, beside cuBLAS on the same products.

    python scripts/profile_torch_chain.py [REPEATS]
    python scripts/profile_torch_chain.py ablate [REPEATS [VARIANT,...]]

Run from the root of a checkout (it times that checkout's kernels, built
into its own ``build/kernels/``): to compare two trees, run it from each in
turns in one call, e.g. the parent unpacked with ``git archive`` into
``build/parent``::

    for t in build/parent . . build/parent; do
        (cd $t && python $OLDPWD/scripts/profile_torch_chain.py); done

It uses only the wrappers' private generic routes (``_mse_generic``,
``_plf_generic``, ``_cv_p2p_generic``), so it runs on any tree that has
them.  Config B (``chip_smoke.py``'s ``shapes`` phase): B=16, N=256; K3
(64, 64, 128) with 3 features at K = 16, 32, 64 (a launch a scale); K5
(768, 384, 96) at K = 16, 32, 64 (the three scales of a forward, a launch
each); K4a at C = 768, k = 16 (K4b's generic arm is
``csrc/cost_volume.cu``'s, ``scripts/profile_torch_cv.py``); float32 and
bf16,
random neighbours (some outside [0, N)), seeded inputs.  Each kernel's time
is its device time from ``torch.profiler`` (kernels whose name holds
``chain``) over REPEATS calls (default 10), after two warm-up calls, from a
window that recorded every launch the wrappers counted; the
wrapper's time, packing included, from CUDA events over the same calls.
Prints one JSON line a case, then the card's name and power limit.

``ablate`` builds copies of ``csrc/chain.cu`` with the package's nvcc
flags and one build switch each (into ``build/chain_variants/``) and times
the tensor-core arm's cases (K5, K4a; both dtypes) with each in turn:
``package`` (no switch), ``cluster_1`` (every block reads each weight stage
from L2 itself: no multicast, no remote barrier arrivals), ``no_mma`` (the
products left out) and ``timeline`` (block 0's thread 0 stamps its cycle
counter around each stage; after a K5 bf16 call at K=16 it prints the
median cycles of each part of a stage: the wait for the stage to land,
the issue, the wait for the group before, the rest until the next stage,
and how far ahead of its use each stage was issued).
"""

import ctypes
import json
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np
import torch
from torch.autograd import DeviceType

sys.path.insert(0, ".")

from cmflow_tpu_torch.native import build  # noqa: E402
from cmflow_tpu_torch.nn import blocks  # noqa: E402
from cmflow_tpu_torch.ops import fused  # noqa: E402

VARIANTS = {"package": [], "cluster_1": ["-DCHAIN_TC_CLUSTER=1"],
            "no_mma": ["-DCHAIN_TC_NO_MMA"],
            "timeline": ["-DCHAIN_TC_TIMELINE"]}

B, N = 16, 256
KS = (16, 32, 64)
BF16 = torch.bfloat16


PROFILE_TRIES = 6  # windows traced before device_ms gives up
SENTINEL = "spin_kernel"  # torch.cuda._sleep's kernel


def generic_launches() -> int:
    """The generic kernel's launches so far, over the four wrappers."""
    return sum(w.launches_generic for w in (
        fused.fused_multi_scale_encoder, fused.fused_point_local_feature,
        fused.cost_volume_p2p))


def device_ms(fn, repeats: int) -> float:
    """Mean device time of the ``chain`` kernels a call launches.  The
    profiler now and then records only part of a window (the first kernel
    most often, so each window starts with a throwaway one): a window
    counts only if it recorded the ``chain`` kernels as many times as the
    wrappers counted their generic launches over its calls, and every
    kernel a multiple of ``repeats`` times.  A rejected window is printed
    to stderr and traced again after a pause that doubles, up to
    ``PROFILE_TRIES`` windows; then this raises."""
    fn()
    before = generic_launches()
    fn()
    per_call = generic_launches() - before
    torch.cuda.synchronize()
    for t in range(PROFILE_TRIES):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            with torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
                torch.cuda._sleep(1)
                torch.cuda.synchronize()
                for _ in range(repeats):
                    fn()
                torch.cuda.synchronize()
            events = [e for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA
                      and SENTINEL not in e.key]
        named = [e for e in events if "chain" in e.key]
        if (sum(e.count for e in named) == repeats * per_call
                and all(e.count % repeats == 0 for e in events)):
            total = sum(e.self_device_time_total for e in named)
            return total / 1e3 / repeats
        print(json.dumps(dict(profiler_window_rejected=dict(
            per_call=per_call, window=t,
            counts={e.key[:80]: e.count for e in events}))),
            file=sys.stderr, flush=True)
        time.sleep(0.1 * 2 ** t)
    raise RuntimeError(f"the profiler recorded no whole window of the "
                       f"generic kernel in {PROFILE_TRIES} tries")


def event_ms(fn, repeats: int) -> float:
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    fn()
    torch.cuda.synchronize()
    start.record()
    for _ in range(repeats):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / repeats


def cublas(rows_k, widths, dtype, dev):
    """cuBLAS on the chain's products alone (float32 sums)."""
    xs = [torch.randn((r, c), device=dev).to(dtype)
          for r, c in zip(rows_k, widths[:-1])]
    ws = [torch.randn((c, o), device=dev).to(dtype)
          for c, o in zip(widths[:-1], widths[1:])]
    if dtype == BF16:
        return lambda: [torch.mm(x, w, out_dtype=torch.float32)
                        for x, w in zip(xs, ws)]
    return lambda: [x @ w for x, w in zip(xs, ws)]


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


def make_cases(dtype, dev, rs, tc_only: bool = False) -> list:
    """(name, call, cuBLAS yardsticks, operations) of config B's generic
    arms in ``dtype``; ``tc_only``: K5 and K4a alone."""
    pc = torch.from_numpy(rs.rand(B, N, 3).astype(np.float32) * 20).to(dev)

    def idx(k):
        return torch.from_numpy(rs.randint(-2, N + 2, (B, N, k)).astype(
            np.int32)).to(dev)

    def rand(*shape, dtype=torch.float32):
        return torch.from_numpy(rs.randn(*shape).astype(np.float32)).to(
            dev).to(dtype)

    rows = B * N
    cases = []
    if not tc_only:
        mse = seeded(blocks.MultiScaleEncoder((2.0, 4.0, 8.0), KS, 3,
                                              (64, 64, 128), (16,)), dev, 1)
        with torch.no_grad():
            packed, _ = fused.mse_narrow_params_from_variables(mse, dtype)
        feats = rand(B, N, 3, dtype=dtype)
        ids = [idx(k) for k in KS]
        cases.append(("K3 (64, 64, 128) K=(16, 32, 64)",
                      lambda: fused._mse_generic(feats, ids, pc, packed),
                      [cublas([rows * k] * 2, [64, 64, 128], dtype, dev)
                       for k in KS], 2 * rows * sum(KS) * (64 * 64
                                                         + 64 * 128)))
    plf = seeded(blocks.PointLocalFeature(8.0, 16, 40, (768, 384, 96),
                                          (16,)), dev, 2)
    with torch.no_grad():
        chain, _, _ = fused.plf_params_from_variables(plf)
    chain = [t.to(dtype) if i % 3 == 0 else t for i, t in enumerate(chain)]
    feat_tx = rand(B, N, 768, dtype=dtype)
    pids = [idx(k) for k in KS]
    cases.append(("K5 (768, 384, 96) K=(16, 32, 64)",
                  lambda: [fused._plf_generic(feat_tx, i, pc, chain)
                           for i in pids],
                  [cublas([rows * k] * 2, [768, 384, 96], dtype, dev)
                   for k in KS],
                  2 * rows * sum(KS) * (768 * 384 + 384 * 96)))
    fc = seeded(blocks.FeatureCorrelator(16, 768, 768, (768,) * 3), dev, 3)
    with torch.no_grad():
        dense, wn1, _ = fused.cv_params_from_variables(fc)
    dense = [t.to(dtype) if i % 2 == 0 else t for i, t in enumerate(dense)]
    args = (rand(B, N, 768, dtype=dtype), rand(B, N, 768, dtype=dtype),
            idx(16), rand(B, N, 8), rand(B, N, 8), dense[1:], wn1[1:])
    cases.append(("K4a C=768 k=16", lambda: fused._cv_p2p_generic(*args),
                  [cublas([rows * 16] * 2, [768] * 3, dtype, dev)],
                  2 * rows * 16 * 2 * 768 * 768))
    # the first K5 scale alone (the timeline's call)
    cases.append(("K5 (768, 384, 96) K=16",
                  lambda: fused._plf_generic(feat_tx, pids[0], pc, chain),
                  [], 0))
    return cases


def time_cases(cases, dtype, repeats, yardsticks=True, **extra) -> None:
    with torch.no_grad():
        for name, fn, yard, flops in cases:
            row = dict(case=name, dtype=str(dtype), **extra,
                       kernel_ms=device_ms(fn, repeats),
                       wrapper_event_ms=event_ms(fn, repeats))
            if yard and yardsticks:
                row["cublas_products_ms"] = sum(
                    event_ms(y, repeats) for y in yard)
            if flops:
                peak = 989e12 if dtype == BF16 else 495e12 / 3
                row["bound_ms"] = 1e3 * flops / peak
                row["share_of_bound"] = row["bound_ms"] / row["kernel_ms"]
            print(json.dumps(row), flush=True)


def main(repeats: int) -> None:
    dev = torch.device("cuda")
    rs = np.random.RandomState(0)
    for dtype in (torch.float32, BF16):
        time_cases(make_cases(dtype, dev, rs), dtype, repeats)
    print_card()


def print_card() -> None:
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip(), flush=True)


def build_variant(name: str, flags) -> Path:
    out = Path("build/chain_variants")
    out.mkdir(parents=True, exist_ok=True)
    so = out / f"chain_{name}.so"
    proc = subprocess.run(
        [build._nvcc(), *build.NVCC_FLAGS, *flags, "-o", str(so),
         str(build.CSRC / "chain.cu")], capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on {name}:\n{proc.stdout}"
                           f"{proc.stderr}")
    return so


def timeline(lib) -> dict:
    """Median cycles of each part of a stage in block 0 of the last
    launch, and how many stages ahead of its wait each stage was issued."""
    buf = (ctypes.c_longlong * (2 * 8192))()
    fn = lib.cmflow_chain_tc_timeline
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int]
    n = fn(buf, 8192)
    t = np.array(buf[:2 * n:2], np.int64)
    what = np.array(buf[1:2 * n:2], np.int64)
    parts = {"wait_stage": (0, 1), "issue": (1, 2), "wait_group": (2, 3),
             "release": (3, 5), "form": (5, 6), "ask_rows": (6, 7),
             "to_wait": (7, 0)}
    out = {"stamps": int(n)}
    for key, (a, b) in parts.items():  # from mark a to the next mark b
        d = []
        for j in np.flatnonzero(what == a):
            nxt = j + 1
            while nxt < n and what[nxt] == 4:  # skip fill_ring's marks
                nxt += 1
            if nxt < n and what[nxt] == b:
                d.append(t[nxt] - t[j])
        out[key] = float(np.median(d)) if d else None
    starts = t[what == 0]
    if len(starts) > 1:
        out["stage_period"] = float(np.median(np.diff(starts)))
    fills = t[what == 4]
    waits = t[what == 1]
    k = min(len(fills), len(waits))
    if k:  # stage f issued at fills[f], landed and taken at waits[f]
        out["issue_to_use"] = float(np.median(waits[:k] - fills[:k]))
    return out


def ablate(repeats: int, names=tuple(VARIANTS)) -> None:
    dev = torch.device("cuda")
    sig = fused._SIGNATURES["chain"]
    for name in names:
        flags = VARIANTS[name]
        lib = ctypes.CDLL(str(build_variant(name, flags)))
        for fn, argtypes in sig.items():
            getattr(lib, fn).argtypes = list(argtypes)
            getattr(lib, fn).restype = ctypes.c_int
        lib.cmflow_error_string.argtypes = [ctypes.c_int]
        lib.cmflow_error_string.restype = ctypes.c_char_p
        build._loaded["chain"] = lib
        for dtype in (BF16, torch.float32):
            rs = np.random.RandomState(0)
            cases = make_cases(dtype, dev, rs, tc_only=True)
            if name == "timeline":
                with torch.no_grad():
                    cases[-1][1]()
                    torch.cuda.synchronize()
                    lib.cmflow_chain_tc_timeline(None, 0)  # clear
                    cases[-1][1]()
                    torch.cuda.synchronize()
                print(json.dumps(dict(variant=name, dtype=str(dtype),
                                      case=cases[-1][0], **timeline(lib))),
                      flush=True)
                continue
            time_cases(cases, dtype, repeats, yardsticks=False,
                       variant=name)
    build._loaded.pop("chain", None)
    print_card()


if __name__ == "__main__":
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    args = sys.argv[1:]
    if args and args[0] == "ablate":
        ablate(int(args[1]) if len(args) > 1 else 5,
               *([args[2].split(",")] if len(args) > 2 else []))
    else:
        main(int(args[0]) if args else 10)
