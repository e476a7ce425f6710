#!/usr/bin/env python3
"""Device time of K3 past K = 32 (``csrc/mse.cu::mse_long_kernel`` and
``mse_bf16_long_kernel``) on one GPU, beside cuBLAS on the same products.

    python scripts/profile_torch_mse.py [TREE] [REPEATS]
    python scripts/profile_torch_mse.py ablate [REPEATS [VARIANT,...]]

``TREE`` is the root of a checkout whose ``cmflow_tpu_torch`` is imported
and built (default: this script's own), so that one call can time two
versions of the kernels in turns, e.g. the parent commit unpacked with
``git archive`` into ``build/parent``::

    for t in build/parent . . build/parent; do
        python scripts/profile_torch_mse.py $t; done

It calls only ``fused_multi_scale_encoder`` and its plain version, whose
signatures every tree since the long kernels shares.  At B=16, N=256, with
seeded weights (``MultiScaleEncoder``, widths (32, 32, 64), 3 features)
and random neighbours (some outside [0, N)), in float32 and bf16:

- one scale at K = 33, 48, 64, 100 and 200 (``chip_smoke.py``'s
  ``lifted_fused`` rows): the long kernel's own device time, the whole
  call's (the centroids' mean, the weight image), cuBLAS on the two
  products alone at K rows a query (float32, or bf16 operands with float32
  sums as ``_dot32`` calls it), the bound of the arithmetic (3xTF32 at 495
  TFLOP/s, bf16 at 989);
- config A's call (``sa_nsamples`` (8, 16, 32, 64), ``chip_smoke.py``'s
  ``shapes`` phase): both kernels, each on its own, and a digest of the
  K <= 32 scales' output bits, which must equal the parent's (their kernel
  is unchanged).

Each case also gives the max abs error against the plain version, the
plain output's largest magnitude, whether two calls give the same bits,
and a digest of the output.  Device times from ``torch.profiler`` over
REPEATS warmed calls (default 20): a window counts only if it recorded the
kernel exactly once per call (:func:`device_ms`).  One JSON line per case, then the card's name and
power limit.

``ablate`` builds copies of this tree's ``csrc/mse.cu`` (into
``build/mse_variants/``) and times the long kernels' cases with each in
turn: ``package`` (as built), ``no_mma`` (the products left out, their
operands kept live), ``groups_2`` (float32 blocks of two warpgroups, the
plan's too, two blocks an SM; four in one block pass the 48 KB of static
shared memory with their index rings),
``bf16_groups_1`` / ``bf16_groups_2`` (likewise for bf16: 4 or 2 blocks an
SM), and ``timeline`` (block 0's thread 0 stamps its cycle counter at the
marks of each step; after a call at K = 64 it prints the median cycles
between marks: forming A, each product with its wait, the max and the
step's end).
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import re
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

ARGS = sys.argv[1:]
ABLATE = bool(ARGS) and ARGS[0] == "ablate"
TREE = Path(ARGS[0] if ARGS and not ABLATE and not ARGS[0].isdigit()
            else Path(__file__).resolve().parents[1]).resolve()
sys.path.insert(0, str(TREE))

from cmflow_tpu_torch.native import build  # noqa: E402
from cmflow_tpu_torch.nn import blocks  # noqa: E402
from cmflow_tpu_torch.ops import fused  # noqa: E402

B, N, CF = 16, 256, 3
WIDTHS = (32, 32, 64)
LIFTED_K = (33, 48, 64, 100, 200)
CONFIG_A = (8, 16, 32, 64)
BF16 = torch.bfloat16
PEAK = {torch.float32: 495e12 / 3, BF16: 989e12}  # 3xTF32: three passes
PROFILE_TRIES = 6  # windows traced before device_ms gives up
SENTINEL = "spin_kernel"  # torch.cuda._sleep's kernel
KERNEL = {torch.float32: "mse_long_kernel", BF16: "mse_bf16_long_kernel"}
TILE_KERNEL = {torch.float32: "mse_kernel", BF16: "mse_bf16_kernel"}
SUBST = {  # ablation copies by substitution: (pattern, replacement)
    "groups_2": [(r"kLongGroups = \d+;", "kLongGroups = 2;"),
                 (r"kLongBlocks = \d+;", "kLongBlocks = 2;")],
    "bf16_groups_1": [(r"kLongBf16Groups = \d+;", "kLongBf16Groups = 1;"),
                      (r"kLongBf16Blocks = \d+;", "kLongBf16Blocks = 4;")],
    "bf16_groups_2": [(r"kLongBf16Groups = \d+;", "kLongBf16Groups = 2;"),
                      (r"kLongBf16Blocks = \d+;", "kLongBf16Blocks = 2;")],
}
FLAGS = {"no_mma": ["-DMSE_LONG_NO_MMA"], "timeline": ["-DMSE_LONG_TIMELINE"]}
VARIANTS = ("package", "no_mma", *SUBST, "timeline")


def device_ms(fn, repeats: int, kernel: str, per_call: int) -> tuple:
    """(Device ms a call of the kernel named ``kernel``, of every kernel
    ``fn`` launches), over ``repeats`` warmed calls.  The profiler now and
    then records only part of a window, the first kernel most often, so
    each window starts with a throwaway kernel; a window counts only if it
    recorded ``kernel`` ``repeats * per_call`` times.  (The call's other
    kernels, the centroids' mean and the weight image, are each taken at
    their mean duration times their launches a call: the profiler has
    dropped one of their ten.)  A rejected window is printed to stderr and
    traced again after a pause that doubles, up to ``PROFILE_TRIES``
    windows; then this raises."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    for t in range(PROFILE_TRIES):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                torch.cuda._sleep(1)
                torch.cuda.synchronize()
                for _ in range(repeats):
                    fn()
                torch.cuda.synchronize()
            events = [e for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA
                      and SENTINEL not in e.key]
        named = [e for e in events if re.search(rf"\b{kernel}\b", e.key)]
        if sum(e.count for e in named) == repeats * per_call:
            own = sum(e.self_device_time_total for e in named)
            total = sum(e.self_device_time_total / e.count
                        * max(1, round(e.count / repeats)) for e in events)
            return own / 1e3 / repeats, total / 1e3
        print(json.dumps(dict(profiler_window_rejected=dict(
            kernel=kernel, per_call=per_call, window=t,
            counts={e.key[:80]: e.count for e in events}))),
            file=sys.stderr, flush=True)
        time.sleep(0.1 * 2 ** t)
        for _ in range(3):  # warm again after the pause
            fn()
        torch.cuda.synchronize()
    raise RuntimeError(f"the profiler recorded no whole window of "
                       f"{kernel!r} in {PROFILE_TRIES} tries")


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


def digest(x: torch.Tensor) -> str:
    return hashlib.sha1(x.cpu().numpy().tobytes()).hexdigest()


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


def make_cases(dtype, dev) -> list:
    """(name, ks, call, plain, cuBLAS on the long scales' products,
    operations) at B=16, N=256: each of LIFTED_K alone, then config A's
    four scales; inputs from a seed of the case, the same in every tree."""
    cases = []
    for i, ks in enumerate([(k,) for k in LIFTED_K] + [CONFIG_A]):
        rs = np.random.RandomState(100 + i)
        pc = torch.from_numpy(rs.rand(B, N, 3).astype(np.float32) * 20).to(
            dev)
        feats = torch.from_numpy(rs.randn(B, CF, N).astype(np.float32)).to(
            dev).to(dtype).transpose(1, 2)
        idx = [torch.from_numpy(rs.randint(-2, N + 2, (B, N, k)).astype(
            np.int32)).to(dev) for k in ks]
        radii = tuple(2.0 * (s + 1) for s in range(len(ks)))
        mse = seeded(blocks.MultiScaleEncoder(radii, ks, CF, WIDTHS, (16,)),
                     dev, 7 + i)
        with torch.no_grad():
            packed, _ = fused.mse_narrow_params_from_variables(mse, dtype)
        rows = B * N
        long_rows = rows * sum(k for k in ks if k > 32)
        xs = [torch.randn((long_rows, c), device=dev).to(dtype)
              for c in WIDTHS[:-1]]
        ws = [torch.randn((c, o), device=dev).to(dtype)
              for c, o in zip(WIDTHS[:-1], WIDTHS[1:])]
        if dtype == BF16:
            def cublas(xs=xs, ws=ws):
                return [torch.mm(x, w, out_dtype=torch.float32)
                        for x, w in zip(xs, ws)]
        else:
            def cublas(xs=xs, ws=ws):
                return [x @ w for x, w in zip(xs, ws)]
        c1, c2, c3 = WIDTHS
        # the long scales' first layer (3 + Cf inputs) and two products
        flops = 2 * (rows * c1 * (3 + CF) * sum(k > 32 for k in ks)
                     + long_rows * (c1 * c2 + c2 * c3))
        cases.append((
            f"K={ks}", ks,
            lambda f=feats, i_=idx, p=pc, pk=packed:
                fused.fused_multi_scale_encoder(f, i_, p, pk),
            lambda f=feats, i_=idx, p=pc, pk=packed:
                fused.fused_multi_scale_encoder_plain(f, i_, p, pk),
            cublas, flops))
    return cases


def time_cases(dtype, dev, repeats: int, **extra) -> None:
    with torch.no_grad():
        for name, ks, run, plain, cublas, flops in make_cases(dtype, dev):
            got, again, want = run(), run(), plain()
            torch.cuda.synchronize()
            row = dict(case=name, dtype=str(dtype), tree=str(TREE), **extra,
                       max_abs_err=float((got.double() - want.double())
                                         .abs().max()),
                       plain_max_abs=float(want.abs().max()),
                       same_bits=bool(torch.equal(got, again)),
                       digest=digest(got))
            row["kernel_ms"], row["call_ms"] = device_ms(
                run, repeats, KERNEL[dtype], 1)
            row["call_event_ms"] = event_ms(run, repeats)
            row["cublas_products_ms"] = event_ms(cublas, repeats)
            row["bound_ms"] = 1e3 * flops / PEAK[dtype]
            row["share_of_bound"] = row["bound_ms"] / row["kernel_ms"]
            if any(k <= 32 for k in ks):  # the tile kernel beside
                row["tile_kernel_ms"] = device_ms(run, repeats,
                                                  TILE_KERNEL[dtype], 1)[0]
                tile = [s for s, k in enumerate(ks) if k <= 32]
                row["tile_scales_digest"] = digest(torch.cat(
                    [got[..., 64 * s:64 * (s + 1)] for s in tile], -1))
            print(json.dumps(row), flush=True)


def print_card() -> None:
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip(), flush=True)


def build_variant(name: str) -> Path:
    out = TREE / "build" / "mse_variants"
    out.mkdir(parents=True, exist_ok=True)
    src = (build.CSRC / "mse.cu").read_text()
    for pattern, repl in SUBST.get(name, []):
        src, count = re.subn(pattern, repl, src)
        if count != 1:
            raise RuntimeError(f"{name}: {pattern!r} matched {count} times")
    cu = out / f"mse_{name}.cu"
    cu.write_text(src)
    so = out / f"mse_{name}.so"
    proc = subprocess.run(
        [build._nvcc(), *build.NVCC_FLAGS, *FLAGS.get(name, []),
         f"-I{build.CSRC}", "-o", str(so), str(cu)],
        capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on {name}:\n{proc.stdout}"
                           f"{proc.stderr}")
    # each long kernel's registers and spills from ptxas's report
    report = {}
    for chunk in (proc.stdout + proc.stderr).split(
            "Compiling entry function")[1:]:
        kernel = re.search(r"(mse_\w*long_kernel\w*)", chunk.split("\n")[0])
        regs = re.search(r"Used (\d+) registers", chunk)
        spills = re.search(r"(\d+) bytes spill stores", chunk)
        if kernel and regs:
            report[kernel.group(1)] = dict(
                registers=int(regs.group(1)),
                spill_stores=int(spills.group(1)) if spills else None)
    print(json.dumps(dict(variant=name, ptxas=report)), flush=True)
    return so


def timeline(lib, run, name: str = "cmflow_mse_long_timeline") -> dict:
    """Median cycles between the marks of block 0's steps in one call
    (``name``: the library's function that hands the stamps over)."""
    fn = getattr(lib, name)
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int]
    fn(None, 0)  # clear
    run()
    torch.cuda.synchronize()
    buf = (ctypes.c_longlong * (2 * 8192))()
    n = fn(buf, 8192)
    t = np.array(buf[:2 * n:2], np.int64)
    what = np.array(buf[1:2 * n:2], np.int64)
    out = {"stamps": int(n)}
    for j in range(n - 1):
        key = f"{what[j]}_to_{what[j + 1]}"
        out.setdefault(key, []).append(int(t[j + 1] - t[j]))
    return {k: (float(np.median(v)) if isinstance(v, list) else v)
            for k, v in out.items()}


def ablate(repeats: int, names=VARIANTS) -> None:
    dev = torch.device("cuda")
    sig = fused._SIGNATURES["mse"]
    groups0 = dict(fused.MSE_LONG_GROUPS)
    blocks0 = dict(fused.MSE_LONG_BLOCKS)
    for name in names:
        lib = ctypes.CDLL(str(build_variant(name)))
        for fn, argtypes in sig.items():
            getattr(lib, fn).argtypes = list(argtypes)
            getattr(lib, fn).restype = ctypes.c_int
        lib.cmflow_error_string.argtypes = [ctypes.c_int]
        lib.cmflow_error_string.restype = ctypes.c_char_p
        build._loaded["mse"] = lib
        # the plan follows the copy's constants
        fused.MSE_LONG_GROUPS.update(groups0)
        fused.MSE_LONG_BLOCKS.update(blocks0)
        for pattern, repl in SUBST.get(name, []):
            key, value = re.match(r"(\w+) = (\d+);", repl).groups()
            bf16 = "Bf16" in key
            table = (fused.MSE_LONG_GROUPS if "Groups" in key
                     else fused.MSE_LONG_BLOCKS)
            table[bf16] = int(value)
        for dtype in (torch.float32, BF16):
            if name == "timeline":
                cases = make_cases(dtype, dev)
                run = next(c[2] for c in cases if c[1] == (64,))
                with torch.no_grad():
                    run()
                    print(json.dumps(dict(variant=name, dtype=str(dtype),
                                          case="K=(64,)",
                                          **timeline(lib, run))), flush=True)
                continue
            time_cases(dtype, dev, repeats, variant=name)
    fused.MSE_LONG_GROUPS.update(groups0)
    fused.MSE_LONG_BLOCKS.update(blocks0)
    build._loaded.pop("mse", None)
    print_card()


def main(repeats: int) -> None:
    dev = torch.device("cuda")
    print(json.dumps(dict(tree=str(TREE), package=fused.__file__)),
          flush=True)
    for dtype in (torch.float32, BF16):
        time_cases(dtype, dev, repeats)
    print_card()


if __name__ == "__main__":
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    nums = [a for a in ARGS if a.isdigit()]
    if ABLATE:
        ablate(int(nums[0]) if nums else 10,
               *([ARGS[2].split(",")] if len(ARGS) > 2 else []))
    else:
        main(int(nums[0]) if nums else 20)
