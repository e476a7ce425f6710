#!/usr/bin/env python3
"""Farthest-point sampling (``csrc/sampling.cu``) on one GPU: its time at
PointNet++ SSG's shapes, against another checkout's in the same call.

    python scripts/profile_torch_fps.py [TREE]

``TREE`` is the root of a checkout whose ``cmflow_tpu_torch`` is imported
and built (default: this script's own), so that one machine can time two
versions of the kernel in turns, e.g. a parent commit unpacked beside the
repository with ``git archive``: ``parent, this, this, parent``.

At B=16 and N -> npoint = 1024 -> 512, 512 -> 128 (SSG's two sampling set
abstractions), 256 -> 64 (a VoD-size cloud) and 2048 -> 512, on points of
the unit sphere from a seeded generator:
- the wrapper's default kernel: milliseconds a call from CUDA events around
  five replays of a CUDA graph of 20 calls (no profiler, and no host
  launch in the time), microseconds a step (npoint steps a call), a digest of the
  output's bits to compare trees, and whether it equals the plain version;
- where the tree's library lets the caller set the warps a cloud (1, 2,
  4 or 8), each of them, with the same bits required;
- unless ``ABLATE=0`` and only in a tree that has them, copies of
  ``sampling.cu`` built into ``build/fps_variants/`` (see VARIANTS), timed
  at the default warps: with part of a step left out (the barrier, the
  warps' exchange, every ``redux.sync``, the samples' store, or the
  dependence of a step on the last one's winner), whose samples are wrong
  and which say what that part costs; the warp's argmax as a butterfly of
  shuffles instead, held to the kernel's samples; and one that counts the
  SM cycles a step (and so the clock the time implies).

One JSON line per case; the card's name and power limit first.  Needs a
CUDA device; exits with code 1 without one.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import torch

TREE = Path(sys.argv[1] if len(sys.argv) > 1
            else Path(__file__).resolve().parents[1]).resolve()
sys.path.insert(0, str(TREE))

from cmflow_tpu_torch.native import build  # noqa: E402
from cmflow_tpu_torch.ops import sampling  # noqa: E402

B = 16
CASES = ((1024, 512), (512, 128), (256, 64), (2048, 512))
WARPS = (1, 2, 4, 8)
GRAPH_CALLS = 20
REPLAYS = 5
OUT = Path(__file__).resolve().parents[1] / "build" / "fps_variants"
# each variant of this tree's sampling.cu: (its (pattern, replacement)
# pairs, whether its samples must still equal the kernel's)
_WARP_MAX = (r"const unsigned wkey = __reduce_max_sync\(kFull, key\);\n"
             r"    const unsigned wj = __reduce_min_sync\(kFull, "
             r"key == wkey \? best_j : kNone\);")
# a variant whose winner may be any value reads the centre inside the cloud
_SAFE = (r"s_pts\[cur\]", "s_pts[min(cur, (unsigned)n - 1u)]")
VARIANTS = {
    # the step without its barrier (wrong samples)
    "no_barrier": ([(r"(\| ~wj;\n)      __syncthreads\(\);\n", r"\1"), _SAFE],
                   False),
    # each warp takes its own winner: no exchange (wrong samples)
    "no_cross_warp": ([(r"if constexpr \(WARPS == 1\) \{",
                        "if constexpr (true) {"), _SAFE], False),
    # every lane its own winner: no redux.sync anywhere (wrong samples)
    "no_redux": ([(r"__reduce_max_sync\(kFull, ([^;]*)\);", r"(\1);"),
                  (r"__reduce_min_sync\(kFull, ([^;]*)\);", r"(\1);"),
                  _SAFE], False),
    # no store of the samples (wrong samples)
    "no_store": ([(r"\n    if \(warp == 0 && \(i & 31\) == 31\) "
                   r"samples\[[^;]*;", "")], False),
    # the centre not read by the winner's index: steps do not depend on
    # each other (wrong samples): the instruction stream's time alone
    "independent_steps": ([(r"s_pts\[cur\]", "s_pts[i & 31]")], False),
    # the warp's argmax as a butterfly of 64-bit keys (distance bits, then
    # the complement of the index), five levels of two shuffles
    "shfl_argmax": ([(_WARP_MAX,
                      "unsigned long long kk = ((unsigned long long)key << "
                      "32) | (kNone - best_j);\n"
                      "#pragma unroll\n"
                      "    for (int off = 16; off > 0; off >>= 1) {\n"
                      "      const unsigned long long o = "
                      "__shfl_xor_sync(kFull, kk, off);\n"
                      "      kk = o > kk ? o : kk;\n"
                      "    }\n"
                      "    const unsigned wkey = (unsigned)(kk >> 32);\n"
                      "    const unsigned wj = kNone - (unsigned)kk;")],
                    True),
    # the warp's argmax as redux.max, then the index by a ballot and one
    # shuffle where a single lane holds the largest distance (a tie takes
    # redux.min)
    "ballot_argmax": ([(_WARP_MAX,
                        "const unsigned wkey = __reduce_max_sync(kFull, "
                        "key);\n"
                        "    const unsigned tie = __ballot_sync(kFull, "
                        "key == wkey);\n"
                        "    const unsigned wj = (tie & (tie - 1)) == 0u\n"
                        "        ? __shfl_sync(kFull, best_j, __ffs(tie) - 1)"
                        "\n"
                        "        : __reduce_min_sync(kFull, key == wkey ? "
                        "best_j : kNone);")], True),
    # SM cycles a step, block 0's thread 0 over the whole loop, written
    # over the first sample of block 0
    "cycles": ([(r"(\n  unsigned cur = 0;)",
                 r"\n  const long long t_start = clock64();\1"),
                (r"(samples\[done \+ lane\] = mine;\n)(\}\n)",
                 r"\1  if (b == 0 && t == 0) samples[0] = "
                 r"(int)((clock64() - t_start) / npoint);\n\2")], True),
}


def emit(**row) -> None:
    print(json.dumps(row), flush=True)


def graph_ms(fn) -> float:
    """Milliseconds a call of ``fn``: CUDA events around REPLAYS replays
    of a CUDA graph of GRAPH_CALLS calls, after one call outside it."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(GRAPH_CALLS):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(REPLAYS):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (REPLAYS * GRAPH_CALLS)


def digest(t: torch.Tensor) -> str:
    return hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()[:16]


def launcher(lib, what: str):
    """``(xyz, npoint, warps) -> out``: ``lib``'s FPS kernel with ``warps``
    warps a cloud (and the scratch it needs past its registers)."""
    def run(xyz, npoint, warps):
        b, n, _ = xyz.shape
        out = torch.empty((b, npoint), dtype=torch.int32, device=xyz.device)
        scratch = None
        if n > lib.cmflow_fps_register_points(warps):
            scratch = torch.empty((b, n), dtype=torch.float32,
                                  device=xyz.device)
        code = lib.cmflow_fps(xyz.data_ptr(), b, n, npoint, warps,
                              None if scratch is None else scratch.data_ptr(),
                              out.data_ptr(),
                              torch.cuda.current_stream().cuda_stream)
        if code != 0:
            raise RuntimeError(f"{what}: cudaError {code}")
        return out
    return run


def build_variants() -> dict:
    """name -> a callable ``(xyz, npoint, warps) -> out`` of each variant
    that applies to this tree's source, all compiled at once."""
    text = (build.CSRC / "sampling.cu").read_text()
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, (subs, _) in VARIANTS.items():
        if not all(re.search(pattern, text) for pattern, _ in subs):
            emit(variant=name, applies=False)
            continue
        variant = text
        for pattern, repl in subs:
            variant = re.sub(pattern, repl, variant)
        src = OUT / f"{name}.cu"
        so = OUT / f"{name}.so"
        if so.exists() and src.exists() and src.read_text() == variant:
            procs[name] = (so, None)  # built by an earlier run
            continue
        src.write_text(variant)
        procs[name] = (so, subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-o", str(so), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    runs = {}
    for name, (so, proc) in procs.items():
        if proc is not None:
            log, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {name}:\n{log}")
        lib = ctypes.CDLL(str(so))
        for fn, argtypes in sampling._SIGNATURES.items():
            getattr(lib, fn).argtypes = list(argtypes)
            getattr(lib, fn).restype = ctypes.c_int
        runs[name] = launcher(lib, name)
    return runs


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_torch_fps: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    emit(card=card, tree=str(TREE), package=sampling.__file__)
    dev = torch.device("cuda")
    lib = build.load("sampling", sampling._SIGNATURES)
    takes_warps = hasattr(lib, "cmflow_fps_warps")
    by_warps = launcher(lib, "fps")
    variants = (build_variants() if takes_warps
                and os.environ.get("ABLATE", "1") != "0" else {})
    gen = torch.Generator().manual_seed(0)
    for n, npoint in CASES:
        x = torch.randn((B, n, 3), generator=gen)
        xyz = (x / x.norm(dim=-1, keepdim=True)).to(dev)
        got = sampling.farthest_point_sample(xyz, npoint)
        plain = sampling.farthest_point_sample_plain(xyz, npoint)
        torch.cuda.synchronize()
        ms = graph_ms(lambda: sampling.farthest_point_sample(xyz, npoint))
        row = dict(shape=f"B={B} N={n} npoint={npoint}", ms=ms,
                   us_per_step=1e3 * ms / npoint, digest=digest(got),
                   equals_plain=bool(torch.equal(got, plain)))
        if takes_warps:
            default = lib.cmflow_fps_warps(n)
            row["default_warps"] = default
            row["by_warps"] = {}
            for w in WARPS:
                other = by_warps(xyz, npoint, w)
                torch.cuda.synchronize()
                if not torch.equal(other, got):
                    raise RuntimeError(f"N={n}: {w} warps differ")
                w_ms = graph_ms(lambda w=w: by_warps(xyz, npoint, w))
                row["by_warps"][w] = dict(ms=w_ms,
                                          us_per_step=1e3 * w_ms / npoint)
            row["variants"] = {}
            for name, run in variants.items():
                if n > lib.cmflow_fps_register_points(default):
                    continue
                out = run(xyz, npoint, default)
                torch.cuda.synchronize()
                v = dict(ms=graph_ms(lambda run=run: run(xyz, npoint,
                                                         default)))
                if name == "cycles":
                    v["cycles_per_step"] = int(out[0, 0])
                    v["ghz"] = v["cycles_per_step"] / (1e6 * v["ms"]
                                                       / npoint)
                    out[0, 0] = got[0, 0]
                if VARIANTS[name][1] and not torch.equal(out, got):
                    raise RuntimeError(f"N={n}: variant {name} differs")
                row["variants"][name] = v
        emit(**row)
    return 0


if __name__ == "__main__":
    sys.exit(main())
