#!/usr/bin/env python3
"""K4b's schedule, ablated on one GPU.

    python scripts/profile_torch_cv_agg.py

K4b (``csrc/cost_volume.cu::cv_agg_kernel``) takes ``kAggQ`` queries a
block, their neighbours in chunks of ``kAggKc``, and streams each thread's
p2p columns through a ring of ``kAggDepth`` queries.  This script compiles
copies of ``csrc/cost_volume.cu`` (into ``build/cv_agg_variants/``, with the
package's nvcc flags) that change one choice each: Q in {4, 8, 16} by kc in
{8, 16}, kc=4, the sum loop unrolled 1 or 8 times (not 4), a ring of 3,
three blocks an SM at Q=8 (not two) or one; and three that leave out part
of the work, to show what holds the kernel: ``no_p2p_loads`` reads no p2p
row (each copy writes zeros), ``no_last_layer`` computes no 512-wide layer
(w is the bias), ``no_hidden_layer`` no 8-wide layers (h is zero).  Each
variant is timed beside the package's own kernel on the same inputs, at
B=16, N=256 and N=384 with k=8 (the fused route's shapes) and at N=256,
k=33: device time from ``torch.profiler`` over 20 warmed calls
(``profile_torch_tc.device_ms``, every window checked), the max abs error
against the plain version, whether the bits equal the package kernel's,
and registers and spills from ``ptxas -v``.  One JSON line per variant and
shape.  Needs a CUDA device and nvcc; exits with code 1 without a device.
"""

from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))

from profile_torch_tc import B, device_ms, seeded  # noqa: E402
from cmflow_tpu_torch.native import build  # noqa: E402
from cmflow_tpu_torch.nn import blocks  # noqa: E402
from cmflow_tpu_torch.ops import fused, neighbors  # noqa: E402

OUT = build.BUILD_DIR.parent / "cv_agg_variants"
KERNEL = "cv_agg_kernel"
G_LOAD = "r[e] >= 0 && (kFixed || q * kPartCh < width)"
BOUND = "__launch_bounds__(kAggThreads, 2)\n    cv_agg_kernel("
W_LAYER = "t = fma4(make_float4(h[m], h[m], h[m], h[m]), w2r[m], t);"
HIDDEN = "weightnet_hidden_shared(d, wn_s, h);"
SUM_LOOP = "#pragma unroll {}\n      for (int kk = 0; kk < kn; ++kk) {{"
# a block of Q queries takes Q / 2 a thread (two query slots of 128
# threads)
PER = [(r"constexpr int kAggPer = \d+;", "constexpr int kAggPer = {};")]
VARIANTS = {
    **{f"Q={q} kc={kc}": [(r"constexpr int kAggQ = \d+;",
                           f"constexpr int kAggQ = {q};"),
                          (r"constexpr int kAggKc = \d+;",
                           f"constexpr int kAggKc = {kc};"),
                          *[(pat, repl.format(q // 2)) for pat, repl in PER]]
       for q in (4, 8, 16) for kc in (8, 16)},
    "Q=16 kc=4": [(r"constexpr int kAggKc = \d+;",
                   "constexpr int kAggKc = 4;")],
    **{f"unroll={u}": [(re.escape(SUM_LOOP.format(4)), SUM_LOOP.format(u))]
       for u in (1, 8)},
    "depth=3": [(r"constexpr int kAggDepth = \d+;",
                 "constexpr int kAggDepth = 3;")],
    "Q=8 three_blocks_per_sm": [
        (r"constexpr int kAggQ = \d+;", "constexpr int kAggQ = 8;"),
        *[(pat, repl.format(4)) for pat, repl in PER],
        (re.escape(BOUND), BOUND.replace("2)", "3)"))],
    "one_block_per_sm": [(re.escape(BOUND), BOUND.replace("2)", "1)"))],
    "no_p2p_loads": [(re.escape(G_LOAD), "false")],
    "no_last_layer": [(re.escape(W_LAYER), "")],
    "no_hidden_layer": [(re.escape(HIDDEN), "")],
}
SHAPES = ((256, 8), (384, 8), (256, 33))


def ptxas(log: str) -> dict:
    """Registers and spill stores of the kernel, from a ptxas -v log."""
    props = next(part for part in log.split("Compiling entry function")[1:]
                 if KERNEL in part.splitlines()[0])
    return dict(registers=int(re.search(r"Used (\d+) registers",
                                        props).group(1)),
                spill_store_bytes=int(re.search(r"(\d+) bytes spill stores",
                                                props).group(1)))


def build_variants() -> dict:
    """Compile every variant at once; name -> (library, ptxas)."""
    OUT.mkdir(parents=True, exist_ok=True)
    src = (build.CSRC / "cost_volume.cu").read_text()
    procs = {}
    for i, (name, subs) in enumerate(VARIANTS.items()):
        text = src
        for pattern, repl in subs:
            text, count = re.subn(pattern, repl, text)
            if count != 1:
                raise RuntimeError(f"{name}: {pattern!r} found {count} times")
        cu, so = OUT / f"v{i}.cu", OUT / f"v{i}.so"
        cu.write_text(text)
        procs[name] = (so, subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o",
             str(so), str(cu)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{log}")
        lib = ctypes.CDLL(str(so))
        lib.cmflow_cv_agg.argtypes = list(
            fused._SIGNATURES["cost_volume"]["cmflow_cv_agg"])
        lib.cmflow_cv_agg.restype = ctypes.c_int
        libs[name] = (lib, ptxas(log))
    return libs


def launcher(lib, p2p, idx, zq, wn):
    """One launch of a variant's kernel, as the wrapper makes it."""
    b, n, c = p2p.shape

    def run():
        out = torch.empty_like(p2p)
        code = lib.cmflow_cv_agg(
            p2p.data_ptr(), idx.data_ptr(), zq.data_ptr(),
            *[t.data_ptr() for t in wn], out.data_ptr(), b, n, idx.shape[2],
            c, fused._stream(p2p))
        if code:
            raise RuntimeError(f"launch failed: cudaError {code}")
        return out
    return run


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip(),
        flush=True)
    dev = torch.device("cuda")
    build.build(["cost_volume"])
    own = ptxas(build.library_path("cost_volume").with_suffix(".log")
                .read_text())
    libs = build_variants()
    rs = np.random.RandomState(7)
    c, h = fused.CV_WIDTH, fused.WEIGHTNET_HIDDEN
    with torch.no_grad():
        fc = seeded(blocks.FeatureCorrelator(8, 512, 512, (512, 512, 512)),
                    3, dev)
        wn = fused.cv_params_from_variables(fc)[2][1:]
        for n, k in SHAPES:
            pc = torch.from_numpy((rs.rand(B, n, 3) * 20).astype(
                np.float32)).to(dev)
            valid = torch.from_numpy(rs.rand(B, n) > 0.2).to(dev)
            idx = neighbors.knn(k, pc, pc, valid)
            p2p = torch.from_numpy(rs.randn(B, n, c).astype(
                np.float32)).to(dev)
            zq = torch.from_numpy(rs.randn(B, n, h).astype(np.float32)).to(
                dev)
            want = fused.cost_volume_agg_plain(p2p, idx, zq, wn)
            ref = fused.cost_volume_agg(p2p, idx, zq, wn)
            runs = {"package": (lambda: fused.cost_volume_agg(
                p2p, idx, zq, wn), own)}
            runs.update({name: (launcher(lib, p2p, idx, zq, wn), regs)
                         for name, (lib, regs) in libs.items()})
            for name, (run, regs) in runs.items():
                got = run()
                torch.cuda.synchronize()
                print(json.dumps(dict(
                    variant=name, shape=f"B={B} N={n} k={k} masked",
                    ms=device_ms(run, KERNEL)[0],
                    max_abs_err=float((got.double() - want.double())
                                      .abs().max()),
                    same_bits_as_package=bool(torch.equal(got, ref)),
                    **regs)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
