#!/usr/bin/env python3
"""What holds the bf16 arms of K5, K4a, K3 and K7, ablated on one GPU.

    [ABLATE=plf,cost_volume,mse,gather] python scripts/profile_torch_bf16_tc.py [TREE]

``ABLATE`` names the sources whose arms are ablated (default: all four).

K5's bf16 arm (``csrc/plf.cu::plf_bf16_kernel``) and K4a's
(``csrc/cost_volume.cu::cv_p2p_bf16_kernel``) gather the rows of their
first layer, stream their packed bf16 weights through a ring of
shared-memory stages and multiply on ``wgmma``.  This script compiles
copies of the two sources and of ``csrc/tc_gemm.cuh`` (into
``build/bf16_tc_variants/``, with the package's nvcc flags), each of which
leaves out one part of that work:

- ``no_gathers``: every row of the first layer is formed from one constant
  row (row 0 of the gathered tensors), so the gathers hit L1;
- ``no_weight_stream``: the producer copies the first ring's worth of
  stages and then only signals each stage full again, so every later stage
  re-reads what the first copy left in shared memory (no L2 traffic for
  the weights after the first stages);
- ``no_products``: the bf16 ``wgmma`` instructions are taken out (their
  operands stay live);
- ``cluster_1``, ``cluster_2``, ``cluster_4``: each weight stage read from
  L2 by every block, or shared through multicast by clusters of two or four
  blocks (the one the source uses repeats the package's kernel);
  ``shallower_ring``: one stage fewer in the weight ring; ``no_x0_math``:
  x0 is the gathered row as it comes (no offset, affine or activation);
  ``no_proxy_fence``: no ``fence.proxy.async`` between x0's stores and the
  products that read them (K4a's); each only where the source has what it
  changes;
- ``timeline`` (sources with clusters only): block 0's first consumer
  thread reads the SM's cycle counter at the kernel's phases (the
  clusters' first barrier, the tile's rows, each stage of the products,
  the epilogue, the last barrier), and one run prints the cycles since the
  first reading instead of a time.

For K3's bf16 arm (``csrc/mse.cu::mse_bf16_kernel``): ``mse_no_gathers``
(every row reads the first point of its block's span), ``mse_no_span_math``
(the span's bases left unformed), ``mse_no_x0_math`` (x0 is the
neighbour's base as it comes: no offset, affine or activation),
``no_products`` (its ``mma.sync`` taken out too), ``mse_tiles_1``, ``_2``,
``_8`` (32-row tiles per warp); each at B=16 on both buckets, all four
scales in one call as the fused route makes it, the kernel's time beside
the whole call's (the centroids' mean included) and the count of output
values off the plain version's bits.  For K7's bf16 arm (``csrc/
gather.cu``): ``csr_cluster_1`` .. ``_16``, the CSR build's blocks per
batch element, ``csr_warps_4`` and ``_16`` (a cluster block's warps),
``csr_no_zero`` (the rows no index names left as they were),
``csr_timeline`` (block 0's cycle counter at the CSR build's phases),
``sum_fence_sc`` and ``sum_atom_release`` (the tickets' release as a
sequentially consistent fence, or as the atomic's own) and
``sum_no_tickets`` (no tickets: rows that span pieces unadded); at the 14
calls of a B=16, N=256 bf16 train step, each of its
kernels (the CSR build, the sum, and the combine in older trees) on its
own, summed per step.

Each copy is timed beside the package's own kernel on the same inputs at
B=16 on the 256 and 384 buckets (valid masks, as the fused route pads):
K5 at K = 4, 8, 16, 32 on the ball query's indices, K4a at k=8 on kNN
indices, with seeded weights rounded to bf16 and random bf16 features.
One JSON line per (kernel, shape, variant): device time from
``torch.profiler`` over 20 warmed calls (``profile_torch_tc.device_ms``,
every window checked), the max abs error against the plain version (the
ablated copies compute something else), and registers and spills of the
kernel from its ``ptxas -v`` log.

``TREE`` is the root of a checkout whose package is imported and whose
sources are ablated (default: this script's own), so that the parent's
kernels can be ablated with the same script; the substitutions know both
the parent's design (gathers in registers before each k16 step) and this
one's (the first layer formed in shared memory before the products).
Needs a CUDA device and nvcc; exits with code 1 without a device.
"""

from __future__ import annotations

import ctypes
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))

from profile_torch_tc import (  # noqa: E402
    TREE,
    B,
    device_ms,
    k7_shapes,
    seeded,
)
from cmflow_tpu_torch.data.synthetic import make_train_batch  # noqa: E402
from cmflow_tpu_torch.native import build  # noqa: E402
from cmflow_tpu_torch.nn import blocks  # noqa: E402
from cmflow_tpu_torch.ops import fused, neighbors  # noqa: E402

OUT = Path(__file__).resolve().parents[1] / "build" / "bf16_tc_variants"
BF16 = torch.bfloat16
RADII, KS = (2.0, 4.0, 8.0, 16.0), (4, 8, 16, 32)
KERNELS = {"plf": "plf_bf16_kernel", "cost_volume": "cv_p2p_bf16_kernel",
           "mse": "mse_bf16_kernel", "gather": "gather_rows_backward"}
# the kernel whose registers and spills a line reports
PTXAS_KERNEL = {**KERNELS, "gather": "gather_rows_backward_csr_kernel"}
ENTRY = {"plf": "cmflow_plf_bf16", "cost_volume": "cmflow_cv_p2p_bf16",
         "mse": "cmflow_mse_bf16", "gather": "cmflow_gather_rows_backward_bf16"}
# K7's kernels (the combine only in trees before its fold into the sum)
K7_PARTS = ("csr_kernel", "sum_kernel", "combine_kernel")
WAIT_EMPTY = (r"if \(c >= STAGES\) (mbar_wait\w*)\(&empty\[s\], "
              r"\(\(c / STAGES\) - 1\) & 1\);")
# the timeline variant: block 0's first thread keeps the cycle counter of
# its SM at numbered points in shared memory and writes them over the first
# bytes of its output at the end
TIMELINE_DECL = (
    "\n__shared__ unsigned long long tl_[48];\n"
    "#define TL(i) do { if (blockIdx.x == 0 && threadIdx.x == 0) { "
    "unsigned long long t_; asm volatile(\"mov.u64 %0, %%clock64;\" : "
    "\"=l\"(t_)); tl_[(i)] = t_; } } while (0)")
# K7's timeline: block 0's first thread keeps its SM's cycle counter at
# numbered points of the CSR build in a device array
TIMELINE_K7 = (
    "\n__device__ unsigned long long g_tl[16];\n"
    "#define TL(i) do { if (blockIdx.x == 0 && threadIdx.x == 0) { "
    "unsigned long long t_; asm volatile(\"mov.u64 %0, %%clock64;\" : "
    "\"=l\"(t_)); g_tl[(i)] = t_; } } while (0)\n")
TIMELINE_COMMON = [
    (r"(  tc::cluster_sync\(\);  // every block's barriers are initialised)",
     r"  TL(0);\n\1\n  TL(1);"),
    (r"(  tc::cluster_sync\(\);  // no block of the cluster signals this one "
     r"any more)",
     r"  TL(15);\n\1\n  if (blockIdx.x == 0 && threadIdx.x == 0) { "
     r"for (int i_ = 0; i_ < 48; ++i_) reinterpret_cast<unsigned long long*>"
     r"(out)[i_] = tl_[i_]; }"),
]
# variant -> file -> alternatives (the first whose every pattern matches
# is applied): (pattern, replacement) pairs
VARIANTS = {
    "no_gathers": {
        "plf": [
            # this design: the rows of the first layer, gathered stage by
            # stage
            [(re.escape("base4 + (int64_t)j * (kC1 / 4)"), "base4")],
            # the older one (whose float32 arm shares the text): a thread's
            # two gathered rows, read before each k16 step
            [(re.escape("base4 + (int64_t)row_j[ra] * C4"), "base4"),
             (re.escape("base4 + (int64_t)row_j[rb] * C4"), "base4")],
        ],
        "cost_volume": [
            [(re.escape("f18 + (int64_t)row_q[r] * kC8"), "f18"),
             (re.escape("f28 + (int64_t)row_j[r] * kC8"), "f28")],
            [(re.escape("f14 + (int64_t)qa * C4"), "f14"),
             (re.escape("f14 + (int64_t)qb * C4"), "f14"),
             (re.escape("f24 + (int64_t)ja * C4"), "f24"),
             (re.escape("f24 + (int64_t)jb * C4"), "f24")],
        ],
    },
    "no_weight_stream": {
        "tc_gemm": [[(WAIT_EMPTY,
                      r"if (c >= STAGES) { \1(&empty[s], "
                      r"((c / STAGES) - 1) & 1); mbar_arrive(&full[s]); "
                      r"continue; }")]],
    },
    "no_products": {
        "tc_gemm": [[(r'"wgmma\.mma_async\.sync\.aligned\.m64n\d+k16\.f32'
                      r'\.bf16\.bf16 "', '"// "'),
                     (r'"mma\.sync\.aligned\.m16n8k16\.row\.col\.f32'
                      r'\.bf16\.bf16\.f32 "', '"// "')]],
    },
    # K3 bf16: every row reads the first point's base in the span
    "mse_no_gathers": {"mse": [[(re.escape(
        "(int64_t)((row.b - b0) * n + row.j) * kPointWords"), "0")]]},
    # K3 bf16: the span's bases left unformed (each word the point's
    # first coordinate)
    "mse_no_span_math": {"mse": [[(
        r"row\[w\] = tc::pack_bf16\(base_channel\(f, d, cloud\.cf, 2 \* w, "
        r"fsm\),\s*base_channel\(f, d, cloud\.cf, 2 \* w \+ 1, fsm\)\);",
        "row[w] = __float_as_uint(d[0] + f[0]);")]]},
    # K3 bf16: x0 is the neighbour's base as it comes (no offset, affine or
    # activation)
    "mse_no_x0_math": {"mse": [[(re.escape(
        "relu_affine(base[u] - off, aff[kS0 + cc], aff[kB0 + cc])"),
        "base[u]")]]},
    **{f"mse_tiles_{n}": {"mse": [[(
        r"constexpr int kBf16TilesPerWarp = \d+;",
        f"constexpr int kBf16TilesPerWarp = {n};")]]} for n in (1, 2, 8)},
    # K7: the sum's release and acquire as sequentially consistent fences
    # (__threadfence), the release as the ticket's own (lane 0's
    # atom.add.release after the warp's barrier), and no tickets at all
    # (rows that span pieces left unadded): timings, the last not a result
    "sum_fence_sc": {"gather": [[(re.escape("fence.acq_rel.gpu;"),
                                  "fence.sc.gpu;")]]},
    "sum_atom_release": {"gather": [[
        (re.escape('asm volatile("fence.acq_rel.gpu;\\n" ::: "memory");\n'
                   '    __syncwarp();'), "__syncwarp();"),
        (re.escape("ticket = atomicAdd(tickets + ((int64_t)b * n + r) * "
                   "slices + slice, 1);"),
         'asm volatile("atom.add.release.gpu.global.s32 %0, [%1], 1;" : '
         '"=r"(ticket) : "l"(tickets + ((int64_t)b * n + r) * slices + '
         'slice) : "memory");')]]},
    "sum_no_tickets": {"gather": [[(re.escape(
        "if (!first && !(hi == cnt && tail_open)) return;\n    // release"),
        "return;\n    // release")]]},
    # K7's CSR build without its zeroed rows and tickets (a timing, not a
    # result)
    "csr_no_zero": {"gather": [[(re.escape(
        "  if (out != nullptr) {\n    for (int r = rank"),
        "  if (out == nullptr) {\n    for (int r = rank")]]},
    # K7's CSR build with block 0's cycle counter read at its phases (start,
    # counts zeroed, counted, the cluster's totals complete, the bins
    # scanned, the first positions folded, the rows zeroed, the entries
    # placed), kept in a device array that
    # cmflow_timeline copies out
    "csr_timeline": {"gather": [[
        (re.escape("#include <stdint.h>\n"),
         "#include <stdint.h>\n" + TIMELINE_K7),
        (re.escape("  constexpr int cluster = CLUSTER;\n"),
         "  constexpr int cluster = CLUSTER;\n  TL(0);\n"),
        (re.escape("  // 1. each warp counts"), "  TL(1);\n  // 1. each warp counts"),
        (re.escape("  // 2. per bin, each warp's count"),
         "  TL(2);\n  // 2. per bin, each warp's count"),
        (re.escape("  // 3. exclusive scan over the bins"),
         "  TL(3);\n  // 3. exclusive scan over the bins"),
        (re.escape("  int run = wsum[w] + inc - local;"),
         "  TL(4);\n  int run = wsum[w] + inc - local;"),
        (re.escape("  // 4. the rows no index names"), "  TL(5);\n  // 4. the rows no index names"),
        (re.escape("  // 5. each warp walks its range again"),
         "  TL(6);\n  // 5. each warp walks its range again"),
        (re.escape("      __syncwarp();\n    }\n  }\n}\n"),
         "      __syncwarp();\n    }\n  }\n  TL(7);\n}\n"),
        (re.escape('extern "C" {\n'),
         'extern "C" {\n\nint cmflow_timeline(void* dst) {\n'
         '  return (int)cudaMemcpyFromSymbol(dst, g_tl, sizeof(g_tl));\n}\n'),
    ]]},
    **{f"csr_warps_{w}": {"gather": [[(
        r"constexpr int kCsrClusterWarps = \d+;",
        f"constexpr int kCsrClusterWarps = {w};")]]} for w in (4, 16)},
    # K7: the CSR build's blocks per batch element
    **{f"csr_cluster_{r}": {"gather": [[(
        r"constexpr int kCsrCluster = \d+;",
        f"constexpr int kCsrCluster = {r};")]]} for r in (1, 2, 4, 8, 16)},
    **{f"cluster_{size}": {src: [[(r"constexpr int kBf16Cluster = \d+;",
                                   f"constexpr int kBf16Cluster = {size};")]]
                           for src in ("plf", "cost_volume")}
       for size in (1, 2, 4)},
    "no_x0_math": {
        "plf": [[(re.escape("v[h][u] = relu_affine(g4[h][u] - off, ss[u], "
                            "bb[u]);"), "v[h][u] = g4[h][u];")]],
        "cost_volume": [[(re.escape("v[e] = leaky((fa[e] + fb[e]) + bb[e]);"),
                          "v[e] = fa[e];")]],
    },
    "no_proxy_fence": {src: [[(re.escape("tc::fence_view_async();"), "")]]
                       for src in ("plf", "cost_volume")},
    "timeline": {
        "plf": [[(p, r) for p, r in TIMELINE_COMMON] + [
            (r"(constexpr int kBf16Chunks = kBf16W1Chunks \+ 1;)",
             r"\1" + TIMELINE_DECL),
            (r"(    const int rows2\[2\] = \{ra, rb\};)", r"    TL(2);\n\1"),
            (r"(    // x1 = x0 @ W1 on wgmma)", r"    TL(3);\n\1"),
            (r"(      if \(c > 0\) ring\.release\(c0 \+ c - 1\);)",
             r"\1\n      TL(4 + c);"),
            (r"(      const uint32_t st = ring\.acquire\(c0 \+ c\);)",
             r"      TL(16 + 3 * c);\n\1"),
            (r"(      if \(c \+ 1 < kBf16W1Chunks\) gather\(c \+ 1, gp\);)",
             r"      TL(17 + 3 * c);\n\1"),
            (r"(      tc::wait<1>\(\);  // the last stage's products are "
             r"done\n      tc::fence_regs\(acc\);\n      tc::fence_regs\(a)",
             r"      TL(18 + 3 * c);\n\1"),
            (r"(    ring\.release\(c0 \+ kBf16W1Chunks - 1\);)",
             r"\1\n    TL(12);"),
            (r"(      ring\.release\(c0 \+ kBf16W1Chunks\);\n    \})",
             r"\1\n    TL(13);"),
            (r"(    // max over each query's rows in this tile)",
             r"    TL(14);\n\1")]],
        "cost_volume": [[(p, r) for p, r in TIMELINE_COMMON] + [
            (r"(constexpr int kBf16Chunks1 = kC / 32;[^\n]*)",
             r"\1" + TIMELINE_DECL),
            (r"(    // x0 of rows 8rr \+ rl)", r"    TL(2);\n\1"),
            (r"(    tc::consumer_sync<kP2pConsumers>\(\);  // x0 is whole)",
             r"\1\n    TL(3);"),
            (r"(    bf16_product\(acc, ring, x0a, half, c0\);)",
             r"\1\n    TL(4);"),
            (r"(    tc::consumer_sync<kP2pConsumers>\(\);  // x1 is whole)",
             r"\1\n    TL(5);"),
            (r"(    bf16_product\(acc, ring, x1a, half, c0 \+ "
             r"kBf16Chunks1\);)", r"\1\n    TL(6);"),
            (r"(    // each thread's columns c = threadIdx\.x)",
             r"    TL(7);\n\1"),
            (r"(    if \(c > 0\) ring\.release\(c0 \+ c - 1\);)",
             r"\1\n    if (c0 + c < 32) TL(16 + c0 + c);")]],
    },
    "shallower_ring": {
        src: [[(rf"constexpr int kBf16Stages = {d};",
                f"constexpr int kBf16Stages = {d - 1};")]]
        for src, d in (("plf", 4), ("cost_volume", 3))},
}
# the arms ablated: all, or those ABLATE names (e.g. ABLATE=mse,gather)
SELECTED = [src for src in KERNELS
            if src in os.environ.get("ABLATE", ",".join(KERNELS)).split(",")]
FILES = {"plf": "plf.cu", "cost_volume": "cost_volume.cu", "mse": "mse.cu",
         "gather": "gather.cu", "tc_gemm": "tc_gemm.cuh"}
# the sources a change of tc_gemm.cuh reaches in each variant that makes one
TC_GEMM_USERS = {"no_weight_stream": ("plf", "cost_volume"),
                 "no_products": ("plf", "cost_volume", "mse")}


def ptxas(log: str, kernel: str) -> dict:
    """Registers and spill stores of ``kernel``, from a ptxas -v log."""
    props = next(part for part in log.split("Compiling entry function")[1:]
                 if kernel in part.splitlines()[0])
    return dict(registers=int(re.search(r"Used (\d+) registers",
                                        props).group(1)),
                spill_store_bytes=int(re.search(r"(\d+) bytes spill stores",
                                                props).group(1)))


def substitute(text: str, alternatives):
    """The source with the first alternative that matches applied, or None
    where none does (a variant of another design)."""
    for subs in alternatives:
        if all(re.search(p, text) for p, _ in subs):
            for p, r in subs:
                text = re.sub(p, r, text)
            return text
    return None


def build_variants(csrc: Path) -> dict:
    """Compile every variant that applies to these sources, both kernels at
    once; (variant, source) -> (library, ptxas of its bf16 kernel)."""
    sources = {k: (csrc / f).read_text() for k, f in FILES.items()}
    procs = {}
    for name, subs in VARIANTS.items():
        texts = dict(sources)
        for key, alternatives in subs.items():
            texts[key] = substitute(texts[key], alternatives)
        built = [src for src in SELECTED
                 if texts[src] is not None and texts["tc_gemm"] is not None
                 and (src in subs or src in TC_GEMM_USERS.get(name, ()))]
        if not built:
            print(json.dumps(dict(variant=name, applies=False)), flush=True)
            continue
        d = OUT / name
        d.mkdir(parents=True, exist_ok=True)
        for key, fname in FILES.items():
            if texts[key] is not None:
                (d / fname).write_text(texts[key])
        for src in built:
            so = d / f"{src}.so"
            procs[(name, src)] = (so, subprocess.Popen(
                [build._nvcc(), *build.NVCC_FLAGS, "-o", str(so),
                 str(d / FILES[src])], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True))
    libs = {}
    for (name, src), (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name} {src}:\n{log}")
        lib = ctypes.CDLL(str(so))
        fn = getattr(lib, ENTRY[src])
        fn.argtypes = list(fused._SIGNATURES[src][ENTRY[src]])
        fn.restype = ctypes.c_int
        libs[(name, src)] = (lib, fn, ptxas(log, PTXAS_KERNEL[src]))
    return libs


def plf_launcher(fn, feat_tx, idx, xyz, chain):
    """One launch of a copy's K5 bf16 arm, prepared as the wrapper
    prepares it."""
    b, n, c1 = feat_tx.shape
    wrel, s0, b0, w1, s1, b1, w2, s2, b2 = chain
    xyz_c = fused.center_xyz(xyz).contiguous()
    base = fused.make_plf_base(feat_tx, xyz_c, wrel, BF16).contiguous()
    wrel32 = wrel.float().contiguous()
    try:
        wpack = fused.tc_weights_bf16(w1, w2, from_rows=True)
    except TypeError:  # older packers always ordered w1 for gathered rows
        wpack = fused.tc_weights_bf16(w1, w2)

    def run():
        out = torch.empty((b, n, fused.PLF_WIDTHS[2]), device=xyz.device)
        code = fn(base.data_ptr(), idx.data_ptr(), xyz_c.data_ptr(),
                  wrel32.data_ptr(), s0.data_ptr(), b0.data_ptr(),
                  wpack.data_ptr(), s1.data_ptr(), b1.data_ptr(),
                  s2.data_ptr(), b2.data_ptr(), out.data_ptr(), b, n,
                  idx.shape[2], c1, fused._stream(xyz))
        if code:
            raise RuntimeError(f"launch failed: cudaError {code}")
        return out
    return run


def cv_launcher(fn, f1c, f2c, idx, z1, z2, dense, wn):
    """One launch of a copy's K4a bf16 arm, prepared as the wrapper
    prepares it."""
    b, n, c = f1c.shape
    b0, w1, b1, w2, b2 = dense
    wpack = fused.tc_weights_bf16(w1, w2)

    def run():
        out = torch.empty_like(f1c)
        code = fn(f1c.data_ptr(), f2c.data_ptr(), idx.data_ptr(),
                  z1.data_ptr(), z2.data_ptr(), b0.data_ptr(),
                  wpack.data_ptr(), b1.data_ptr(), b2.data_ptr(),
                  *[t.data_ptr() for t in wn], out.data_ptr(), b, n,
                  idx.shape[2], c, fused._stream(f1c))
        if code:
            raise RuntimeError(f"launch failed: cudaError {code}")
        return out
    return run


def mse_launcher(fn, feats, idx, xyz, packed):
    """One launch of a copy's K3 bf16 arm, prepared as the wrapper prepares
    it (a parent tree's arm takes a bf16 base and weight images its
    wrapper builds)."""
    b, n, cf = feats.shape
    s_cnt = len(idx)
    w0rel, w0feat, s0, b0, w1, s1, b1, w2, s2, b2 = packed
    ptrs = (ctypes.c_void_p * s_cnt)(*[i.data_ptr() for i in idx])
    ks = (ctypes.c_int * s_cnt)(*[i.shape[2] for i in idx])
    xyz = xyz.contiguous()

    def run():
        out = torch.empty((b, n, s_cnt * fused.MSE_WIDTHS[2]),
                          device=xyz.device)
        if hasattr(fused, "mse_bf16_weights"):  # the base built outside
            xyz_c = fused.center_xyz(xyz).contiguous()
            base = fused.make_mse_base(feats, xyz_c, w0rel, w0feat, BF16)
            frags, floats = fused.mse_bf16_weights(packed)
            code = fn(base.data_ptr(), xyz_c.data_ptr(), ptrs, ks, s_cnt,
                      frags.data_ptr(), floats.data_ptr(), out.data_ptr(), b,
                      n, fused._stream(xyz))
        else:
            ctr = xyz.mean(dim=1)
            # a tree with K3's long kernel takes its plan (no scale of
            # these is past K = 32)
            plan = (((ctypes.c_int * s_cnt)(*[0] * s_cnt), 0)
                    if len(fn.argtypes) == 26 else ())
            code = fn(xyz.data_ptr(), feats.data_ptr(), *feats.stride(), cf,
                      ctr.data_ptr(), ptrs, ks, s_cnt, *plan,
                      (ctypes.c_void_p * s_cnt)(*[w.data_ptr()
                                                  for w in w0rel]),
                      (ctypes.c_void_p * s_cnt)(*[w.data_ptr()
                                                  for w in w0feat]),
                      *[t.data_ptr() for t in (w1, w2, s0, b0, s1, b1, s2,
                                               b2)],
                      out.data_ptr(), b, n, fused._stream(xyz))
        if code:
            raise RuntimeError(f"launch failed: cudaError {code}")
        return out
    return run


def gather_bwd_launcher(lib, fn, g, idx, n):
    """One call of a copy's K7 bf16 arm, its scratch allocated as the
    wrapper allocates it (a parent tree's arm takes no tickets)."""
    b, m, c = g.shape
    vec = c % 8 == 0
    ints = lib.cmflow_gather_rows_csr_scratch(n, m)
    with_tickets = len(fn.argtypes) == 14

    def run():
        dev = g.device
        out = torch.empty((b, n, c), dtype=g.dtype, device=dev)
        offsets = torch.empty((b, n + 1), dtype=torch.int32, device=dev)
        order = torch.empty((b, m), dtype=torch.int32, device=dev)
        scratch = torch.empty((b, ints), dtype=torch.int32, device=dev)
        part = torch.empty((b, max(-(-m // 32), 1), 2, c),
                           dtype=torch.float32, device=dev)
        ptrs = [g.data_ptr(), idx.data_ptr(), offsets.data_ptr(),
                order.data_ptr(), scratch.data_ptr(), part.data_ptr()]
        if with_tickets:
            slices = lib.cmflow_gather_rows_backward_slices(
                c // 8 if vec else c)
            tickets = torch.empty((b, n, slices), dtype=torch.int32,
                                  device=dev)
            ptrs.append(tickets.data_ptr())
        code = fn(*ptrs, out.data_ptr(), b, n, m, c, int(vec),
                  fused._stream(g))
        if code:
            raise RuntimeError(f"launch failed: cudaError {code}")
        return out
    return run


def emit(src, shape, name, run, plain, regs):
    got = run()
    torch.cuda.synchronize()
    if name == "timeline":
        cycles = got.reshape(-1).view(torch.uint8)[:8 * 48].view(torch.int64)
        cycles = [int(c) for c in cycles.cpu()]
        print(json.dumps(dict(
            kernel=KERNELS[src], shape=shape, variant=name,
            cycles_since_entry={i: c - cycles[0] for i, c in enumerate(cycles)
                                if c and 0 <= c - cycles[0] < 1 << 40})),
            flush=True)
        return
    own, call, parts = device_ms(run, KERNELS[src], parts=K7_PARTS)
    row = dict(kernel=KERNELS[src], shape=shape, variant=name, ms=own,
               call_ms=call,
               max_abs_err=float((got.double() - plain.double()).abs().max()),
               plain_max_abs=float(plain.double().abs().max()), **regs)
    if src == "gather":
        row["parts_ms"] = parts
    elif plain.dtype == torch.float32:
        # output values that differ from the plain version's bits
        row["values_off_plain"] = int((got != plain).sum())
    print(json.dumps(row), flush=True)
    return row


def mse_cases(dev, regs, libs) -> None:
    """K3's bf16 arm as the fused route calls it, all four scales, at B=16
    on both buckets (masked), with seeded weights and channel-strided bf16
    features."""
    rs = np.random.RandomState(6)
    mse = seeded(blocks.MultiScaleEncoder(RADII, KS, 3, (32, 32, 64),
                                          (64, 64, 64)), 1, dev)
    packed, _ = fused.mse_narrow_params_from_variables(mse, BF16)
    for n, real in ((256, 200), (384, 300)):
        pc = torch.from_numpy((rs.rand(B, n, 3) * 20).astype(
            np.float32)).to(dev)
        valid = torch.from_numpy((rs.rand(B, n) > 0.1)
                                 & (np.arange(n) < real)).to(dev)
        feats = torch.from_numpy(rs.randn(B, 3, n).astype(np.float32)).to(
            dev).to(BF16).transpose(1, 2)
        idx = list(neighbors.ball_query_multi(RADII, KS, pc, pc, valid))
        plain = fused.fused_multi_scale_encoder_plain(feats, idx, pc, packed)
        shape = f"B={B} N={n} K={KS} masked"
        emit("mse", shape, "package",
             lambda: fused.fused_multi_scale_encoder(feats, idx, pc, packed),
             plain, regs)
        for (name, src), (_, fn, vregs) in libs.items():
            if src == "mse":
                emit("mse", shape, name,
                     mse_launcher(fn, feats, idx, pc, packed), plain, vregs)


def k7_timeline(lib, run, shape) -> None:
    """One call of the ``csr_timeline`` copy of K7: the cycles of its CSR
    build's block 0 at each phase since the first."""
    run()
    torch.cuda.synchronize()
    cycles = (ctypes.c_ulonglong * 16)()
    lib.cmflow_timeline.argtypes = [ctypes.c_void_p]
    if lib.cmflow_timeline(ctypes.addressof(cycles)):
        raise RuntimeError("cmflow_timeline failed")
    t0 = cycles[0]
    print(json.dumps(dict(kernel="gather_rows_backward_csr_kernel",
                          shape=shape, variant="csr_timeline",
                          cycles_since_entry={i: cycles[i] - t0
                                              for i in range(1, 8)})),
          flush=True)


def k7_cases(dev, regs, libs) -> None:
    """K7's bf16 arm at the 14 calls of a B=16, N=256 bf16 train step, on
    one synthetic batch's neighbours and seeded bf16 cotangents; then each
    copy's kernels summed per step."""
    batch = make_train_batch(0, B, 256)
    pc1 = torch.as_tensor(batch["pc1"], device=dev)
    pc2 = torch.as_tensor(batch["pc2"], device=dev)
    n = pc1.shape[1]
    gen = torch.Generator().manual_seed(0)
    sums = {}
    for c, idx, mult, what in k7_shapes(pc1, pc2):
        if c == 3:  # the smoothness loss's flow stays float32
            continue
        flat = idx.reshape(B, -1).contiguous()
        g = torch.randn((B, flat.shape[1], c), generator=gen).to(dev).to(BF16)
        plain = fused.gather_rows_backward_plain(g, flat, n)
        shape = f"M={flat.shape[1]} C={c} ({what})"
        runs = [("package", regs,
                 lambda: fused.gather_rows_backward(g, flat, n))]
        runs += [(name, vregs, gather_bwd_launcher(lib, fn, g, flat, n))
                 for (name, src), (lib, fn, vregs) in libs.items()
                 if src == "gather"]
        for name, r, run in runs:
            if name == "csr_timeline":
                k7_timeline(libs[(name, "gather")][0], run, shape)
                continue
            row = emit("gather", shape, name, run, plain, r)
            acc = sums.setdefault(name, dict(ms=0.0, parts_ms={}))
            acc["ms"] += mult * row["ms"]
            for part, ms in row["parts_ms"].items():
                acc["parts_ms"][part] = acc["parts_ms"].get(part, 0.0) + (
                    mult * ms)
    print(json.dumps(dict(kernel=KERNELS["gather"], per_bf16_step=sums)),
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
    csrc = Path(fused.__file__).resolve().parents[1] / "csrc"
    print(json.dumps(dict(tree=str(TREE), csrc=str(csrc))), flush=True)
    dev = torch.device("cuda")
    paths = build.build(SELECTED)
    own = {src: ptxas(paths[src].with_suffix(".log").read_text(),
                      PTXAS_KERNEL[src]) for src in SELECTED}
    libs = build_variants(csrc)
    with torch.no_grad():
        if "mse" in SELECTED:
            mse_cases(dev, own["mse"], libs)
        if "gather" in SELECTED:
            k7_cases(dev, own["gather"], libs)
    if not {"plf", "cost_volume"} & set(SELECTED):
        return 0
    rs = np.random.RandomState(5)
    with torch.no_grad():
        plf = seeded(blocks.PointLocalFeature(4.0, 8, 1027, (512, 256, 64),
                                              (64, 64, 64)), 2, dev)
        chain, _, _ = fused.plf_params_from_variables(plf)
        chain = [t.to(BF16) if i % 3 == 0 else t for i, t in enumerate(chain)]
        fc = seeded(blocks.FeatureCorrelator(8, 512, 512, (512, 512, 512)),
                    3, dev)
        dense, wn1, _ = fused.cv_params_from_variables(fc)
        dense = [t.to(BF16) if i % 2 == 0 else t
                 for i, t in enumerate(dense)][1:]
        for n, real in ((256, 200), (384, 300)):
            pc = torch.from_numpy((rs.rand(B, n, 3) * 20).astype(
                np.float32)).to(dev)
            valid = torch.from_numpy((rs.rand(B, n) > 0.1)
                                     & (np.arange(n) < real)).to(dev)

            def bf16_randn(*shape):
                return torch.from_numpy(rs.randn(*shape).astype(
                    np.float32)).to(dev).to(BF16)
            feat_tx = bf16_randn(B, n, 512)
            for idx, k in zip(neighbors.ball_query_multi(RADII, KS, pc, pc,
                                                         valid), KS):
                args = (feat_tx, idx, pc, chain)
                plain = fused.fused_point_local_feature_plain(*args)
                shape = f"B={B} N={n} K={k} masked"
                emit("plf", shape, "package",
                     lambda a=args: fused.fused_point_local_feature(*a),
                     plain, own["plf"])
                for (name, src), (_, fn, regs) in libs.items():
                    if src == "plf":
                        emit("plf", shape, name, plf_launcher(fn, *args),
                             plain, regs)
            f1c, f2c = bf16_randn(B, n, 512), bf16_randn(B, n, 512)
            z1 = torch.from_numpy(rs.randn(B, n, 8).astype(np.float32)).to(
                dev)
            z2 = torch.from_numpy(rs.randn(B, n, 8).astype(np.float32)).to(
                dev)
            idx = neighbors.knn(8, pc, pc, valid)
            args = (f1c, f2c, idx, z1, z2, dense, wn1[1:])
            plain = fused.cost_volume_p2p_plain(*args)
            shape = f"B={B} N={n} k=8 masked"
            emit("cost_volume", shape, "package",
                 lambda: fused.cost_volume_p2p(*args), plain,
                 own["cost_volume"])
            for (name, src), (_, fn, regs) in libs.items():
                if src == "cost_volume":
                    emit("cost_volume", shape, name,
                         cv_launcher(fn, *args), plain, regs)
    return 0


if __name__ == "__main__":
    sys.exit(main())
