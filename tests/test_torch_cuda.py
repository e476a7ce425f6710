"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Run them on a machine with an NVIDIA GPU and nvcc:

    python -m pytest -m cuda tests/test_torch_cuda.py

Without a CUDA device every test here skips (the check is made inside the
``dev`` fixture, when a test runs).  Tolerance for the neighbour searches and
the gather: none.  They compute squared distances in the plain versions'
float32 operation order and a gather copies, so indices and rows must be
bit-identical.  The fused kernels (sa encoder, propagation encoder, cost
volume) sum their float32 products in another order than the plain
versions' ``torch.matmul``, the sa encoder's, the propagation encoder's and
the cost volume's first kernel's as three TF32 tensor-core products each
(3xTF32, ``csrc/tc_gemm.cuh``; ``tests/test_torch_tf32.py`` gives the
argument on the CPU): they are held to a max abs error of 1e-4 and of 1e-5
times the output's largest magnitude, and to themselves bit for bit across
two launches.  The gather's backward (K7) sums
each row's cotangents in a fixed order of its own (32 sorted entries a warp,
``csrc/gather.cu``), the plain version's ``index_add_`` on the card in any
order: it is held to 1e-5 of the output's largest magnitude, and to itself
bit for bit across runs; its CSR build (``gather_rows_csr``) is integer work
and is held to its plain version exactly.  The bf16 arms of the sa encoder,
the propagation encoder and both cost-volume kernels round to bf16 where
their plain versions do, and a float32 sum in another order can flip such a
rounding by one ulp (2^-8): they are held to 1e-2 of the output's largest
magnitude, and to themselves bit for bit across two launches; the cost
volume's second kernel's bf16 arm, whose WeightNet and sums stay float32
(bf16 p2p widened exactly), is held to the float32 bars.  The gather's
bf16 arm (K6) copies bf16 rows and is held to its plain version bit for
bit; the bf16 arm of its backward (K7) sums bf16 cotangents in float32 in
its own fixed order and rounds once, the plain version sums them in float32
with ``index_add_`` and rounds once: within one bf16 ulp of each element,
and the same bits across runs.  On cotangents whose sums float32 holds
exactly in any order, both arms of K7 are held to their plain versions bit
for bit.  Kernels per call (K7 2, K3's bf16 arm at most 2) are counted in a
CUDA graph captured from one call.
"""

import copy
import ctypes

import numpy as np
import pytest
import torch

from cmflow_tpu_torch.data.synthetic import make_request, make_train_batch
from cmflow_tpu_torch.data.vod import VOD_CAMERA_PROJECTION, VOD_T_CAMERA_RADAR
from cmflow_tpu_torch.models import CMFlow, CMFlowT, RaFlow
from cmflow_tpu_torch.models.convert import export_flax_variables
from cmflow_tpu_torch.models.inference import cmflow_t_infer_seq
from cmflow_tpu_torch.nn import blocks
from cmflow_tpu_torch.ops import fused, neighbors, pointops
from cmflow_tpu_torch.train import loop
from cmflow_tpu_torch.train.state import create_train_state
from cmflow_tpu_torch.train.steps import (
    make_eval_step,
    make_train_step,
    make_train_step_seq,
)

pytestmark = pytest.mark.cuda

RADII = (2.0, 4.0, 8.0, 16.0)
KS = (4, 8, 16, 32)
FUSED_ATOL = 1e-4
FUSED_RTOL = 1e-5  # of the output's largest magnitude


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture
def rs():
    return np.random.RandomState(21)


def cloud(rs, b, n, dev, scale=20.0):
    return torch.from_numpy((rs.rand(b, n, 3) * scale).astype(np.float32)).to(dev)


def valid_mask(rs, b, n, dev):
    real = np.array([n - n // 4 - 3 * i for i in range(b)])
    m = (rs.rand(b, n) > 0.2) & (np.arange(n)[None, :] < real[:, None])
    return torch.from_numpy(m).to(dev)


def same(a, b):
    torch.cuda.synchronize()
    assert a.dtype == b.dtype and a.shape == b.shape
    assert torch.equal(a, b)


def kernels_per_call(fn):
    """The kernels, copies and memsets one call of ``fn`` puts on the card:
    the nodes of a CUDA graph captured from one call, after one call
    outside it (which builds and loads the kernels).  Not counted with
    ``torch.profiler``: on the card it records nothing in every other
    window traced back to back, and drops a window's first call when the
    process was idle before it (PERF.md §6)."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        fn()
    libcuda = ctypes.CDLL("libcuda.so.1")
    raw = ctypes.c_void_p(graph.raw_cuda_graph())
    count = ctypes.c_size_t(0)
    assert libcuda.cuGraphGetNodes(raw, None, ctypes.byref(count)) == 0
    nodes = (ctypes.c_void_p * count.value)()
    assert libcuda.cuGraphGetNodes(raw, nodes, ctypes.byref(count)) == 0
    kinds = []
    for node in nodes:
        kind = ctypes.c_int(-1)
        assert libcuda.cuGraphNodeGetType(ctypes.c_void_p(node),
                                          ctypes.byref(kind)) == 0
        kinds.append(kind.value)
    # CU_GRAPH_NODE_TYPE_KERNEL, _MEMCPY, _MEMSET
    return sum(kind in (0, 1, 2) for kind in kinds)


def exact_cotangents(rs, dev, shape, dtype=torch.float32):
    """Cotangents with at most 8 significant bits and a narrow range of
    magnitudes, whose sums float32 holds exactly in any order: the kernel
    and the plain version's ``index_add_`` must then agree bit for bit."""
    g = rs.randint(-128, 128, shape) / 64.0
    return torch.from_numpy(g.astype(np.float32)).to(dev).to(dtype)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("n", [256, 384, 512])
def test_ball_query_all_radii(dev, rs, n, masked):
    p = cloud(rs, 16, n, dev)
    v = valid_mask(rs, 16, n, dev) if masked else None
    before = neighbors.ball_query_multi.launches
    got = neighbors.ball_query_multi(RADII, KS, p, p, v)
    assert neighbors.ball_query_multi.launches == before + 1
    want = neighbors.ball_query_multi_plain(RADII, KS, p, p, v)
    for g, w in zip(got, want):
        same(g, w)
    for r, k, w in zip(RADII, KS, want):  # one radius per launch
        same(pointops.ball_query(r, k, p, p, v), w)


def test_ball_query_edge_cases(dev, rs):
    p = cloud(rs, 2, 256, dev, scale=200.0)
    far = p + 1e4
    dup = cloud(rs, 1, 32, dev).repeat(1, 8, 1)
    none_valid = torch.zeros((2, 256), dtype=torch.bool, device=dev)
    small = cloud(rs, 2, 16, dev, scale=4.0)
    for args in (((0.5,), (8,), p, p, None), ((1.0,), (4,), p, far, None),
                 (RADII, KS, dup, dup, None), ((16.0,), (8,), p, p, none_valid),
                 ((3.0,), (32,), small, small, None)):
        got = neighbors.ball_query_multi(*args)
        for g, w in zip(got, neighbors.ball_query_multi_plain(*args)):
            same(g, w)


# (N, S): clouds that fill no 32-point step, and queries that are not the
# cloud, fewer or more of them
@pytest.mark.parametrize("n, s", [(200, 200), (383, 383), (256, 100),
                                  (200, 383)])
def test_ball_query_ragged(dev, rs, n, s):
    p = cloud(rs, 4, n, dev)
    q = p[:, :s].contiguous() if s <= n else cloud(rs, 4, s, dev)
    v = valid_mask(rs, 4, n, dev)
    for args in ((RADII, KS, p, q, v), (RADII, KS, p, q, None),
                 ((16.0, 30.0), (40, 64), p, q, v)):
        got = neighbors.ball_query_multi(*args)
        for g, w in zip(got, neighbors.ball_query_multi_plain(*args)):
            same(g, w)


def test_ball_query_ragged_edge_cases(dev, rs):
    n = 383
    p, q = cloud(rs, 2, n, dev), cloud(rs, 2, 100, dev)
    none_valid = torch.zeros((2, n), dtype=torch.bool, device=dev)
    dup = cloud(rs, 1, 29, dev).repeat(2, 13, 1)  # 377 points, 13 of each
    for args in ((RADII, KS, p, q, none_valid),  # empty balls
                 (RADII, KS, dup, dup, None),
                 ((1.0,), (64,), dup, dup[:, :50].contiguous(), None),
                 ((0.3, 1.0), (32, 64), p, q, None)):  # never full
        got = neighbors.ball_query_multi(*args)
        for g, w in zip(got, neighbors.ball_query_multi_plain(*args)):
            same(g, w)


@pytest.mark.parametrize("k", [1, 8, 9, 16, 17, 32, 33, 64])
def test_knn(dev, rs, k):
    q, p = cloud(rs, 16, 256, dev), cloud(rs, 16, 384, dev)
    v = valid_mask(rs, 16, 384, dev)
    before = neighbors.knn.launches
    got = neighbors.knn(k, q, p, v)
    assert neighbors.knn.launches == before + 1
    same(got, neighbors.knn_plain(k, q, p, v))


def test_knn_ties_and_invalid_tail(dev, rs):
    base = torch.tensor([[[0.0, 0, 0], [1, 0, 0], [1, 0, 0], [2, 0, 0]]],
                        device=dev)
    p = base.repeat(1, 64, 1)
    same(neighbors.knn(8, p, p), neighbors.knn_plain(8, p, p))
    q, p = cloud(rs, 2, 128, dev), cloud(rs, 2, 256, dev)
    v = torch.arange(256, device=dev)[None, :] < torch.tensor([[5], [256]],
                                                                device=dev)
    same(neighbors.knn(8, q, p, v), neighbors.knn_plain(8, q, p, v))


@pytest.mark.parametrize("c", [3, 32, 512])
def test_gather(dev, rs, c):
    b, n, s, k = 16, 256, 256, 32
    pts = torch.from_numpy(rs.randn(b, n, c).astype(np.float32)).to(dev)
    idx = torch.from_numpy(rs.randint(0, n, (b, s, k)).astype(np.int32)).to(dev)
    idx[0, :4, 0] = torch.tensor([-1, n, n + 7, -100], dtype=torch.int32)
    before = fused.gather_rows.launches
    got = pointops.group_points(pts, idx)
    assert fused.gather_rows.launches == before + 1
    want = fused.gather_rows_plain(pts, idx.reshape(b, s * k)).reshape(
        b, s, k, c)
    same(got, want)
    assert (got[0, :4, 0] == 0).all()


def test_gather_unaligned_rows(dev, rs):
    # a contiguous view starting one float in: C % 4 == 0 but the rows are
    # not 16-byte aligned, so the kernel must take its scalar path
    buf = torch.from_numpy(rs.randn(2 * 64 * 8 + 1).astype(np.float32)).to(dev)
    pts = buf[1:].view(2, 64, 8)
    assert pts.is_contiguous() and pts.data_ptr() % 16 != 0
    idx = torch.from_numpy(rs.randint(0, 64, (2, 50)).astype(np.int32)).to(dev)
    same(fused.gather_rows(pts, idx), fused.gather_rows_plain(pts, idx))


# (S, K, C): the train step's grouped gathers at N=256 (sa encoder C=32,
# propagation encoder and cost volume C=512, smoothness loss C=3) and a
# width the float4 path does not take
GATHER_BWD_CASES = [(256, k, 32) for k in KS] + [(256, k, 512) for k in KS] + [
    (256, 8, 3), (256, 8, 512), (100, 7, 30)]


def bwd_inputs(rs, dev, b, n, s, k, c):
    g = torch.from_numpy(rs.randn(b, s * k, c).astype(np.float32)).to(dev)
    idx = torch.from_numpy(rs.randint(0, n, (b, s * k)).astype(np.int32)).to(dev)
    return g, idx


def same_twice(fn):
    """``fn()`` twice on the same inputs gives the same bits; returns the
    first result."""
    got, again = fn(), fn()
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    return got


def near_plain(got, want):
    torch.cuda.synchronize()
    assert got.dtype == want.dtype and got.shape == want.shape
    err = float((got.double() - want.double()).abs().max())
    assert err <= 1e-5 * float(want.abs().max()), err


@pytest.mark.parametrize("case", GATHER_BWD_CASES)
def test_gather_backward(dev, rs, case):
    s, k, c = case
    b, n = 16, 256
    g, idx = bwd_inputs(rs, dev, b, n, s, k, c)
    before = fused.gather_rows_backward.launches
    got = fused.gather_rows_backward(g, idx, n)
    assert fused.gather_rows_backward.launches == before + 1
    near_plain(got, fused.gather_rows_backward_plain(g, idx, n))
    again = fused.gather_rows_backward(g, idx, n)
    torch.cuda.synchronize()
    assert torch.equal(got, again)  # deterministic: no atomic adds
    # exact terms: the plain version's bits; two kernels a call
    g = exact_cotangents(rs, dev, g.shape)
    same(fused.gather_rows_backward(g, idx, n),
         fused.gather_rows_backward_plain(g, idx, n))
    assert kernels_per_call(
        lambda: fused.gather_rows_backward(g, idx, n)) == 2


def test_gather_backward_out_of_range_and_empty_rows(dev, rs):
    b, n, s, k, c = 2, 64, 40, 8, 32
    g, idx = bwd_inputs(rs, dev, b, n, s, k, c)
    idx[0, :5] = torch.tensor([-1, n, n + 9, -100, 4096], dtype=torch.int32)
    idx[idx == 3] = 2  # row 3 named by no index
    got = fused.gather_rows_backward(g, idx, n)
    near_plain(got, fused.gather_rows_backward_plain(g, idx, n))
    assert (got[:, 3] == 0).all()
    # more index rows than the kernel stages in shared memory at once
    g, idx = bwd_inputs(rs, dev, 2, 300, 300, 32, 64)
    near_plain(fused.gather_rows_backward(g, idx, 300),
               fused.gather_rows_backward_plain(g, idx, 300))


def test_group_points_autograd_on_card(dev, rs):
    """Forward K6, backward K7, only for the input that needs a gradient;
    a stride-0 expanded cotangent (the gradient of a sum) is made
    contiguous, not refused."""
    b, n, s, k, c = 4, 256, 256, 16, 512
    pts = torch.from_numpy(rs.randn(b, n, c).astype(np.float32)).to(dev)
    idx = torch.from_numpy(rs.randint(0, n, (b, s, k)).astype(np.int32)).to(dev)
    p = pts.clone().requires_grad_(True)
    before = (fused.gather_rows.launches, fused.gather_rows_backward.launches)
    pointops.group_points(p, idx).sum().backward()
    assert (fused.gather_rows.launches,
            fused.gather_rows_backward.launches) == (before[0] + 1,
                                                     before[1] + 1)
    counts = torch.zeros((b, n), device=dev).scatter_add_(
        1, idx.reshape(b, -1).long(), torch.ones((b, s * k), device=dev))
    torch.cuda.synchronize()
    assert torch.equal(p.grad, counts[..., None].expand(b, n, c))
    pointops.group_points(pts, idx)  # needs no gradient: no K7
    assert fused.gather_rows_backward.launches == before[1] + 1


# K7 on the worst skew: every index names row 0 (M = 8192, C = 512), so one
# row spans 256 warps' pieces; and every row width the kernel's lane groups
# take (C=3 and 4: groups of 4 and 1 lanes; 32: groups of 8; 512 and 2048:
# the whole warp), with M not a multiple of the 32-entry piece
@pytest.mark.parametrize("c", [3, 4, 32, 512, 2048])
def test_gather_backward_widths_and_worst_skew(dev, rs, c):
    b, n = 4, 256
    for m in (1000, 8192):
        g = torch.from_numpy(rs.randn(b, m, c).astype(np.float32)).to(dev)
        idx = torch.from_numpy(rs.randint(0, n, (b, m)).astype(np.int32)).to(dev)
        if m == 8192:
            idx[:2] = 0
        got = same_twice(lambda: fused.gather_rows_backward(g, idx, n))
        near_plain(got, fused.gather_rows_backward_plain(g, idx, n))
        if m == 8192:
            assert (got[:2, 1:] == 0).all()


# K7 past its old row width of 512 elements of the load type: C=515 on the
# scalar path (9 column slices of 64), 2052 and 4096 on the float4 path
# (513 and 1024 float4), with the worst skew and indices outside [0, N):
# within its bar of the plain version, the same bits twice, the plain
# version's bits on exact cotangents, two kernels a call
@pytest.mark.parametrize("c", [515, 2052, 4096])
def test_gather_backward_any_width(dev, rs, c):
    b, n, m = 2, 96, 700
    g = torch.from_numpy(rs.randn(b, m, c).astype(np.float32)).to(dev)
    idx = skewed_indices(rs, dev, b, n, m)
    idx[1] = 0  # one row named by every entry, over 22 pieces
    before = fused.gather_rows_backward.launches
    got = same_twice(lambda: fused.gather_rows_backward(g, idx, n))
    assert fused.gather_rows_backward.launches == before + 2
    near_plain(got, fused.gather_rows_backward_plain(g, idx, n))
    assert (got[0, 3] == 0).all() and (got[1, 1:] == 0).all()
    g = exact_cotangents(rs, dev, g.shape)
    same(fused.gather_rows_backward(g, idx, n),
         fused.gather_rows_backward_plain(g, idx, n))
    assert kernels_per_call(
        lambda: fused.gather_rows_backward(g, idx, n)) == 2


def skewed_indices(rs, dev, b, n, m):
    """Indices in [-2, N + 2), a third of them on row 0, row 3 never."""
    idx = rs.randint(-2, n + 2, (b, m)).astype(np.int32)
    idx[:, rs.rand(m) < 0.3] = 0
    idx[idx == 3] = 4
    return torch.from_numpy(idx).to(dev)


# (B, N, M): the train step's sizes, M not a multiple of 32, an empty index,
# more rows than entries, N large enough that fewer warps fit, the most rows
# a cluster sorts (2,047) and one more (one block an element), the most
# rows whose counts fit in shared memory, and from one row more on, counts
# in device scratch; then B in {1, 2, 16} at N in {200, 256, 25,599,
# 25,600, 60,000}
CSR_SHAPES = [(16, 256, 8192), (16, 256, 1024), (3, 200, 1001), (2, 64, 0),
              (2, 5000, 300), (2, 2047, 3000), (2, 2048, 3000),
              (1, 20000, 9000), (1, 25599, 700), (2, 25600, 9000),
              (3, 60000, 8192)] + [
    (b, n, 4096) for b in (1, 2, 16) for n in (200, 256, 25599, 25600,
                                             60000)]


@pytest.mark.parametrize("shape", CSR_SHAPES)
def test_gather_rows_csr(dev, rs, shape):
    b, n, m = shape
    idx = skewed_indices(rs, dev, b, n, m)
    got = fused.gather_rows_csr(idx, n)
    want = fused.gather_rows_csr_plain(idx, n)
    for g, w in zip(got, want):
        same(g, w)
    if m:  # the whole backward on the same indices, in C=4 rows
        g = torch.from_numpy(rs.randn(b, m, 4).astype(np.float32)).to(dev)
        near_plain(same_twice(lambda: fused.gather_rows_backward(g, idx, n)),
                   fused.gather_rows_backward_plain(g, idx, n))
    # both arms on exact terms (C=32, and C=8 for one bf16 vector of 8): the
    # plain version's bits, twice, in two kernels a call (one, the CSR
    # build, with no index)
    for dtype, c in ((torch.float32, 32), (torch.bfloat16, 8)):
        g = exact_cotangents(rs, dev, (b, m, c), dtype)
        same(same_twice(lambda: fused.gather_rows_backward(g, idx, n)),
             fused.gather_rows_backward_plain(g, idx, n))
        assert kernels_per_call(
            lambda: fused.gather_rows_backward(g, idx, n)) == (
                2 if m else 1)  # no sum without m


def test_gather_backward_empty_index(dev, rs):
    g = torch.zeros((2, 0, 32), device=dev)
    idx = torch.zeros((2, 0), dtype=torch.int32, device=dev)
    got = fused.gather_rows_backward(g, idx, 64)
    torch.cuda.synchronize()
    assert got.shape == (2, 64, 32) and (got == 0).all()


def bf16_ulp(x):
    """One bf16 ulp at each magnitude of ``x`` (8 significant bits)."""
    return torch.ldexp(torch.ones_like(x),
                       torch.frexp(x.float().abs()).exponent - 8)


def within_one_bf16_ulp(got, want):
    torch.cuda.synchronize()
    assert got.dtype == want.dtype == torch.bfloat16
    assert got.shape == want.shape
    g, w = got.float(), want.float()
    assert ((g - w).abs() <= bf16_ulp(torch.maximum(g.abs(), w.abs()))).all()


@pytest.mark.parametrize("c", [5, 32, 512])
def test_gather_bf16(dev, rs, c):
    """K6's bf16 arm: an exact copy of each row (8 bf16 a thread where C
    divides by 8, one otherwise), zero rows outside [0, N); a row that is
    not 16-byte aligned takes the scalar path."""
    b, n, s, k = 16, 256, 256, 32
    pts = torch.from_numpy(rs.randn(b, n, c).astype(np.float32)).to(
        dev).to(torch.bfloat16)
    idx = torch.from_numpy(rs.randint(0, n, (b, s, k)).astype(np.int32)).to(dev)
    idx[0, :4, 0] = torch.tensor([-1, n, n + 7, -100], dtype=torch.int32)
    before = (fused.gather_rows.launches, fused.gather_rows.launches_bf16)
    got = pointops.group_points(pts, idx)
    assert (fused.gather_rows.launches,
            fused.gather_rows.launches_bf16) == (before[0] + 1, before[1] + 1)
    assert got.dtype == torch.bfloat16
    want = fused.gather_rows_plain(pts, idx.reshape(b, s * k)).reshape(
        b, s, k, c)
    same(got, want)
    assert (got[0, :4, 0] == 0).all()
    buf = torch.zeros(b * n * c + 1, dtype=torch.bfloat16, device=dev)
    shifted = buf[1:].view(b, n, c)
    shifted.copy_(pts)
    assert shifted.data_ptr() % 16 != 0
    flat = idx.reshape(b, s * k)
    same(fused.gather_rows(shifted, flat), fused.gather_rows_plain(pts, flat))


@pytest.mark.parametrize("case", GATHER_BWD_CASES)
def test_gather_backward_bf16(dev, rs, case):
    """K7's bf16 arm at the bf16 train step's shapes: within one bf16 ulp of
    its plain version, the same bits twice, one launch of the bf16 arm."""
    s, k, c = case
    b, n = 16, 256
    g, idx = bwd_inputs(rs, dev, b, n, s, k, c)
    g = g.to(torch.bfloat16)
    before = (fused.gather_rows_backward.launches,
              fused.gather_rows_backward.launches_bf16)
    got = fused.gather_rows_backward(g, idx, n)
    assert (fused.gather_rows_backward.launches,
            fused.gather_rows_backward.launches_bf16) == (before[0] + 1,
                                                          before[1] + 1)
    within_one_bf16_ulp(got, fused.gather_rows_backward_plain(g, idx, n))
    again = fused.gather_rows_backward(g, idx, n)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    g = exact_cotangents(rs, dev, g.shape, torch.bfloat16)
    same(fused.gather_rows_backward(g, idx, n),
         fused.gather_rows_backward_plain(g, idx, n))
    assert kernels_per_call(
        lambda: fused.gather_rows_backward(g, idx, n)) == 2


# every width the bf16 arm's lane groups take (C=3: scalar, groups of 4
# lanes; 8: one 8-bf16 vector, groups of 1; 32: groups of 4; 30: scalar,
# the whole warp; 512 and 4096: the whole warp, 8 bf16 a lane), on the
# worst skew and with indices outside [0, N) and rows no index names
@pytest.mark.parametrize("c", [3, 8, 30, 32, 512, 4096])
def test_gather_backward_bf16_widths_and_worst_skew(dev, rs, c):
    b, n = 4, 256
    for m in (1000, 8192):
        g = torch.from_numpy(rs.randn(b, m, c).astype(np.float32)).to(
            dev).to(torch.bfloat16)
        idx = skewed_indices(rs, dev, b, n, m)
        if m == 8192:
            idx[:2] = 0
        got = same_twice(lambda: fused.gather_rows_backward(g, idx, n))
        within_one_bf16_ulp(got, fused.gather_rows_backward_plain(g, idx, n))
        assert (got[2:, 3] == 0).all()
        if m == 8192:
            assert (got[:2, 1:] == 0).all()
    # past the 4,096 bf16 the kernel once took: one warp per 512 bf16 of
    # the row (8 a lane), the same order in every column
    g = torch.from_numpy(rs.randn(1, 300, 8192).astype(np.float32)).to(
        dev).to(torch.bfloat16)
    idx = skewed_indices(rs, dev, 1, 64, 300)
    got = same_twice(lambda: fused.gather_rows_backward(g, idx, 64))
    within_one_bf16_ulp(got, fused.gather_rows_backward_plain(g, idx, 64))


def test_group_points_bf16_autograd_on_card(dev, rs):
    """A bf16 gather hands K7's bf16 arm a bf16 cotangent and gets a bf16
    gradient, one launch of each arm."""
    b, n, s, k, c = 4, 256, 256, 16, 512
    p = torch.from_numpy(rs.randn(b, n, c).astype(np.float32)).to(dev).to(
        torch.bfloat16).requires_grad_(True)
    idx = torch.from_numpy(rs.randint(0, n, (b, s, k)).astype(np.int32)).to(dev)
    before = (fused.gather_rows.launches_bf16,
              fused.gather_rows_backward.launches_bf16)
    out = pointops.group_points(p, idx)
    cot = torch.from_numpy(rs.randn(*out.shape).astype(np.float32)).to(
        dev).to(torch.bfloat16)
    out.backward(cot)
    assert (fused.gather_rows.launches_bf16,
            fused.gather_rows_backward.launches_bf16) == (before[0] + 1,
                                                          before[1] + 1)
    assert p.grad.dtype == torch.bfloat16
    within_one_bf16_ulp(p.grad, fused.gather_rows_backward_plain(
        cot.reshape(b, s * k, c), idx.reshape(b, s * k), n))


def test_bf16_train_step_on_card(dev):
    """One bf16 CMFlow train step at B=2, N=64 on the card beside the same
    step on the CPU: 17 gathers and 15 gather backwards, 14 of each on the
    bf16 arms (the bases and the point-to-patch cost; the xyz gathers and
    the smoothness loss's flow stay float32), finite items near the CPU's
    (random weights carry bf16's rounding far: within 0.1 relative)."""
    batch = make_train_batch(0, 2, 64)
    items = {}
    for where in ("cpu", "cuda"):
        model = CMFlow(dtype=torch.bfloat16)
        blocks.init_parameters(model, torch.Generator().manual_seed(3))
        model = model.to(where)
        state = create_train_state(model, steps_per_epoch=10)
        step = make_train_step("cmflow", model, VOD_CAMERA_PROJECTION,
                               VOD_T_CAMERA_RADAR)
        counters = (fused.gather_rows, fused.gather_rows_backward)
        for fn in counters:
            fn.launches = fn.launches_bf16 = 0
        items[where] = {k: float(v) for k, v in step(state, batch).items()}
        if where == "cuda":
            assert [(fn.launches, fn.launches_bf16) for fn in counters] == [
                (17, 14), (15, 14)]
            assert all(p.grad.dtype == torch.float32
                       for p in model.parameters())
    for k, v in items["cpu"].items():
        assert np.isfinite(items["cuda"][k])
        assert abs(items["cuda"][k] - v) <= 0.1 * abs(v), k


def knn_clouds(rs, dev, case):
    """The CPU design test's clouds (tests/test_torch_kernel_designs.py):
    exact ties, an invalid tail with 5 valid points, N not a multiple of 32
    with duplicate points."""
    if case == "ties":
        base = torch.tensor([[0.0, 0, 0], [1, 0, 0], [1, 0, 0], [2, 0, 0]])
        p = base.repeat(2, 50, 1).to(dev)
        return p[:, :128].contiguous(), p, None
    if case == "invalid_tail":
        p = cloud(rs, 2, 200, dev)
        v = torch.arange(200, device=dev)[None, :] < torch.tensor(
            [[5], [150]], device=dev)
        return cloud(rs, 2, 128, dev), p, v
    p = cloud(rs, 2, 77, dev)
    p[:, 40:60] = p[:, 10:30]
    return p[:, :64].contiguous(), p, None


@pytest.mark.parametrize("k", [1, 8, 33, 64])
@pytest.mark.parametrize("case", ["ties", "invalid_tail", "ragged"])
def test_knn_merge_cases(dev, rs, case, k):
    q, p, v = knn_clouds(rs, dev, case)
    same(neighbors.knn(k, q, p, v), neighbors.knn_plain(k, q, p, v))


# clouds above the 2048 points staged at a time: the scans carry from tile
# to tile
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("n", [2049, 4096])
def test_neighbors_above_one_tile(dev, rs, n, masked):
    p = cloud(rs, 4, n, dev, scale=60.0)
    v = valid_mask(rs, 4, n, dev) if masked else None
    q = p[:, ::7].contiguous()
    for k in (8, 64):
        same(neighbors.knn(k, q, p, v), neighbors.knn_plain(k, q, p, v))
    for args in ((RADII, KS, p, q, v), ((30.0, 60.0), (64, 64), p, q, v)):
        got = neighbors.ball_query_multi(*args)
        for g, w in zip(got, neighbors.ball_query_multi_plain(*args)):
            same(g, w)


# K2 past k = 64 (a block per query selects the k nearest): masked clouds
# (an invalid tail: many keys at BIG) with the query cloud a part of the
# searched one (zero distances), N above and below the 16,384 distances a
# block keeps in shared memory, k across its 2,048-rank window; the same
# bits twice, one kernel a call
@pytest.mark.parametrize("k", [65, 128, 256])
@pytest.mark.parametrize("n", [256, 1024, 3000])
def test_knn_large_k(dev, rs, n, k):
    p = cloud(rs, 4, n, dev)
    v = valid_mask(rs, 4, n, dev)
    q = p[:, ::3].contiguous()
    before = neighbors.knn.launches
    got = same_twice(lambda: neighbors.knn(k, q, p, v))
    assert neighbors.knn.launches == before + 2
    same(got, neighbors.knn_plain(k, q, p, v))
    same(neighbors.knn(k, q, p), neighbors.knn_plain(k, q, p))
    assert kernels_per_call(lambda: neighbors.knn(k, q, p, v)) == 1


@pytest.mark.parametrize("n, k", [(200, 200), (3000, 2048), (3000, 2049),
                                  (3000, 3000), (20000, 100)])
def test_knn_large_k_windows_and_unstaged(dev, rs, n, k):
    """k = N (no select), k over one window and one rank past it, all of a
    3,000-point cloud (two windows), and a cloud whose distances a block
    computes again each pass (past 16,384 points); planted ties."""
    p = cloud(rs, 2, n, dev)
    p[:, n // 2:n // 2 + 50] = p[:, :50]
    v = valid_mask(rs, 2, n, dev)
    q = p[:, :97].contiguous()
    for mask in (None, v):
        same(neighbors.knn(k, q, p, mask), neighbors.knn_plain(k, q, p, mask))
    with pytest.raises(ValueError):
        neighbors.knn(n + 1, q, p)


def test_knn_large_k_ties(dev, rs):
    for case in ("ties", "invalid_tail", "ragged"):
        q, p, v = knn_clouds(rs, dev, case)
        k = min(p.shape[1], 100)
        same(neighbors.knn(k, q, p, v), neighbors.knn_plain(k, q, p, v))


# K1 with more radii than one scan fills (MAX_RADII = 4): one launch per
# group of four
@pytest.mark.parametrize("count", [5, 6, 7, 8])
def test_ball_query_many_radii(dev, rs, count):
    radii = (0.7, 1.5, 2.0, 3.0, 4.0, 6.0, 8.0, 16.0)[:count]
    ks = (3, 4, 8, 16, 32, 40, 64, 80)[:count]
    p = cloud(rs, 16, 384, dev)
    v = valid_mask(rs, 16, 384, dev)
    q = p[:, :256].contiguous()
    before = neighbors.ball_query_multi.launches
    got = neighbors.ball_query_multi(radii, ks, p, q, v)
    assert neighbors.ball_query_multi.launches == before + 2
    again = neighbors.ball_query_multi(radii, ks, p, q, v)
    want = neighbors.ball_query_multi_plain(radii, ks, p, q, v)
    assert len(got) == count
    for g, a, w in zip(got, again, want):
        same(g, w)
        same(a, w)
    assert kernels_per_call(
        lambda: neighbors.ball_query_multi(radii, ks, p, q, v)) == 2


def test_rejects_non_contiguous(dev, rs):
    p = cloud(rs, 2, 128, dev)
    pt = p.transpose(0, 1).contiguous().transpose(0, 1)
    with pytest.raises(ValueError, match="contiguous"):
        neighbors.knn(8, pt, pt)


# ---------------------------------------------------------------------------
# the fused kernels
# ---------------------------------------------------------------------------

def near(got, want):
    torch.cuda.synchronize()
    assert got.dtype == want.dtype and got.shape == want.shape
    err = float((got.double() - want.double()).abs().max())
    scale = float(want.abs().max())
    assert scale > 0.1, scale  # not degenerate
    assert err <= FUSED_ATOL and err <= FUSED_RTOL * scale, (err, scale)


def seeded(module, dev, seed):
    """``module`` with seeded weights and BatchNorm statistics near the
    identity (activations stay of order one, as in the model), on ``dev``."""
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


# (B, N, masked): the two buckets of the serving path with padding, and a
# size that is a multiple of no tile
SHAPES = [(16, 256, True), (16, 384, True), (3, 200, False)]


def clouds(rs, b, n, masked, dev):
    pc = cloud(rs, b, n, dev)
    valid = valid_mask(rs, b, n, dev) if masked else None
    if masked:
        valid[-1] = False  # an element with no valid point: all-zero balls
    return pc, valid


@pytest.mark.parametrize("shape", SHAPES)
def test_mse_kernel(dev, rs, shape):
    b, n, masked = shape
    pc, valid = clouds(rs, b, n, masked, dev)
    # channel-strided, as the decoded and collated batch gives its features
    feats = torch.from_numpy(rs.randn(b, 3, n).astype(np.float32)).to(
        dev).transpose(1, 2)
    mse = seeded(blocks.MultiScaleEncoder(RADII, KS, 3, (32, 32, 64),
                                          (64, 64, 64)), dev, 1)
    idx = list(neighbors.ball_query_multi(RADII, KS, pc, pc, valid))
    with torch.no_grad():
        packed, _ = fused.mse_narrow_params_from_variables(mse)
        before = fused.fused_multi_scale_encoder.launches
        got = fused.fused_multi_scale_encoder(feats, idx, pc, packed)
        assert fused.fused_multi_scale_encoder.launches == before + 1
        near(got, fused.fused_multi_scale_encoder_plain(feats, idx, pc,
                                                        packed))
        # one scale per launch, every K_s
        for s in range(len(KS)):
            one = (packed[0][s:s + 1], packed[1][s:s + 1]) + tuple(
                p.reshape(len(KS), -1)[s] if p.dim() == 1 else p[s:s + 1]
                for p in packed[2:])
            near(fused.fused_multi_scale_encoder(feats, idx[s:s + 1], pc, one),
                 got[..., 64 * s:64 * (s + 1)])


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("shape", SHAPES)
def test_plf_kernel(dev, rs, shape, k):
    b, n, masked = shape
    pc, valid = clouds(rs, b, n, masked, dev)
    plf = seeded(blocks.PointLocalFeature(RADII[KS.index(k)], k, 1027,
                                          (512, 256, 64), (64, 64, 64)),
                 dev, 2)
    feat_tx = torch.from_numpy(rs.randn(b, n, 512).astype(np.float32)).to(dev)
    (idx,) = neighbors.ball_query_multi((RADII[KS.index(k)],), (k,), pc, pc,
                                        valid)
    with torch.no_grad():
        chain, _, _ = fused.plf_params_from_variables(plf)
        before = fused.fused_point_local_feature.launches
        got = fused.fused_point_local_feature(feat_tx, idx, pc, chain)
        assert fused.fused_point_local_feature.launches == before + 1
        near(got, fused.fused_point_local_feature_plain(feat_tx, idx, pc,
                                                        chain))


def strided_feats(rs, b, n, dev):
    """``[B, N, 3]`` features, channel-strided as the collated batch gives
    them."""
    return torch.from_numpy(rs.randn(b, 3, n).astype(np.float32)).to(
        dev).transpose(1, 2)


def mse_packed(dev, ks, seed):
    radii = tuple(2.0 * (i + 1) for i in range(len(ks)))
    mse = seeded(blocks.MultiScaleEncoder(radii, ks, 3, (32, 32, 64),
                                          (64, 64, 64)), dev, seed)
    with torch.no_grad():
        packed, _ = fused.mse_narrow_params_from_variables(mse)
    return packed


# K3 pads each query's rows to a power of two and takes 32-row tiles: K
# that are not powers of two, five scales in one launch, and row counts that
# fill no tile; two launches give the same bits
@pytest.mark.parametrize("shape", [(3, 200), (16, 256)])
def test_mse_kernel_ragged_k(dev, rs, shape):
    b, n = shape
    ks = (1, 3, 5, 17, 32)
    pc = cloud(rs, b, n, dev)
    feats = strided_feats(rs, b, n, dev)
    packed = mse_packed(dev, ks, 7)
    idx = [torch.from_numpy(rs.randint(0, n, (b, n, k)).astype(
        np.int32)).to(dev) for k in ks]
    with torch.no_grad():
        before = fused.fused_multi_scale_encoder.launches
        got = same_twice(lambda: fused.fused_multi_scale_encoder(
            feats, idx, pc, packed))
        assert fused.fused_multi_scale_encoder.launches == before + 2
        near(got, fused.fused_multi_scale_encoder_plain(feats, idx, pc,
                                                        packed))


def test_mse_kernel_out_of_range_rows(dev, rs):
    """An index outside [0, N) gathers a zero row of the plain version's
    folded base (the point at the cloud's centroid, no features), in any
    slot of a query, and in every slot of one."""
    b, n = 2, 200
    pc = cloud(rs, b, n, dev)
    feats = strided_feats(rs, b, n, dev)
    packed = mse_packed(dev, KS, 8)
    idx = list(neighbors.ball_query_multi(RADII, KS, pc, pc))
    for s, k in enumerate(KS):
        idx[s][0, :4, 0] = torch.tensor([-1, n, n + 7, -100],
                                        dtype=torch.int32)
        idx[s][1, 5, :] = -1
        idx[s][1, 6, k - 1] = n
    with torch.no_grad():
        got = same_twice(lambda: fused.fused_multi_scale_encoder(
            feats, idx, pc, packed))
        near(got, fused.fused_multi_scale_encoder_plain(feats, idx, pc,
                                                        packed))


# neighbour counts that leave part of the kernels' row tiles empty: K5 takes
# 128 rows per block (whole queries), K4a 64
@pytest.mark.parametrize("k", [1, 3, 33, 64])
@pytest.mark.parametrize("shape", [(16, 256, True), (3, 200, False)])
def test_plf_kernel_partial_tiles(dev, rs, shape, k):
    b, n, _ = shape
    pc = cloud(rs, b, n, dev)
    plf = seeded(blocks.PointLocalFeature(8.0, k, 1027, (512, 256, 64),
                                          (64, 64, 64)), dev, 6)
    feat_tx = torch.from_numpy(rs.randn(b, n, 512).astype(np.float32)).to(dev)
    # random neighbours, some outside [0, N): those gather a zero row
    idx = torch.from_numpy(rs.randint(-2, n + 2, (b, n, k)).astype(
        np.int32)).to(dev)
    with torch.no_grad():
        chain, _, _ = fused.plf_params_from_variables(plf)
        got = same_twice(lambda: fused.fused_point_local_feature(
            feat_tx, idx, pc, chain))
        near(got, fused.fused_point_local_feature_plain(feat_tx, idx, pc,
                                                        chain))


@pytest.mark.parametrize("k", [1, 5, 32])
def test_cost_volume_p2p_partial_tiles(dev, rs, k):
    shape = (16, 256, True)
    f, _, _, z, dense, wn1, _ = cost_volume_inputs(rs, shape, dev)
    pc1, _ = clouds(rs, *shape, dev)
    pc2, v2 = clouds(rs, *shape, dev)
    idx2 = neighbors.knn(k, pc1, pc2, v2)
    args = (f[0], f[1], idx2, z[0], z[1], dense[1:], wn1[1:])
    with torch.no_grad():
        got = same_twice(lambda: fused.cost_volume_p2p(*args))
        near(got, fused.cost_volume_p2p_plain(*args))


def cost_volume_inputs(rs, shape, dev):
    b, n, masked = shape
    pc1, v1 = clouds(rs, b, n, masked, dev)
    pc2, v2 = clouds(rs, b, n, masked, dev)
    fc = seeded(blocks.FeatureCorrelator(8, 512, 512, (512, 512, 512)),
                dev, 3)
    f = [torch.from_numpy(rs.randn(b, n, 512).astype(np.float32)).to(dev)
         for _ in range(2)]
    with torch.no_grad():
        dense, wn1, wn2 = fused.cv_params_from_variables(fc)
    idx2 = neighbors.knn(8, pc1, pc2, v2)
    idx1 = neighbors.knn(8, pc1, pc1, v1)
    z = [torch.from_numpy(rs.randn(b, n, 8).astype(np.float32)).to(dev)
         for _ in range(2)]
    return f, idx1, idx2, z, dense, wn1, wn2


@pytest.mark.parametrize("shape", SHAPES)
def test_cost_volume_kernels(dev, rs, shape):
    f, idx1, idx2, z, dense, wn1, wn2 = cost_volume_inputs(rs, shape, dev)
    with torch.no_grad():
        before = (fused.cost_volume_p2p.launches,
                  fused.cost_volume_agg.launches)
        p2p = fused.cost_volume_p2p(f[0], f[1], idx2, z[0], z[1], dense[1:],
                                    wn1[1:])
        near(p2p, fused.cost_volume_p2p_plain(f[0], f[1], idx2, z[0], z[1],
                                              dense[1:], wn1[1:]))
        agg = fused.cost_volume_agg(p2p, idx1, z[0], wn2[1:])
        near(agg, fused.cost_volume_agg_plain(p2p, idx1, z[0], wn2[1:]))
        assert (fused.cost_volume_p2p.launches,
                fused.cost_volume_agg.launches) == (before[0] + 1,
                                                    before[1] + 1)


@pytest.mark.parametrize("k", [1, 5, 8, 17, 32, 33, 64])
@pytest.mark.parametrize("b", [1, 16])
@pytest.mark.parametrize("n", [200, 256, 384, 1000])
def test_cost_volume_agg_any_k(dev, rs, n, b, k):
    """K4b takes any K (chunks of neighbours, a ragged last query tile):
    masked kNN indices, three out of range, against its plain version, the
    same bits on two launches, one launch a call."""
    pc, valid = cloud(rs, b, n, dev), valid_mask(rs, b, n, dev)
    idx = neighbors.knn(k, pc, pc, valid)
    idx[0, :3, 0] = torch.tensor([-1, n, 4096], dtype=torch.int32)
    p2p = torch.from_numpy(rs.randn(b, n, 512).astype(np.float32)).to(dev)
    zq = torch.from_numpy(rs.randn(b, n, 8).astype(np.float32)).to(dev)
    fc = seeded(blocks.FeatureCorrelator(8, 512, 512, (512, 512, 512)),
                dev, 3)
    with torch.no_grad():
        wn = fused.cv_params_from_variables(fc)[2][1:]
        before = fused.cost_volume_agg.launches
        got = same_twice(lambda: fused.cost_volume_agg(p2p, idx, zq, wn))
        assert fused.cost_volume_agg.launches == before + 2
        near(got, fused.cost_volume_agg_plain(p2p, idx, zq, wn))


def test_fused_kernels_zero_rows_out_of_range(dev, rs):
    """An index outside [0, N) gathers a zero row, as in the plain
    versions (and the JAX package's one-hot gather)."""
    shape = (2, 200, False)
    f, idx1, idx2, z, dense, wn1, wn2 = cost_volume_inputs(rs, shape, dev)
    for idx in (idx1, idx2):
        idx[0, :3, 0] = torch.tensor([-1, 200, 1000], dtype=torch.int32)
    with torch.no_grad():
        near(fused.cost_volume_p2p(f[0], f[1], idx2, z[0], z[1], dense[1:],
                                   wn1[1:]),
             fused.cost_volume_p2p_plain(f[0], f[1], idx2, z[0], z[1],
                                         dense[1:], wn1[1:]))
        near(fused.cost_volume_agg(f[0], idx1, z[0], wn2[1:]),
             fused.cost_volume_agg_plain(f[0], idx1, z[0], wn2[1:]))
        plf = seeded(blocks.PointLocalFeature(4.0, 8, 1027, (512, 256, 64),
                                              (64, 64, 64)), dev, 4)
        chain, _, _ = fused.plf_params_from_variables(plf)
        pc = cloud(rs, 2, 200, dev)
        idx = neighbors.ball_query_multi((4.0,), (8,), pc, pc)[0]
        idx[1, -3:, 2] = torch.tensor([-5, 200, 4096], dtype=torch.int32)
        near(fused.fused_point_local_feature(f[0], idx, pc, chain),
             fused.fused_point_local_feature_plain(f[0], idx, pc, chain))


# ---------------------------------------------------------------------------
# the bf16 arms (bf16 serving)
# ---------------------------------------------------------------------------

BF16 = torch.bfloat16
BF16_RTOL = 1e-2  # of the output's largest magnitude


def near_bf16(got, want):
    torch.cuda.synchronize()
    assert got.dtype == want.dtype and got.shape == want.shape
    err = float((got.double() - want.double()).abs().max())
    scale = float(want.double().abs().max())
    assert scale > 0.1, scale  # not degenerate
    assert err <= BF16_RTOL * scale, (err, scale)


def bf16_mse_packed(dev, ks, seed, cf=3):
    radii = tuple(2.0 * (i + 1) for i in range(len(ks)))
    mse = seeded(blocks.MultiScaleEncoder(radii, ks, cf, (32, 32, 64),
                                          (64, 64, 64)), dev, seed)
    with torch.no_grad():
        packed, _ = fused.mse_narrow_params_from_variables(mse, BF16)
    return packed


def bf16_feats(rs, b, n, cf, dev):
    """``[B, N, Cf]`` bf16 features, channel-strided as collated."""
    return torch.from_numpy(rs.randn(b, cf, n).astype(np.float32)).to(
        dev).to(BF16).transpose(1, 2)


# the two buckets with padding and a size that is a multiple of no tile, at
# the sa encoder's Cf = 3 and at the most the kernel takes, 5; a call is at
# most two kernels, the centroids' mean and the kernel
@pytest.mark.parametrize("cf", [3, 5])
@pytest.mark.parametrize("shape", SHAPES)
def test_mse_bf16_kernel(dev, rs, shape, cf):
    b, n, masked = shape
    pc, valid = clouds(rs, b, n, masked, dev)
    feats = bf16_feats(rs, b, n, cf, dev)
    packed = bf16_mse_packed(dev, KS, 1, cf)
    idx = list(neighbors.ball_query_multi(RADII, KS, pc, pc, valid))
    with torch.no_grad():
        before = fused.fused_multi_scale_encoder.launches
        got = same_twice(lambda: fused.fused_multi_scale_encoder(
            feats, idx, pc, packed))
        assert fused.fused_multi_scale_encoder.launches == before + 2
        assert got.dtype == torch.float32
        near_bf16(got, fused.fused_multi_scale_encoder_plain(feats, idx, pc,
                                                             packed))
        assert kernels_per_call(lambda: fused.fused_multi_scale_encoder(
            feats, idx, pc, packed)) <= 2


@pytest.mark.parametrize("cf", [3, 5])
def test_mse_bf16_kernel_ragged_k_and_out_of_range(dev, rs, cf):
    """K that are not powers of two, five scales in one launch, a row count
    that fills no tile, and indices outside [0, N) (a zero row of the bf16
    base), at B=3 and at both buckets' B=16; and one cloud of more points
    than a block forms in shared memory (each row forms its neighbour's
    base itself)."""
    ks = (1, 3, 5, 17, 32)
    packed = bf16_mse_packed(dev, ks, 7, cf)
    for b, n in ((3, 200), (16, 256), (16, 384), (2, 2100)):
        pc = cloud(rs, b, n, dev)
        feats = bf16_feats(rs, b, n, cf, dev)
        idx = [torch.from_numpy(rs.randint(-2, n + 2, (b, n, k)).astype(
            np.int32)).to(dev) for k in ks]
        with torch.no_grad():
            got = same_twice(lambda: fused.fused_multi_scale_encoder(
                feats, idx, pc, packed))
            near_bf16(got, fused.fused_multi_scale_encoder_plain(
                feats, idx, pc, packed))


def bf16_chain(plf):
    with torch.no_grad():
        chain, _, _ = fused.plf_params_from_variables(plf)
    return [t.to(BF16) if i % 3 == 0 else t for i, t in enumerate(chain)]


# the bf16 arm of K4a runs in clusters of two blocks (a block with no rows
# pads the grid): both buckets at B=16, and 603 rows, which leave an odd
# number of blocks at most K
BF16_SHAPES = [(16, 256, True), (16, 384, True), (3, 201, False)]


@pytest.mark.parametrize("k", (1, 3, *KS, 33, 64, 65, 100, 128, 129, 200))
@pytest.mark.parametrize("shape", BF16_SHAPES)
def test_plf_bf16_kernel(dev, rs, shape, k):
    """K5's bf16 arm at every K of the model, at K that leave part of its
    128-row tiles empty, and at any K past them (a query's rows over two
    tiles at 129 and 200); random neighbours, some outside [0, N); the same
    bits on two runs."""
    b, n, masked = shape
    pc, _ = clouds(rs, b, n, masked, dev)
    plf = seeded(blocks.PointLocalFeature(8.0, k, 1027, (512, 256, 64),
                                          (64, 64, 64)), dev, 2)
    feat_tx = torch.from_numpy(rs.randn(b, n, 512).astype(np.float32)).to(
        dev).to(BF16)
    idx = torch.from_numpy(rs.randint(-2, n + 2, (b, n, k)).astype(
        np.int32)).to(dev)
    chain = bf16_chain(plf)
    with torch.no_grad():
        before = fused.fused_point_local_feature.launches
        got = same_twice(lambda: fused.fused_point_local_feature(
            feat_tx, idx, pc, chain))
        assert fused.fused_point_local_feature.launches == before + 2
        assert got.dtype == torch.float32
        near_bf16(got, fused.fused_point_local_feature_plain(feat_tx, idx, pc,
                                                             chain))


def bf16_cost_volume_inputs(rs, shape, dev):
    f, idx1, idx2, z, dense, wn1, wn2 = cost_volume_inputs(rs, shape, dev)
    dense = [t.to(BF16) if i % 2 == 0 else t for i, t in enumerate(dense)]
    return [x.to(BF16) for x in f], idx1, idx2, z, dense, wn1, wn2


def p2p_indices(rs, shape, k, dev):
    """Frame-2 neighbours of K4a: kNN where K2 takes k (<= 64), else
    random; three outside [0, N)."""
    b, n, _ = shape
    if k <= 64:
        pc1, _ = clouds(rs, *shape, dev)
        pc2, v2 = clouds(rs, *shape, dev)
        idx2 = neighbors.knn(k, pc1, pc2, v2)
    else:
        idx2 = torch.from_numpy(rs.randint(0, n, (b, n, k)).astype(
            np.int32)).to(dev)
    idx2[0, :3, 0] = torch.tensor([-1, n, 4096], dtype=torch.int32)
    return idx2


@pytest.mark.parametrize("k", [8, 33, 64, 65, 100])
@pytest.mark.parametrize("shape", BF16_SHAPES)
def test_cost_volume_bf16_kernels(dev, rs, shape, k):
    """K4a's bf16 arm (bf16 f1c/f2c in, bf16 p2p out) at the forward's k=8
    and past its old K <= 32 (a query's rows over two tiles at 65 and 100),
    and K4b's (bf16 p2p in, float32 out, at the float32 bars), each against
    its plain version on the same inputs and against itself bit for bit."""
    f, idx1, idx2, z, dense, wn1, wn2 = bf16_cost_volume_inputs(rs, shape,
                                                                dev)
    if k != 8:
        idx2 = p2p_indices(rs, shape, k, dev)
    with torch.no_grad():
        before = (fused.cost_volume_p2p.launches,
                  fused.cost_volume_agg.launches)
        args = (f[0], f[1], idx2, z[0], z[1], dense[1:], wn1[1:])
        p2p = same_twice(lambda: fused.cost_volume_p2p(*args))
        assert p2p.dtype == BF16
        near_bf16(p2p, fused.cost_volume_p2p_plain(*args))
        agg = same_twice(lambda: fused.cost_volume_agg(p2p, idx1, z[0],
                                                       wn2[1:]))
        assert agg.dtype == torch.float32
        near(agg, fused.cost_volume_agg_plain(p2p, idx1, z[0], wn2[1:]))
        assert (fused.cost_volume_p2p.launches,
                fused.cost_volume_agg.launches) == (before[0] + 2,
                                                    before[1] + 2)


def whole_tiles(rows):
    """A bf16 wrapper's plan replaced by tiles of whole queries (``rows //
    k`` queries a block, or one query over several tiles), the layout of
    the bf16 arms before they ran full tiles."""
    def plan(total, k, *args):
        qpb = max(1, rows // k)
        return dict(qpb=qpb, tiles=-(-qpb * k // rows))
    return plan


@pytest.mark.parametrize("k", [5, 8, 12, 33, 48, 64, 65, 100, 130])
@pytest.mark.parametrize("shape", [(16, 256, True), (3, 201, False)])
def test_cost_volume_p2p_bf16_full_tiles_keep_the_bits(dev, rs, shape, k,
                                                       monkeypatch):
    """K4a's bf16 arm in full tiles (``cv_p2p_bf16_kernel`` on
    ``cv_p2p_plan``: full 64-row tiles across query boundaries, each
    query's sums carried from tile to tile) gives the bits of tiles of
    whole queries at every k, also on a grid padded to whole clusters (603
    queries), and counts each call in ``launches_full`` and
    ``launches_full_bf16``."""
    f, _, _, z, dense, wn1, _ = bf16_cost_volume_inputs(rs, shape, dev)
    idx2 = p2p_indices(rs, shape, k, dev)
    args = (f[0], f[1], idx2, z[0], z[1], dense[1:], wn1[1:])
    wrapper = fused.cost_volume_p2p
    with torch.no_grad():
        before = (wrapper.launches_full, wrapper.launches_full_bf16)
        full = same_twice(lambda: wrapper(*args))
        assert (wrapper.launches_full, wrapper.launches_full_bf16) == (
            before[0] + 2, before[1] + 2)
        monkeypatch.setattr(fused, "cv_p2p_plan",
                            whole_tiles(fused.CV_P2P_ROWS))
        assert torch.equal(full, wrapper(*args))
        near_bf16(full, fused.cost_volume_p2p_plain(*args))


@pytest.mark.parametrize("k", [3, 8, 24, 32, 33, 48, 65, 100, 128, 160, 200])
@pytest.mark.parametrize("shape", [(16, 256, True), (3, 201, False)])
def test_plf_bf16_full_tiles_keep_the_bits(dev, rs, shape, k, monkeypatch):
    """K5's bf16 arm in full tiles (``plf_bf16_kernel`` on ``plf_plan``:
    full 128-row tiles across query boundaries, the running max of the
    query that runs on carried) gives the bits of tiles of whole queries
    at every K, and counts each call in ``launches_full``."""
    b, n, masked = shape
    pc, _ = clouds(rs, b, n, masked, dev)
    plf = seeded(blocks.PointLocalFeature(8.0, k, 1027, (512, 256, 64),
                                          (64, 64, 64)), dev, 3)
    feat_tx = torch.from_numpy(rs.randn(b, n, 512).astype(np.float32)).to(
        dev).to(BF16)
    idx = torch.from_numpy(rs.randint(-2, n + 2, (b, n, k)).astype(
        np.int32)).to(dev)
    chain = bf16_chain(plf)
    wrapper = fused.fused_point_local_feature
    with torch.no_grad():
        before = wrapper.launches_full
        full = same_twice(lambda: wrapper(feat_tx, idx, pc, chain))
        assert wrapper.launches_full == before + 2
        monkeypatch.setattr(fused, "plf_plan", whole_tiles(fused.PLF_ROWS))
        assert torch.equal(full, wrapper(feat_tx, idx, pc, chain))
        near_bf16(full, fused.fused_point_local_feature_plain(
            feat_tx, idx, pc, chain))


@pytest.mark.parametrize("k", [1, 5, 32, 33, 64, 65, 100])
@pytest.mark.parametrize("shape", [(16, 256, True), (3, 201, False)])
def test_cost_volume_p2p_bf16_partial_tiles(dev, rs, shape, k):
    """K4a's bf16 arm at k that leave part of its 64-row tiles empty and
    past them, with an odd number of blocks (603 rows at k = 5, 33, 65,
    100); three indices outside [0, N)."""
    f, _, _, z, dense, wn1, _ = bf16_cost_volume_inputs(rs, shape, dev)
    idx2 = p2p_indices(rs, shape, k, dev)
    args = (f[0], f[1], idx2, z[0], z[1], dense[1:], wn1[1:])
    with torch.no_grad():
        got = same_twice(lambda: fused.cost_volume_p2p(*args))
        near_bf16(got, fused.cost_volume_p2p_plain(*args))


@pytest.mark.parametrize("k", [1, 8, 33, 65])
@pytest.mark.parametrize("n", [200, 256, 384])
@pytest.mark.parametrize("b", [1, 16])
def test_cost_volume_agg_bf16_any_k(dev, rs, b, n, k):
    """K4b's bf16 arm (the float32 arm's body on bf16 p2p: 16-query
    tiles, neighbours in chunks of 8, float32 sums on the CUDA cores) at k
    up to 65, N with a ragged last tile (200) and without, one batch
    element and sixteen; kNN indices (random ones past the kNN's k <= 64),
    three of them outside [0, N); the same bits twice; its WeightNet and
    sums are float32, so it is held to the float32 bars."""
    pc, valid = cloud(rs, b, n, dev), valid_mask(rs, b, n, dev)
    if k <= neighbors.MAX_K:
        idx = neighbors.knn(k, pc, pc, valid)
    else:
        idx = torch.from_numpy(rs.randint(0, n, (b, n, k)).astype(
            np.int32)).to(dev)
    idx[0, :3, 0] = torch.tensor([-1, n, 4096], dtype=torch.int32)
    p2p = torch.from_numpy(rs.randn(b, n, 512).astype(np.float32)).to(
        dev).to(BF16)
    zq = torch.from_numpy(rs.randn(b, n, 8).astype(np.float32)).to(dev)
    fc = seeded(blocks.FeatureCorrelator(8, 512, 512, (512, 512, 512)),
                dev, 3)
    with torch.no_grad():
        wn = fused.cv_params_from_variables(fc)[2][1:]
        got = same_twice(lambda: fused.cost_volume_agg(p2p, idx, zq, wn))
        near(got, fused.cost_volume_agg_plain(p2p, idx, zq, wn))


def test_bf16_arms_reject_mixed_dtypes(dev, rs):
    """A bf16 arm takes its bases, features and Dense weights all in bf16;
    a mix raises before any launch, as does a bf16 tensor where the arm
    takes float32."""
    shape = (2, 200, False)
    f, idx1, idx2, z, dense, wn1, wn2 = bf16_cost_volume_inputs(rs, shape,
                                                                dev)
    with torch.no_grad():
        with pytest.raises(TypeError, match="all float32 or all bfloat16"):
            fused.cost_volume_p2p(f[0].float(), f[1], idx2, z[0], z[1],
                                  dense[1:], wn1[1:])
        with pytest.raises(TypeError, match="float32"):
            fused.cost_volume_agg(f[0], idx1, z[0].to(BF16), wn2[1:])


def test_fused_route_bf16(dev):
    """``make_eval_step`` with ``compute_dtype=torch.bfloat16`` on the card:
    the fused route launches what the float32 one does (2/2/2/1/1/4) and
    agrees with the same bf16 forward on the CPU (every kernel's plain
    version) at the JAX package's bf16 bars: stat_cls 3e-2, pre_trans
    1e-2, masks on >= 99% of the valid points, sf_agg within 0.05 of
    max(|sf|, 1)."""
    req = make_request(4, 16, (200, 256))
    model = seeded(CMFlow(), dev, 12).eval()
    cpu = copy.deepcopy(model).to("cpu")
    counters = (neighbors.ball_query_multi, neighbors.knn,
                fused.fused_multi_scale_encoder, fused.cost_volume_p2p,
                fused.cost_volume_agg, fused.fused_point_local_feature)
    before = [c.launches for c in counters]
    out = make_eval_step("cmflow", model, compute_dtype=BF16)(req)
    assert [c.launches - b for c, b in zip(counters, before)] == [
        2, 2, 2, 1, 1, 4]
    ref = make_eval_step("cmflow", cpu, fused="on", compute_dtype=BF16)(req)
    (sf, cls, trans, mask), (rsf, rcls, rtrans, rmask) = (
        [x.cpu().numpy() for x in o] for o in (out, ref))
    valid = req["valid1"]
    assert np.abs(cls - rcls)[valid].max() <= 3e-2
    assert np.abs(trans - rtrans).max() <= 1e-2
    assert (mask == rmask)[valid].mean() >= 0.99
    assert np.abs(sf - rsf)[valid].max() <= 0.05 * max(
        np.abs(rsf[valid]).max(), 1.0)


def test_fused_kernels_reject_other_widths(dev, rs):
    """A chain the tuned K5 is not written for, (128, 64, 32), no longer
    raises: it takes the generic kernel (one launch, counted as the
    generic arm's) and meets its plain version."""
    plf = seeded(blocks.PointLocalFeature(4.0, 8, 64, (128, 64, 32),
                                          (32, 32, 32)), dev, 5)
    pc = cloud(rs, 2, 64, dev)
    idx = neighbors.ball_query_multi((4.0,), (8,), pc, pc)[0]
    feat_tx = torch.from_numpy(rs.randn(2, 64, 128).astype(np.float32)).to(
        dev)
    with torch.no_grad():
        chain, _, _ = fused.plf_params_from_variables(plf)
        assert fused.plf_arm((128, 64, 32)) == fused.GENERIC
        before = (fused.fused_point_local_feature.launches,
                  fused.fused_point_local_feature.launches_generic)
        got = fused.fused_point_local_feature(feat_tx, idx, pc, chain)
        assert (fused.fused_point_local_feature.launches,
                fused.fused_point_local_feature.launches_generic) == (
                    before[0] + 1, before[1] + 1)
        near(got, fused.fused_point_local_feature_plain(feat_tx, idx, pc,
                                                        chain))


# ---------------------------------------------------------------------------
# every shape the JAX package takes: the tuned arms past their old K, and
# the generic kernel (csrc/chain.cu) at every other width
# ---------------------------------------------------------------------------

DTYPES = [torch.float32, BF16]


def near_arm(got, want, dtype):
    """The bars of the arm of ``dtype``: float32 (1e-4, 1e-5 of the largest
    magnitude), or bf16 (1e-2 of it)."""
    (near if dtype == torch.float32 else near_bf16)(got, want)


def mse_encoder(dev, ks, widths, cf, dtype, seed):
    radii = tuple(2.0 * (i + 1) for i in range(len(ks)))
    mse = seeded(blocks.MultiScaleEncoder(radii, ks, cf, widths,
                                          (64, 64, 64)), dev, seed)
    with torch.no_grad():
        packed, _ = fused.mse_narrow_params_from_variables(mse, dtype)
    return packed


def random_idx(rs, b, n, k, dev):
    """``[B, N, K]`` random neighbours, some outside [0, N)."""
    return torch.from_numpy(rs.randint(-2, n + 2, (b, n, k)).astype(
        np.int32)).to(dev)


# K3 past K = 32, both arms (csrc/mse.cu::mse_long_kernel,
# mse_bf16_long_kernel): a query's rows in 16-row units one after another,
# four queries a 64-row wgmma step.  (K of each scale, B, N, Cf, the
# indices: "random" with some outside [0, N), or all "outside", or
# "signs": random, the affines' scales of both signs, as a trained
# BatchNorm's may be): mixed with K <= 32 scales (two kernels in one call)
# and alone, a ragged last quad (B*N not a multiple of 4 queries a block),
# zero rows only, no features and five, eight scales of both kinds, and a
# cloud of 4,096 points (no span: each row gathers its point)
PAST_K = [((8, 16, 32, 64), 16, 256, 3, "random"),
          ((40,), 1, 4096, 3, "signs"),
          ((8, 16, 32, 64), 16, 256, 3, "signs"),
          ((100,), 16, 256, 5, "signs"),
          ((48,), 16, 256, 3, "random"),
          ((100,), 16, 256, 3, "random"),
          ((33, 1, 200), 16, 256, 3, "random"),
          ((64,), 16, 256, 3, "random"),
          ((33,), 16, 256, 3, "random"),
          ((48, 4, 64), 3, 200, 3, "random"),
          ((64,), 16, 256, 3, "outside"),
          ((48, 16), 16, 256, 0, "random"),
          ((64, 8), 16, 256, 5, "random"),
          ((4, 33, 8, 48, 16, 64, 32, 100), 16, 256, 3, "random")]


@pytest.mark.parametrize("case", PAST_K)
@pytest.mark.parametrize("dtype", DTYPES)
def test_mse_kernel_past_k(dev, rs, dtype, case):
    ks, b, n, cf, kind = case
    pc = cloud(rs, b, n, dev)
    feats = torch.from_numpy(rs.randn(b, cf, n).astype(np.float32)).to(
        dev).to(dtype).transpose(1, 2)
    packed = mse_encoder(dev, ks, (32, 32, 64), cf, dtype, 9)
    if kind == "signs":
        packed = tuple(
            t * torch.from_numpy(rs.choice([-1.0, 1.0], t.shape).astype(
                np.float32)).to(dev) if i in (2, 5, 8) else t
            for i, t in enumerate(packed))
    if kind == "outside":
        idx = [torch.from_numpy(rs.choice([-2, -1, n, n + 1], (b, n, k))
                                .astype(np.int32)).to(dev) for k in ks]
    else:
        idx = [random_idx(rs, b, n, k, dev) for k in ks]
    assert fused.mse_arm((32, 32, 64), len(ks), cf) == fused.TUNED
    wrapper = fused.fused_multi_scale_encoder
    with torch.no_grad():
        before = (wrapper.launches, wrapper.launches_generic,
                  wrapper.launches_long)
        got = same_twice(lambda: wrapper(feats, idx, pc, packed))
        # two calls, the long kernel in each where a scale is past 32
        assert (wrapper.launches, wrapper.launches_generic,
                wrapper.launches_long) == (
                    before[0] + 2, before[1],
                    before[2] + 2 * (max(ks) > 32))
        near_arm(got, fused.fused_multi_scale_encoder_plain(
            feats, idx, pc, packed), dtype)


@pytest.mark.parametrize("k", [65, 128, 129, 160, 300])
def test_plf_kernel_past_k(dev, rs, k):
    """K5's float32 arm past its old K <= 64: 128-row tiles of one query
    above 64 (up to 128) and a query over several tiles above 128, its max
    carried; the same bits twice."""
    b, n = 16, 256
    pc = cloud(rs, b, n, dev)
    plf = seeded(blocks.PointLocalFeature(8.0, k, 1027, (512, 256, 64),
                                          (64, 64, 64)), dev, 6)
    feat_tx = torch.from_numpy(rs.randn(b, n, 512).astype(np.float32)).to(dev)
    idx = random_idx(rs, b, n, k, dev)
    with torch.no_grad():
        chain, _, _ = fused.plf_params_from_variables(plf)
        got = same_twice(lambda: fused.fused_point_local_feature(
            feat_tx, idx, pc, chain))
        near(got, fused.fused_point_local_feature_plain(feat_tx, idx, pc,
                                                        chain))


@pytest.mark.parametrize("k", [33, 48, 64, 65, 100, 129])
def test_cost_volume_p2p_past_k(dev, rs, k):
    """K4a's float32 arm past its old K <= 32: one query a 64-row tile up
    to 64, over several tiles above, its sums carried in registers; the
    same bits twice."""
    shape = (16, 256, True)
    f, _, _, z, dense, wn1, _ = cost_volume_inputs(rs, shape, dev)
    idx2 = p2p_indices(rs, shape, k, dev)
    args = (f[0], f[1], idx2, z[0], z[1], dense[1:], wn1[1:])
    with torch.no_grad():
        got = same_twice(lambda: fused.cost_volume_p2p(*args))
        near(got, fused.cost_volume_p2p_plain(*args))


# the generic kernel: K3 at other widths, more features and more scales
# than the tuned arm takes, at K below and past 32
@pytest.mark.parametrize("case", [((24, 40, 56), 7, (4, 8, 16, 33, 5, 6, 7,
                                                      8, 9, 64)),
                                  ((64, 64, 128), 3, (16, 32, 64)),
                                  ((32, 32, 64), 3, (4, 8, 16, 32))])
@pytest.mark.parametrize("dtype", DTYPES)
def test_mse_generic(dev, rs, dtype, case):
    widths, cf, ks = case
    b, n = 16, 256
    pc = cloud(rs, b, n, dev)
    feats = torch.from_numpy(rs.randn(b, cf, n).astype(np.float32)).to(
        dev).to(dtype).transpose(1, 2)
    packed = mse_encoder(dev, ks, widths, cf, dtype, 10)
    idx = [random_idx(rs, b, n, k, dev) for k in ks]
    counts = (lambda: (fused.fused_multi_scale_encoder.launches,
                       fused.fused_multi_scale_encoder.launches_generic))
    with torch.no_grad():
        want = fused.fused_multi_scale_encoder_plain(feats, idx, pc, packed)
        if fused.mse_arm(widths, len(ks), cf) == fused.TUNED:
            # the default shape: the generic route beside the tuned one
            near_arm(fused.fused_multi_scale_encoder(feats, idx, pc, packed),
                     want, dtype)
            fn = (lambda: fused._mse_generic(feats, idx, pc, packed))
        else:
            fn = (lambda: fused.fused_multi_scale_encoder(feats, idx, pc,
                                                          packed))
        before = counts()
        got = same_twice(fn)
        # a launch a scale, each counted where it launches
        assert counts() == (before[0] + 2 * len(ks),
                            before[1] + 2 * len(ks))
        near_arm(got, want, dtype)


@pytest.mark.parametrize("widths", [(200, 100, 36), (96, 64, 48, 32),
                                    (768, 384, 96), (130,), (512, 256, 64)])
@pytest.mark.parametrize("k", [5, 16, 33])
@pytest.mark.parametrize("dtype", DTYPES)
def test_plf_generic(dev, rs, dtype, k, widths):
    """K5's generic arm: chains of other widths and depths (none past the
    first layer at (130,): the FMA kernel; the others on the tensor
    cores), queries of 8, 16 and 64 rows; the default widths through the
    private route beside the tuned arm."""
    b, n = 16, 256
    pc = cloud(rs, b, n, dev)
    plf = seeded(blocks.PointLocalFeature(8.0, k, 40, widths, (16,)), dev,
                 11)
    feat_tx = torch.from_numpy(rs.randn(b, n, widths[0]).astype(
        np.float32)).to(dev).to(dtype)
    idx = random_idx(rs, b, n, k, dev)
    with torch.no_grad():
        chain, _, _ = fused.plf_params_from_variables(plf)
        chain = [t.to(dtype) if i % 3 == 0 else t
                 for i, t in enumerate(chain)]
        want = fused.fused_point_local_feature_plain(feat_tx, idx, pc, chain)
        if fused.plf_arm(widths) == fused.TUNED:
            near_arm(fused.fused_point_local_feature(feat_tx, idx, pc, chain),
                     want, dtype)
        before = fused.fused_point_local_feature.launches_generic
        got = same_twice(lambda: fused._plf_generic(feat_tx, idx, pc, chain))
        assert fused.fused_point_local_feature.launches_generic == before + 2
        near_arm(got, want, dtype)


def generic_cost_volume_inputs(rs, c, dev, dtype):
    b, n = 16, 256
    fc = seeded(blocks.FeatureCorrelator(8, c, c, (c, c, c)), dev, 12)
    f = [torch.from_numpy(rs.randn(b, n, c).astype(np.float32)).to(
        dev).to(dtype) for _ in range(2)]
    z = [torch.from_numpy(rs.randn(b, n, 8).astype(np.float32)).to(dev)
         for _ in range(2)]
    with torch.no_grad():
        dense, wn1, wn2 = fused.cv_params_from_variables(fc)
    dense = [t.to(dtype) if i % 2 == 0 else t for i, t in enumerate(dense)]
    return f, z, dense, wn1, wn2


@pytest.mark.parametrize("k", [8, 33, 100])
@pytest.mark.parametrize("c", [100, 512, 768, 826])
@pytest.mark.parametrize("dtype", DTYPES)
def test_cost_volume_generic(dev, rs, dtype, c, k):
    """K4a's and K4b's generic arm at C = 100, 768 and 826 through the
    wrappers, and at 512 through the private routes beside the tuned arms:
    random neighbours, some outside [0, N), K4b on a seeded cost; K4b's bf16
    arm at the float32 bars (its arithmetic is float32).  At C = 768 and
    826 K4a's middle activation goes to device scratch
    (``fused.chain_tc_plan``: in shared memory it would leave one block an
    SM, or not fit)."""
    f, z, dense, wn1, wn2 = generic_cost_volume_inputs(rs, c, dev, dtype)
    b, n = f[0].shape[:2]
    idx2, idx1 = (random_idx(rs, b, n, k, dev) for _ in range(2))
    args = (f[0], f[1], idx2, z[0], z[1], dense[1:], wn1[1:])
    tuned = fused.cv_p2p_arm((c, c, c)) == fused.TUNED
    assert tuned == (fused.cv_agg_arm(c) == fused.TUNED) == (c == 512)
    with torch.no_grad():
        before = (fused.cost_volume_p2p.launches_generic,
                  fused.cost_volume_agg.launches_generic)
        p2p_fn = (lambda: fused._cv_p2p_generic(*args)) if tuned else (
            lambda: fused.cost_volume_p2p(*args))
        p2p = same_twice(p2p_fn)
        assert p2p.dtype == dtype
        near_arm(p2p, fused.cost_volume_p2p_plain(*args), dtype)
        # K4b on a cost of order one (K4a's sum over k = 100 neighbours
        # grows to hundreds, where a float32 ulp passes the 1e-4 bar)
        cost = torch.from_numpy(rs.randn(b, n, c).astype(np.float32)).to(
            dev).to(dtype)
        agg_args = (cost, idx1, z[0], wn2[1:])
        agg_fn = (lambda: fused._cv_agg_generic(*agg_args)) if tuned else (
            lambda: fused.cost_volume_agg(*agg_args))
        agg = same_twice(agg_fn)
        near(agg, fused.cost_volume_agg_plain(*agg_args))
        # the private routes count too, where they launch
        assert (fused.cost_volume_p2p.launches_generic,
                fused.cost_volume_agg.launches_generic) == (
                    before[0] + 2, before[1] + 2)


def p2p_whole_tiles(args):
    """Float32 K4a on its tile-of-whole-queries arm (``cv_p2p_kernel``,
    which the wrapper keeps for the k that divide 64), called directly at
    any k <= 64."""
    from cmflow_tpu_torch.native import build
    f1c, f2c, idx, z1, z2, dense, wn = args
    b0, w1, b1, w2, b2 = dense
    b, n, c = f1c.shape
    wpack = fused.tc_weights(w1, w2)
    out = torch.empty_like(f1c)
    lib = build.load("cost_volume", fused._SIGNATURES["cost_volume"])
    code = lib.cmflow_cv_p2p(
        f1c.data_ptr(), f2c.data_ptr(), idx.data_ptr(), z1.data_ptr(),
        z2.data_ptr(), b0.data_ptr(), wpack.data_ptr(), b1.data_ptr(),
        b2.data_ptr(), *[t.data_ptr() for t in wn], out.data_ptr(), b, n,
        idx.shape[2], c, torch.cuda.current_stream().cuda_stream)
    build.check(lib, code, "cv_p2p_kernel")
    return out


@pytest.mark.parametrize("k", [5, 33, 48, 65, 100, 130])
@pytest.mark.parametrize("shape", [(16, 256, True), (3, 200, False)])
def test_cost_volume_p2p_full_tiles(dev, rs, shape, k):
    """Float32 K4a at the k that do not divide 64 (all but 5, whose whole
    queries fill 60 of a tile's 64 rows, run the full-tile arm,
    ``cv_p2p_full_kernel``: 64-row tiles across query boundaries, a
    persistent grid from ``cv_p2p_plan``), counted once a call: against
    its plain version with three
    neighbours outside [0, N), the same bits twice; below 64 also against
    the tile-of-whole-queries arm at the same bars."""
    full = int(fused.cv_p2p_full(k))
    assert full == (k != 5)
    f, _, _, z, dense, wn1, _ = cost_volume_inputs(rs, shape, dev)
    idx2 = p2p_indices(rs, shape, k, dev)
    args = (f[0], f[1], idx2, z[0], z[1], dense[1:], wn1[1:])
    with torch.no_grad():
        before = (fused.cost_volume_p2p.launches,
                  fused.cost_volume_p2p.launches_full)
        got = same_twice(lambda: fused.cost_volume_p2p(*args))
        assert (fused.cost_volume_p2p.launches,
                fused.cost_volume_p2p.launches_full) == (before[0] + 2,
                                                         before[1] + 2 * full)
        near(got, fused.cost_volume_p2p_plain(*args))
        if k < 64:
            near(got, p2p_whole_tiles(args))


@pytest.mark.parametrize("k", [1, 8, 16, 32, 64])
def test_cost_volume_p2p_divisors_keep_their_arm(dev, rs, k):
    """The k that divide 64 keep the tile-of-whole-queries arm: the
    wrapper's bits are its bits, and no full-tile launch is counted."""
    shape = (16, 256, True)
    f, _, _, z, dense, wn1, _ = cost_volume_inputs(rs, shape, dev)
    idx2 = p2p_indices(rs, shape, k, dev)
    args = (f[0], f[1], idx2, z[0], z[1], dense[1:], wn1[1:])
    with torch.no_grad():
        before = fused.cost_volume_p2p.launches_full
        got = fused.cost_volume_p2p(*args)
        assert fused.cost_volume_p2p.launches_full == before
        same(got, p2p_whole_tiles(args))


@pytest.mark.parametrize("k", [5, 16])
@pytest.mark.parametrize("bn", [(16, 256), (3, 200)])
@pytest.mark.parametrize("c", [3, 100, 511, 512, 768, 826])
@pytest.mark.parametrize("dtype", DTYPES)
def test_cost_volume_agg_any_c(dev, rs, dtype, c, bn, k):
    """K4b at any C on the tuned design (``cv_agg_any_kernel``: chunks of
    the row from ``cv_agg_plan``, cells copied whole or in 8-, 4- or 2-byte
    pieces where the rows are not aligned to a cell), in both dtypes, N not
    a multiple of a block's queries, three neighbours outside [0, N):
    against the plain version at the float32 bars, the same bits twice,
    counted as a generic launch.  Each channel's bits do not depend on the
    chunking: at C = 512 they are the tuned kernel's, and another chunk of
    the row (32 cells, 2 queries a thread) gives the same bits."""
    b, n = bn
    h = fused.WEIGHTNET_HIDDEN
    cost = torch.from_numpy(rs.randn(b, n, c).astype(np.float32)).to(
        dev).to(dtype)
    zq = torch.from_numpy(rs.randn(b, n, h).astype(np.float32)).to(dev)
    idx = random_idx(rs, b, n, k, dev)
    idx[0, :3, 0] = torch.tensor([-1, n, 4096], dtype=torch.int32)
    fc = seeded(blocks.FeatureCorrelator(8, c, c, (c, c, c)), dev, 13)
    with torch.no_grad():
        wn = fused.cv_params_from_variables(fc)[2][1:]
        args = (cost, idx, zq, wn)
        before = (fused.cost_volume_agg.launches,
                  fused.cost_volume_agg.launches_generic)
        got = same_twice(lambda: fused._cv_agg_generic(*args))
        assert (fused.cost_volume_agg.launches,
                fused.cost_volume_agg.launches_generic) == (
                    before[0] + 2, before[1] + 2)
        near(got, fused.cost_volume_agg_plain(*args))
        if c == fused.CV_WIDTH:
            same(got, fused.cost_volume_agg(*args))
        plan = fused.cv_agg_plan
        try:
            fused.cv_agg_plan = lambda *a: dict(plan(*a), cells=32, per=2)
            other = fused._cv_agg_generic(*args)
        finally:
            fused.cv_agg_plan = plan
        same(got, other)


def off_cell(t, offset):
    """A contiguous copy of ``t`` that starts ``offset`` elements into a
    fresh buffer, so not 16-byte aligned."""
    flat = torch.empty(t.numel() + offset, dtype=t.dtype, device=t.device)
    view = flat[offset:].view(t.shape)
    view.copy_(t)
    return view


@pytest.mark.parametrize("offset", [1, 2])
@pytest.mark.parametrize("c", [100, 768, 826])
@pytest.mark.parametrize("dtype", DTYPES)
def test_cost_volume_agg_any_c_offset_views(dev, rs, dtype, c, offset):
    """K4b's generic arm on tensors that start off a 16-byte cell: p2p
    (the kernel copies its rows in the pieces their starts allow), zq and
    the WeightNet (copied where the kernel reads them as float4s).  The
    bits are those of the aligned tensors, and within the float32 bars of
    the plain version."""
    b, n, k = 3, 200, 16
    h = fused.WEIGHTNET_HIDDEN
    cost = torch.from_numpy(rs.randn(b, n, c).astype(np.float32)).to(
        dev).to(dtype)
    zq = torch.from_numpy(rs.randn(b, n, h).astype(np.float32)).to(dev)
    idx = random_idx(rs, b, n, k, dev)
    fc = seeded(blocks.FeatureCorrelator(8, c, c, (c, c, c)), dev, 13)
    with torch.no_grad():
        wn = fused.cv_params_from_variables(fc)[2][1:]
        args = (off_cell(cost, offset), idx, off_cell(zq, offset),
                [off_cell(t, offset) for t in wn])
        assert all(t.data_ptr() % 16 for t in (args[0], args[2], *args[3]))
        got = same_twice(lambda: fused.cost_volume_agg(*args))
        near(got, fused.cost_volume_agg_plain(*args))
        same(got, fused.cost_volume_agg(cost, idx, zq, wn))


# ---------------------------------------------------------------------------
# the generic kernel's tensor-core arm (csrc/chain.cu::chain_tc_kernel):
# K5's and K3's chains (kind max) and K4a's (kind p2p) at any widths and
# depth, in both dtypes
# ---------------------------------------------------------------------------

def chain_params(rs, widths, dev, dtype, two_terms=False):
    """A K5 chain ``(wrel, s0, b0, w1, s1, b1, ...)`` of ``widths`` (C1 and
    each Dense layer's output): He-scaled Dense kernels in ``dtype``,
    affines near the identity, so activations stay of order one at any
    depth.  With ``two_terms`` each output column of a Dense kernel has two
    nonzero weights (0.75, 1 or 1.25 and +-0.5, exact in bf16), so every
    float32 sum of a product has two terms and the same value in any
    order."""
    c1 = widths[0]
    out = [torch.from_numpy(rs.randn(3, c1).astype(np.float32) * 0.3),
           torch.from_numpy(rs.uniform(0.8, 1.2, c1).astype(np.float32)),
           torch.from_numpy(rs.uniform(-0.1, 0.1, c1).astype(np.float32))]
    for cin, cout in zip(widths[:-1], widths[1:]):
        if two_terms:
            w = np.zeros((cin, cout), np.float32)
            for col in range(cout):
                a, b = rs.choice(cin, 2, replace=False)
                w[a, col] = rs.choice([0.75, 1.0, 1.25])
                w[b, col] = rs.choice([-0.5, 0.5])
        else:
            w = (rs.randn(cin, cout) * np.sqrt(2.0 / cin)).astype(np.float32)
        out += [torch.from_numpy(w).to(dtype),
                torch.from_numpy(rs.uniform(0.8, 1.2, cout).astype(
                    np.float32)),
                torch.from_numpy(rs.uniform(-0.1, 0.1, cout).astype(
                    np.float32))]
    out[0] = out[0].to(dtype)
    return [t.to(dev) for t in out]


# (widths, K): config B's K5; odd widths (none a multiple of 8); C = 100
# and 826; a query of 1, 8, 16, 32 and 64 rows and one over two tiles
# (K = 100); depth 40
CHAIN_TC_MAX = [((768, 384, 96), 16), ((37, 45, 19), 1), ((37, 45, 19), 5),
                ((100, 100, 100), 33), ((826, 200, 826), 16),
                ((200, 100, 36), 100), ((96, 64, 48, 32), 64),
                ((23,) * 41, 16), ((40,) * 41, 100)]


@pytest.mark.parametrize("case", CHAIN_TC_MAX)
@pytest.mark.parametrize("dtype", DTYPES)
def test_chain_tc_max(dev, rs, dtype, case):
    """K5's generic arm on the tensor cores through the wrapper: held to
    its plain version at the arm's bars, the same bits twice, one launch a
    call counted as the generic arm's; neighbour indices out of range.

    At depth 40 in bf16 the Dense kernels have two terms a column
    (``chain_params``): with dense random kernels any two bf16 chains that
    sum in other orders drift apart as rounding flips compound through the
    layers (the kernel against its plain version: 1.13% of the largest
    magnitude at (23,) * 41, K=16, on an H100, past the 1e-2 bar; float32
    stays within its bars at that depth, held here with dense kernels)."""
    widths, k = case
    b, n = 16, 256
    pc = cloud(rs, b, n, dev)
    chain = chain_params(rs, widths, dev, dtype,
                         two_terms=dtype == BF16 and len(widths) > 10)
    feat_tx = torch.from_numpy(rs.randn(b, n, widths[0]).astype(
        np.float32)).to(dev).to(dtype)
    idx = random_idx(rs, b, n, k, dev)
    assert fused.plf_arm(widths) == fused.GENERIC
    with torch.no_grad():
        before = (fused.fused_point_local_feature.launches,
                  fused.fused_point_local_feature.launches_generic)
        got = same_twice(lambda: fused.fused_point_local_feature(
            feat_tx, idx, pc, chain))
        assert (fused.fused_point_local_feature.launches,
                fused.fused_point_local_feature.launches_generic) == (
                    before[0] + 2, before[1] + 2)
        near_arm(got, fused.fused_point_local_feature_plain(
            feat_tx, idx, pc, chain), dtype)


@pytest.mark.parametrize("k", [1, 16, 100])
@pytest.mark.parametrize("dtype", DTYPES)
def test_chain_tc_tuned_widths(dev, rs, dtype, k):
    """At the tuned kernels' own widths the tensor-core generic arm is held
    to its plain version and to the tuned kernel's output (K5 (512, 256,
    64), K4a C = 512), at the arm's bars."""
    b, n = 16, 256
    pc = cloud(rs, b, n, dev)
    chain = chain_params(rs, fused.PLF_WIDTHS, dev, dtype)
    feat_tx = torch.from_numpy(rs.randn(b, n, 512).astype(np.float32)).to(
        dev).to(dtype)
    idx = random_idx(rs, b, n, k, dev)
    f, z, dense, wn1, _ = generic_cost_volume_inputs(rs, 512, dev, dtype)
    args = (f[0], f[1], random_idx(rs, b, n, k, dev), z[0], z[1], dense[1:],
            wn1[1:])
    with torch.no_grad():
        got = same_twice(lambda: fused._plf_generic(feat_tx, idx, pc, chain))
        near_arm(got, fused.fused_point_local_feature_plain(
            feat_tx, idx, pc, chain), dtype)
        near_arm(got, fused.fused_point_local_feature(feat_tx, idx, pc,
                                                      chain), dtype)
        p2p = same_twice(lambda: fused._cv_p2p_generic(*args))
        near_arm(p2p, fused.cost_volume_p2p_plain(*args), dtype)
        near_arm(p2p, fused.cost_volume_p2p(*args), dtype)


@pytest.mark.parametrize("case", [(37, 1), (100, 16), (826, 16), (45, 100),
                                  (768, 33)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_chain_tc_p2p(dev, rs, dtype, case):
    """K4a's generic arm on the tensor cores: C not a multiple of 8, 100,
    768 and 826; K of one, a query of 16 or 64 rows and one over two tiles;
    indices out of range; the same bits twice."""
    c, k = case
    f, z, dense, wn1, _ = generic_cost_volume_inputs(rs, c, dev, dtype)
    b, n = f[0].shape[:2]
    args = (f[0], f[1], random_idx(rs, b, n, k, dev), z[0], z[1], dense[1:],
            wn1[1:])
    with torch.no_grad():
        before = fused.cost_volume_p2p.launches_generic
        got = same_twice(lambda: fused.cost_volume_p2p(*args))
        assert fused.cost_volume_p2p.launches_generic == before + 2
        near_arm(got, fused.cost_volume_p2p_plain(*args), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_chain_tc_empty_batch(dev, rs, dtype):
    """B = 0: no launch of a kernel, empty outputs of the right shapes."""
    chain = chain_params(rs, (37, 45, 19), dev, dtype)
    feat_tx = torch.empty((0, 64, 37), dtype=dtype, device=dev)
    idx = torch.empty((0, 64, 8), dtype=torch.int32, device=dev)
    pc = torch.empty((0, 64, 3), device=dev)
    with torch.no_grad():
        out = fused.fused_point_local_feature(feat_tx, idx, pc, chain)
        f, z, dense, wn1, _ = generic_cost_volume_inputs(rs, 37, dev, dtype)
        empty = [t[:0] for t in (f[0], f[1], z[0], z[1])]
        idx2 = torch.empty((0, f[0].shape[1], 8), dtype=torch.int32,
                           device=dev)
        p2p = fused.cost_volume_p2p(*empty[:2], idx2, *empty[2:], dense[1:],
                                    wn1[1:])
    torch.cuda.synchronize()
    assert out.shape == (0, 64, 19) and p2p.shape == (0, 256, 37)


def test_chain_tc_plan_on_card(dev):
    """The plan's count of the kernel's static shared memory bounds the
    card's, and the card holds as many blocks an SM as the plan says at
    config B (both dtypes)."""
    for kind in ("max", "p2p"):
        for bf16 in (False, True):
            assert 0 < fused.chain_tc_static_smem(kind, bf16) <= (
                fused.CHAIN_TC_STATIC_SMEM)
    for kind, c0, widths in (("max", 768, (384, 96)),
                             ("p2p", 768, (768, 768)),
                             ("max", 64, (64, 128))):
        for bf16 in (False, True):
            plan = fused.chain_tc_plan(bf16, c0, widths, 16, 4096)
            assert fused.chain_tc_occupancy(kind, bf16, plan["smem"]) >= (
                plan["blocks_per_sm"])


# ---------------------------------------------------------------------------
# the experiment loop: its eval batch of 64 frames on the fused route, and
# checkpoints across devices
# ---------------------------------------------------------------------------

def assert_outputs_near(req, out, ref):
    """The serving bars on the valid points: stat_cls and sf_agg (where the
    masks agree) atol 1e-4, pre_trans atol 5e-4, masks agreeing on >= 99%."""
    (sf, cls, trans, mask), (rsf, rcls, rtrans, rmask) = (
        [x.cpu().numpy() for x in o] for o in (out, ref))
    valid = req["valid1"]
    assert np.abs(cls - rcls)[valid].max() <= 1e-4
    assert np.abs(trans - rtrans).max() <= 5e-4
    assert (mask == rmask)[valid].mean() >= 0.99
    assert np.abs(sf - rsf)[(mask == rmask) & valid].max() <= 1e-4


@pytest.mark.parametrize("bucket", [384, 512])
def test_fused_route_batch_64(dev, bucket):
    """The loop's default eval batch (B=64) in the 384 and 512 buckets: the
    fused route on the card against the same route on the CPU (every
    kernel's plain version) and against the module route on the card."""
    req = make_request(bucket, 64, (bucket - 127, bucket))
    assert req["pc1"].shape == (64, bucket, 3) and not req["valid1"].all()
    model = seeded(CMFlow(), dev, 11).eval()
    step = make_eval_step("cmflow", model)
    assert step.fused
    out = step(req)
    assert all(bool(torch.isfinite(x).all()) for x in out[:3])
    cpu = copy.deepcopy(model).to("cpu")
    assert_outputs_near(req, out,
                        make_eval_step("cmflow", cpu, fused="on")(req))
    assert_outputs_near(req, out,
                        make_eval_step("cmflow", model, fused="off")(req))


def train_state(device, seed):
    model = seeded(CMFlow(), device, seed).eval()
    return create_train_state(model, steps_per_epoch=2)


def state_bits(state):
    opt = state.optimizer.state_dict()
    return ({k: v.cpu() for k, v in state.model.state_dict().items()},
            {(i, k): v.cpu() for i, s in opt["state"].items()
             for k, v in s.items()}, state.scheduler.state_dict(), state.step)


@pytest.mark.parametrize("order", ["card_to_cpu", "cpu_to_card"])
def test_checkpoint_restores_across_devices(dev, tmp_path, order):
    """A checkpoint saved on one device restores on the other bit for bit:
    the weights and Adam's moments on the restoring model's device, Adam's
    step counts on the host, and the restored state trains on."""
    src, dst = ((dev, torch.device("cpu")) if order == "card_to_cpu"
                else (torch.device("cpu"), dev))
    batch = make_train_batch(0, 2, 64)
    state = train_state(src, 3)
    make_train_step("cmflow", state.model, VOD_CAMERA_PROJECTION,
                    VOD_T_CAMERA_RADAR)(state, batch)
    path = str(tmp_path / "last")
    loop.save_checkpoint(path, state)
    restored = loop.restore_checkpoint(path, train_state(dst, 4))
    want, got = state_bits(state), state_bits(restored)
    for a, b in zip(want[:2], got[:2]):
        assert sorted(a) == sorted(b)
        for k in a:
            assert torch.equal(a[k], b[k]), k
    assert want[2:] == got[2:]
    for p in restored.model.parameters():
        s = restored.optimizer.state[p]
        assert s["exp_avg"].device.type == dst.type
        assert s["step"].device.type == "cpu" and float(s["step"]) == 1.0
    items = make_train_step("cmflow", restored.model, VOD_CAMERA_PROJECTION,
                            VOD_T_CAMERA_RADAR)(restored, batch)
    assert restored.step == 2 and np.isfinite(float(items["Loss"]))


# ---------------------------------------------------------------------------
# RaFlow and CMFlow_T: their fused routes and train steps on the card
# against the same on the CPU
# ---------------------------------------------------------------------------

def test_raflow_fused_route(dev):
    """B=16 on the 256 bucket: the fused route on the card against the CPU's
    and the card's module route: coarse-to-refined flow where the inlier
    masks agree atol 1e-4, pre_trans 5e-4, masks agreeing on >= 99%."""
    req = make_request(31, 16, (200, 256))
    model = seeded(RaFlow(), dev, 12).eval()
    step = make_eval_step("raflow", model)
    assert step.fused
    before = fused.cost_volume_agg.launches
    out = step(req)
    assert fused.cost_volume_agg.launches == before + 1
    assert all(bool(torch.isfinite(x).all()) for x in out[:3])
    cpu = copy.deepcopy(model).to("cpu")
    valid = req["valid1"]
    for ref in (make_eval_step("raflow", cpu, fused="on")(req),
                make_eval_step("raflow", model, fused="off")(req)):
        (sf, _, trans, mask), (rsf, _, rtrans, rmask) = (
            [x.cpu().numpy() for x in o] for o in (out, ref))
        assert np.abs(trans - rtrans).max() <= 5e-4
        assert (mask == rmask)[valid].mean() >= 0.99
        assert np.abs(sf - rsf)[(mask == rmask) & valid].max() <= 1e-4


def test_cmflow_t_fused_sequence(dev):
    """Three B=16 frames through ``cmflow_t_infer_seq`` with a reset of
    lane 0 at frame 2, on the card against the CPU: the serving bars on
    each frame, and the final carry atol 1e-4."""
    reqs = [make_request(40 + t, 16, (200, 256)) for t in range(3)]
    keys = ("pc1", "pc2", "ft1", "ft2", "valid1", "valid2")
    stacked = {k: torch.stack([torch.as_tensor(r[k]) for r in reqs])
               for k in keys}
    reset = torch.zeros((3, 16), dtype=torch.bool)
    reset[0] = True
    reset[2, 0] = True
    model = seeded(CMFlowT(), dev, 13).eval()
    cpu = copy.deepcopy(model).to("cpu")
    g0 = torch.zeros((16, 256))
    out, gfinal = cmflow_t_infer_seq(
        model, *(stacked[k].to(dev) for k in keys[:4]), g0.to(dev),
        reset.to(dev), stacked["valid1"].to(dev), stacked["valid2"].to(dev))
    ref, rfinal = cmflow_t_infer_seq(cpu, *(stacked[k] for k in keys[:4]),
                                     g0, reset, stacked["valid1"],
                                     stacked["valid2"])
    for t, req in enumerate(reqs):
        assert_outputs_near(req, [o[t] for o in out], [o[t] for o in ref])
    assert float((gfinal.cpu() - rfinal).abs().max()) <= 1e-4


def test_raflow_and_sequence_train_steps(dev):
    """One RaFlow train step (B=16, N=256) and CMFlow_T T=2 mini-clip steps
    at lr 0 on the card against the CPU: loss items rtol 1e-4, BatchNorm
    running means atol 1e-5, RaFlow's parameters after its step atol 5e-3.
    Gradients: RaFlow's, and CMFlow_T's second frame on the first frame
    twice, within a relative L2 of 3e-2 per leaf and 1e-2 whole; CMFlow_T's
    second frame on two frames at the median leaf (3e-2), where float32
    rounding alone moves the whole gradient by ~1e-2
    (tests/test_torch_cmflow_t.py)."""
    batch = make_train_batch(5, 16, 256)
    clips = {"first frame twice": {k: np.stack([v, v], axis=1)
                                   for k, v in batch.items()},
             "two frames": {k: np.stack([v, make_train_batch(6, 16, 256)[k]],
                                        axis=1) for k, v in batch.items()}}
    cases = [("raflow", None)] + [("cmflow_t", c) for c in clips]
    for name, clip in cases:
        runs = []
        for device in (dev, torch.device("cpu")):
            model = seeded(RaFlow() if name == "raflow" else CMFlowT(),
                           torch.device("cpu"), 14).to(device)
            if name == "raflow":
                state = create_train_state(model)
                items = make_train_step(name, model, VOD_CAMERA_PROJECTION,
                                        VOD_T_CAMERA_RADAR)(state, batch)
            else:
                state = create_train_state(model, lr=0.0)
                items = make_train_step_seq(model, VOD_CAMERA_PROJECTION,
                                            VOD_T_CAMERA_RADAR)(
                    state, clips[clip])
            runs.append(({k: float(v) for k, v in items.items()},
                         export_flax_variables(model),
                         export_flax_variables(model, grads=True)))
        (items, after, grads), (ritems, rafter, rgrads) = runs
        for k, v in ritems.items():
            assert abs(items[k] - v) <= 1e-4 * abs(v), (name, clip, k)
        for path, want in _leaves(rafter):
            got = dict(_leaves(after))[path]
            if path.endswith("mean"):
                assert np.abs(got - want).max() <= 1e-5, (name, clip, path)
            if name == "raflow" and path.startswith("params"):
                assert np.abs(got - want).max() <= 5e-3, (name, path)
        got, want = dict(_leaves(grads)), dict(_leaves(rgrads))
        assert all(np.isfinite(g).all() for g in got.values())
        rel = {k: float(np.linalg.norm(got[k] - w) / np.linalg.norm(w))
               for k, w in want.items()}
        whole = float(np.sqrt(sum(np.sum((got[k] - w) ** 2)
                                  for k, w in want.items())
                              / sum(np.sum(w ** 2) for w in want.values())))
        if clip == "two frames":
            assert np.median(list(rel.values())) <= 3e-2, (rel, whole)
        else:
            bad = {k: v for k, v in rel.items() if not v <= 3e-2}
            assert not bad and whole <= 1e-2, (name, clip, bad, whole)


def _leaves(tree, prefix=""):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _leaves(value, f"{prefix}{key}/")
        else:
            yield prefix + key, value


# --------------------------------------------------------------------------
# farthest-point sampling (csrc/sampling.cu), the PointNet++ modules and
# recomputation on the card

def unit_sphere(rs, b, n, dev):
    x = rs.randn(b, n, 3)
    x /= np.linalg.norm(x, axis=-1, keepdims=True)
    return torch.from_numpy(x.astype(np.float32)).to(dev)


@pytest.mark.parametrize("b,n,npoint", [
    (16, 1024, 512), (16, 256, 64), (16, 512, 128), (3, 50, 128),
    (2, 2048, 300), (2, 5000, 200), (1, 1, 4), (4, 700, 700)])
def test_farthest_point_sample(dev, rs, b, n, npoint):
    """Bit for bit against the plain version, in and past the register
    capacity of the default block (1,024 points a warp, 8,192 with 8
    warps, then global scratch), with more samples than points; one kernel
    a call; the same bits twice."""
    from cmflow_tpu_torch.ops import sampling

    xyz = unit_sphere(rs, b, n, dev)
    before = sampling.farthest_point_sample.launches
    got = sampling.farthest_point_sample(xyz, npoint)
    assert sampling.farthest_point_sample.launches == before + 1
    same(got, sampling.farthest_point_sample_plain(xyz, npoint))
    same(got, sampling.farthest_point_sample(xyz, npoint))
    assert got.dtype == torch.int32 and got.shape == (b, npoint)
    assert kernels_per_call(
        lambda: sampling.farthest_point_sample(xyz, npoint)) == 1


def fps_with_warps(xyz, npoint, warps):
    """The FPS kernel with ``warps`` warps a cloud, whatever its N."""
    from cmflow_tpu_torch.native import build
    from cmflow_tpu_torch.ops import sampling

    b, n, _ = xyz.shape
    lib = build.load("sampling", sampling._SIGNATURES)
    scratch = None
    if n > lib.cmflow_fps_register_points(warps):
        scratch = torch.empty((b, n), dtype=torch.float32, device=xyz.device)
    out = torch.empty((b, npoint), dtype=torch.int32, device=xyz.device)
    build.check(lib, lib.cmflow_fps(
        xyz.data_ptr(), b, n, npoint, warps,
        None if scratch is None else scratch.data_ptr(), out.data_ptr(),
        torch.cuda.current_stream().cuda_stream), "fps")
    return out


# every block size at N from one point to past 8 warps' registers and
# past the shared memory's cloud (12,288 points: the winner read from the
# cloud), npoint to N + 2, with exact ties; the same bits for every size
@pytest.mark.parametrize("n", [1, 31, 256, 1024, 2048, 2049, 5000, 13000])
def test_farthest_point_sample_every_block_size(dev, rs, n):
    from cmflow_tpu_torch.ops import sampling

    xyz = unit_sphere(rs, 3, n, dev)
    if n > 8:
        xyz[:, n // 2:n // 2 + 5] = xyz[:, 2:7]
    npoint = n + 2 if n <= 256 else 64
    want = sampling.farthest_point_sample_plain(xyz, npoint)
    same(sampling.farthest_point_sample(xyz, npoint), want)
    for warps in (1, 2, 4, 8):
        same(fps_with_warps(xyz, npoint, warps), want)
    if npoint > n:
        assert (want[:, n:] == 0).all()


def test_farthest_point_sample_ties(dev):
    """Duplicated points at equal distances: the lowest index wins."""
    from cmflow_tpu_torch.ops import sampling

    xyz = torch.zeros((2, 3000, 3), device=dev)
    xyz[:, 3:6, 0] = 1.0
    xyz[:, 2500:2600, 0] = -1.0  # also at distance 1, past the registers
    xyz[1, 2999] = 2.0
    got = sampling.farthest_point_sample(xyz, 8)
    same(got, sampling.farthest_point_sample_plain(xyz, 8))
    assert got[0, 1].item() == 3 and got[1, 1].item() == 2999


def test_farthest_point_sample_rejects(dev):
    from cmflow_tpu_torch.ops import sampling

    xyz = torch.zeros((2, 8, 3), device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        sampling.farthest_point_sample(xyz.transpose(0, 1).contiguous()
                                       .transpose(0, 1), 4)
    with pytest.raises(TypeError):
        sampling.farthest_point_sample(xyz.double(), 4)


@pytest.mark.parametrize("masked", [False, True])
def test_three_nn_on_card(dev, rs, masked):
    """Indices (K2) and distances (K6 and the pair expression) bit for bit
    against the plain version on the card, ``knn_with_dists`` (the full
    distance matrix sorted) and its correctly rounded square root, and
    against ``three_nn`` on the CPU."""
    query = cloud(rs, 4, 300, dev, 4.0)
    points = cloud(rs, 4, 80, dev, 4.0)
    valid = valid_mask(rs, 4, 80, dev) if masked else None
    d, idx = pointops.three_nn(query, points, valid)
    d2, kidx = pointops.knn_with_dists(3, query, points, valid)
    same(idx, kidx)
    same(d, pointops.sqrt_rn(torch.clamp_min(d2, 0.0)))
    cd, cidx = pointops.three_nn(query.cpu(), points.cpu(),
                                 None if valid is None else valid.cpu())
    same(idx.cpu(), cidx)
    same(d.cpu(), cd)


def test_sqrt_rn_on_card(dev, rs):
    """``sqrt_rn`` on the card equals numpy's correctly rounded float32
    square root, where the card's ``torch.sqrt`` need not."""
    x = (rs.rand(1_000_000) * 100).astype(np.float32)
    got = pointops.sqrt_rn(torch.from_numpy(x).to(dev))
    same(got.cpu(), torch.from_numpy(np.sqrt(x)))


def test_pointnet2_modules_on_card(dev, rs):
    """SetAbstraction (npoint, group-all) and FeaturePropagation, train-mode
    forward and backward, against the same modules on the CPU at the train
    bars: outputs 1e-4, running statistics 1e-5, gradients relative L2
    3e-2 a leaf."""
    from cmflow_tpu_torch.nn import extras

    gen = torch.Generator().manual_seed(3)
    mods = torch.nn.ModuleDict(dict(
        sa1=extras.SetAbstraction(128, 0.3, 16, 0, (32, 32, 64)),
        sa2=extras.SetAbstraction(None, None, None, 64, (64, 128)),
        fp=extras.FeaturePropagation(64, (64, 32))))
    blocks.init_parameters(mods, gen)
    card = copy.deepcopy(mods).to(dev)
    xyz = unit_sphere(rs, 4, 512, dev)
    outs = []
    for m, x in ((card, xyz), (mods, xyz.cpu())):
        l1_xyz, l1 = m["sa1"](x, None, True)
        _, l2 = m["sa2"](l1_xyz, l1, True)
        up = m["fp"](x, l1_xyz, None, l1, True)
        (l2.sum() + (up * up).sum()).backward()
        outs.append((l1_xyz.cpu(), l1.detach().cpu(), l2.detach().cpu(),
                     up.detach().cpu()))
    same(outs[0][0], outs[1][0])  # the same samples
    for a, b in zip(outs[0][1:], outs[1][1:]):
        assert (a - b).abs().max() <= 1e-4
    for (k, a), (_, b) in zip(card.state_dict().items(),
                              mods.state_dict().items()):
        assert (a.cpu() - b).abs().max() <= 1e-5, k
    for (k, a), (_, b) in zip(card.named_parameters(),
                              mods.named_parameters()):
        rel = (a.grad.cpu() - b.grad).norm() / b.grad.norm()
        assert rel <= 3e-2, (k, float(rel))


def test_remat_modes_on_card(dev):
    """A CMFlow train step in each remat mode: the bits of remat False, and
    "dots" with the gathers of False."""
    batch = make_train_batch(4, 16, 256)
    runs = {}
    for mode in (False, True, "dots"):
        model = CMFlow(remat=mode)
        blocks.init_parameters(model, torch.Generator().manual_seed(6))
        model.to(dev)
        state = create_train_state(model)
        step = make_train_step("cmflow", model, VOD_CAMERA_PROJECTION,
                               VOD_T_CAMERA_RADAR)
        before = fused.gather_rows.launches
        items = step(state, batch)
        torch.cuda.synchronize()
        runs[mode] = ({k: float(v) for k, v in items.items()},
                      {k: v.detach().cpu() for k, v in
                       model.state_dict().items()},
                      fused.gather_rows.launches - before)
    for mode in (True, "dots"):
        assert runs[mode][0] == runs[False][0]
        for k, v in runs[False][1].items():
            assert torch.equal(v, runs[mode][1][k]), (mode, k)
    assert runs["dots"][2] == runs[False][2] == 17
    assert runs[True][2] > 17
