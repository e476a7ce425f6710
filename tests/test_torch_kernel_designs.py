"""The designs of K7 (the gather's backward, ``csrc/gather.cu``) and K2 (kNN,
``csrc/neighbors.cu::knn_kernel``), modelled on the CPU.

The CUDA kernels run only on the card (``tests/test_torch_cuda.py``).  Here
numpy models written in this file, used by nothing in the package, follow
their arithmetic step by step and are held to the JAX package and to the
port's plain versions:

* (a) the CSR build, ``gather_rows_csr``: its plain version, and a model of
  the kernel's ranks (a cluster of R blocks per element, each a slice of m,
  per-warp ranges of it, lanes with equal bins ranked by lane, per-(block,
  warp, bin) counts scanned over bins, then block ranks, then warps; the
  rows no index names, which the build zeroes), against a numpy stable
  argsort, with R in {1, 8, 16}, on the skewed ball-query indices of a
  train batch, with out-of-range indices, rows that no index names, M a
  multiple of no R * 32 and N past the shared-memory threshold; the launch
  shape and constants read from ``csrc/gather.cu``.  Exact.
* (b) the piecewise sum: pieces of ``GATHER_BWD_PIECE`` sorted entries, runs
  of one row summed by lane groups in the kernel's order and combined by
  its xor tree, rows that span pieces added from their partials in piece
  order by the warp that takes the row's last ticket, the pieces' warps in
  random orders (two orders, the same bits).  Held to the JAX ``mxu_group_points`` backward in interpret mode:
  bit-identical on cotangents with at most 15 significant bits (whose sums
  float32 holds exactly, as ``tests/test_torch_ops.py`` argues), within
  1e-5 of the largest magnitude on normal ones.  Every output row must be
  written exactly once.
* (c) K2's lane lists and warp merge: lane l keeps the k best (d^2, j) of
  its points j = l (mod 32), inserting on a strictly smaller d^2; k rounds of
  a butterfly argmin over the lanes' heads pop them.  Bit-identical to
  ``knn_plain`` and to ``knn_pallas(interpret=True)`` with exact ties, an
  invalid tail, fewer valid points than k, N not a multiple of 32.

* (d) K4b's schedule (``csrc/cost_volume.cu::cv_agg_kernel``): blocks of
  ``kAggQ`` queries of one batch element (a ragged last tile), neighbours in
  chunks of ``kAggKc``, the WeightNet's hidden layer once per (query,
  neighbour), each thread's queries ``tid / 128``, +2, ..., and the sum over
  k ascending, with the constants read from the CUDA source.  Held to
  ``cost_volume_agg_plain`` at k = 1, 8, 40, with indices outside [0, N)
  (-1, N, 4096), within 1e-4 and 1e-5 of the largest magnitude; every
  output row written exactly once.  The bf16 arm (``cv_agg_bf16_kernel``)
  runs the same body on bf16 p2p, each value widened to float32 exactly:
  the same model on p2p rounded to bf16 is held to the plain version on
  the bf16 tensor at the same bars.  At any C (``cv_agg_any_kernel``) the
  same body runs in chunks of the row, the plan's (``cv_agg_plan`` at the
  served B=16, N=256): at C = 1, 3, 100, 511, 768 and 826, in float32 and
  on bf16 p2p, every chunk's columns written once, at the same bars.

* (e) the bf16 arms of K5 and K4a (``csrc/plf.cu::plf_bf16_kernel``,
  ``csrc/cost_volume.cu::cv_p2p_bf16_kernel``) on their wrappers' plans
  (``plf_plan``, ``cv_p2p_plan``, here for a card of four blocks): runs of
  whole queries a block, their rows in full tiles of ``kRows`` /
  ``kP2pRows`` rows across query boundaries, a query's running max (K5)
  or sum in ascending k (K4a) carried from tile to tile; blocks in
  clusters of ``kBf16Cluster``, the grid padded to whole clusters, every
  block through the plan's tiles (the weight stages are shared), a
  padding block writing nothing;
  x0 and x1 rounded to bf16 before each product, the products summed in
  float32; the constants read from the CUDA sources.  Every output row
  written exactly once; held within 1e-2 of the output's largest magnitude
  to the bf16 plain versions and to the JAX kernels in interpret mode
  (``fused_point_local_feature``, and ``fused_cost_volume`` with the
  model's point-to-patch cost through K4b's plain version), at K inside
  the old limits (K5 64, K4a 32) and past them.

* (f) K3's bf16 arm (``csrc/mse.cu::mse_bf16_kernel``): each gathered
  row's base formed in the kernel (``feats @ w0f`` and ``(xyz - ctr) @
  w0r``, each a product then fused multiply-adds in ascending channel
  order, one add, one rounding to bf16), held to ``make_mse_base`` bit for
  bit at Cf = 3 and 5, and through the chain (the query's offset, the
  affines, both bf16 products, the max) within 1e-2 of the output's
  largest magnitude to the plain bf16 version (indices outside [0, N)
  included) and to the JAX kernel in bf16 in interpret mode.

* (g) K2 past k = 64 (``csrc/neighbors.cu::knn_select_kernel``): keys
  (d^2 bits << 32 | j), windows of ``kSelWindow`` ranks (read from the
  source, and 32 to cut k into several), each window's upper bound by a
  radix select eight bits a pass that stops once the rank falls on a bin's
  first key (and otherwise goes on into the index's low bytes), the keys
  between two bounds gathered and sorted.  Bit-identical to ``knn_plain``
  and to JAX's ``pointops.knn`` at k = 65, 100, 128 and k = N, with exact
  ties and an invalid tail (many keys at BIG); on distinct distances the
  select stops within the distance's four bytes.

* (h) FPS (``csrc/sampling.cu``): a block of W warps, R points a thread
  in registers (j = t + r * 32W) and the rest past them in ascending j, a
  tree argmax over r, the warp's argmax as a max of the distance's bits
  then a min of the index over the lanes holding it, the same over the
  warps' slots.  Bit-identical to the plain version and to JAX's
  ``farthest_point_sample`` for W in {1, 2, 4, 8}, N from 1 to 5000,
  with exact ties and npoint past N.

And the lifted point limit: the port's ``knn`` and ``ball_query_multi`` at
N=2500 against ``cmflow_tpu.ops.pointops`` (its XLA route on the CPU).
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmflow_tpu.ops import fused as jfused
from cmflow_tpu.ops import pointops as jpo
from cmflow_tpu.ops.fused import mxu_group_points
from cmflow_tpu.ops.neighbors import knn_pallas
from cmflow_tpu_torch.data.synthetic import make_train_batch
from cmflow_tpu_torch.native import build
from cmflow_tpu_torch.ops import fused, neighbors, sampling

L = fused.GATHER_BWD_PIECE
F32 = np.float32


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture
def rs():
    return np.random.RandomState(11)


def t(x):
    return torch.from_numpy(np.asarray(x))


def j(x):
    return None if x is None else jnp.asarray(x)


def bf16_exact(rs, shape):
    """float32 values with at most 15 significant bits."""
    return (rs.randint(-2 ** 14, 2 ** 14, shape) / 64.0).astype(F32)


def ball_indices(b, n, radius, k):
    """The ball query's indices on pc1 of a train batch: low indices are
    named far more often than high ones."""
    pc = t(make_train_batch(0, b, n)["pc1"])
    (idx,) = neighbors.ball_query_multi((radius,), (k,), pc, pc)
    return idx.numpy().reshape(b, -1)


def with_edges(idx, n):
    """Some indices outside [0, N), and row 3 named by no index."""
    idx = idx.copy()
    idx[idx == 3] = 2
    idx[0, :4] = [-1, n, n + 9, -100]
    idx[-1, -3:] = [n, -2, 4 * n]
    return idx


# ---------------------------------------------------------------------------
# (a) the CSR build
# ---------------------------------------------------------------------------

def csr_reference(idx, n):
    """offsets and order from a numpy stable argsort of the bins."""
    bins = np.where((idx >= 0) & (idx < n), idx, n)
    order = np.argsort(bins, axis=-1, kind="stable").astype(np.int32)
    counts = np.stack([np.bincount(r, minlength=n + 1) for r in bins])
    offsets = np.zeros((idx.shape[0], n + 1), np.int32)
    offsets[:, 1:] = np.cumsum(counts[:, :n], axis=-1)
    return offsets, order


def gather_constant(name):
    """A constant of ``csrc/gather.cu`` (a number or a product of two)."""
    text = (build.CSRC / "gather.cu").read_text()
    expr = re.search(rf"constexpr int {name} = ([\d *]+);", text).group(1)
    return int(np.prod([int(x) for x in expr.split("*")]))


def csr_shape(n, m, cluster=None):
    """The CSR build's launch (``gather.cu::csr_shape``): (blocks an
    element, warps a block, counts in device scratch); ``cluster`` forces
    the blocks an element."""
    fit = gather_constant("kCsrMaxSmem") // 4 // (n + 1) - 1
    in_scratch = fit < 1
    if cluster is None:
        cluster = (gather_constant("kCsrCluster") if not in_scratch
                   and n + 1 <= gather_constant("kCsrClusterBins") else 1)
    want = max(-(-m // 32) if m > 32 else 1, gather_constant("kCsrMinWarps"))
    if in_scratch:
        warps = gather_constant("kCsrGlobalWarps")
    elif cluster > 1:  # beside every block's totals
        warps = min(fit + 1 - cluster, gather_constant("kCsrClusterWarps"))
    else:
        warps = min(fit, gather_constant("kCsrMaxWarps"), want)
    return cluster, warps, in_scratch


def csr_cluster_model(idx, n, cluster=None, warps=None):
    """The kernel's CSR build: ``cluster`` blocks per element, block q
    taking the q-th slice of m and each of its warps a contiguous range of
    that slice, 32 entries at a time; per (block, warp, bin) counts; a
    bin's start (the totals, which every block holds of every block,
    scanned over the bins), plus the counts of the blocks before this one,
    plus those of the block's warps before this one, is a warp's first
    position in the bin; an entry's place is that
    plus the warp's earlier entries of the bin plus the lanes below it in
    the same step with its bin.  Returns (offsets, order, the rows no index
    names, which the CSR build zeroes)."""
    b, m = idx.shape
    cluster, shape_warps, _ = csr_shape(n, m, cluster)
    warps = warps or shape_warps
    bins = np.where((idx >= 0) & (idx < n), idx, n)
    bspan = -(-m // cluster)
    ranges = []  # (lo, hi) of each (block, warp)
    for q in range(cluster):
        blo = min(q * bspan, m)
        bhi = min(blo + bspan, m)
        span = -(-(bhi - blo) // warps)
        for w in range(warps):
            lo = min(blo + w * span, bhi)
            ranges.append((lo, min(lo + span, bhi)))
    offsets = np.zeros((b, n + 1), np.int32)
    order = np.full((b, m), -1, np.int32)
    for bi in range(b):
        wc = np.zeros((cluster * warps, n + 1), np.int64)
        for i, (lo, hi) in enumerate(ranges):
            np.add.at(wc[i], bins[bi, lo:hi], 1)
        wc = wc.reshape(cluster, warps, n + 1)
        tot = wc.sum(1)  # each block's totals
        total = tot.sum(0)
        start = np.cumsum(total) - total
        first = (start + (np.cumsum(tot, 0) - tot)[:, None, :]
                 + np.cumsum(wc, 1) - wc).reshape(cluster * warps, n + 1)
        offsets[bi] = start
        for i, (lo, hi) in enumerate(ranges):
            run = first[i].copy()
            for j0 in range(lo, hi, 32):
                step = bins[bi, j0:min(j0 + 32, hi)]
                rank = np.tril(step[:, None] == step[None, :], -1).sum(1)
                order[bi, run[step] + rank] = j0 + np.arange(len(step))
                np.add.at(run, step, 1)
    unnamed = offsets[:, 1:] == offsets[:, :-1]
    return offsets, order, unnamed


@pytest.mark.parametrize("radius, k", [(16.0, 32), (8.0, 16), (2.0, 4)])
def test_csr_plain_on_skewed_indices(radius, k):
    b, n = 4, 256
    idx = with_edges(ball_indices(b, n, radius, k), n)
    counts = np.bincount(idx[(idx >= 0) & (idx < n)], minlength=n)
    assert counts.max() > 4 * counts[counts > 0].mean()  # skewed
    got = fused.gather_rows_csr(t(idx), n)
    want = csr_reference(idx, n)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), w)
    off = want[0]
    assert (off[:, 3] == off[:, 4]).all()  # the empty row


@pytest.mark.parametrize("warps, m", [(32, 8192), (7, 1000), (1, 77), (5, 3)])
def test_csr_kernel_model(rs, warps, m):
    """One block an element (clusters of one), as many warps as given."""
    n = 64
    idx = rs.randint(-3, n + 3, (2, m)).astype(np.int32)
    idx[:, rs.rand(m) < 0.3] = 0  # one heavy row
    idx[idx == 9] = 10            # and an empty one
    got = csr_cluster_model(idx, n, cluster=1, warps=warps)
    for g, w in zip(got, csr_reference(idx, n)):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("cluster", [1, 8, 16])
@pytest.mark.parametrize("case", ["ball", "ragged", "above_smem"])
def test_csr_cluster_model(rs, cluster, case):
    """The cluster build against a stable argsort and the plain version:
    the skewed ball-query indices of a train batch with indices outside
    [0, N) and a row no index names; M = 845, a multiple of no R * 32; N
    past the rows whose counts fit in shared memory (where the kernel takes
    one block with its counts in device scratch)."""
    if case == "ball":
        n = 256
        idx = with_edges(ball_indices(2, n, 8.0, 16), n)
    else:
        n, m = (64, 845) if case == "ragged" else (26000, 700)
        idx = rs.randint(-3, n + 3, (2, m)).astype(np.int32)
        idx[:, rs.rand(m) < 0.3] = 0
        idx[idx == 9] = 10
    expect = (1, True) if case == "above_smem" else (
        gather_constant("kCsrCluster"), False)
    shape = csr_shape(n, idx.shape[1])
    assert (shape[0], shape[2]) == expect
    offsets, order, unnamed = csr_cluster_model(idx, n, cluster)
    want = csr_reference(idx, n)
    plain = fused.gather_rows_csr_plain(t(idx), n)
    for got, w, pl in zip((offsets, order), want, plain):
        np.testing.assert_array_equal(got, w)
        np.testing.assert_array_equal(got, pl.numpy())
    named = np.zeros(unnamed.shape, bool)
    for bi in range(idx.shape[0]):
        named[bi, idx[bi][(idx[bi] >= 0) & (idx[bi] < n)]] = True
    np.testing.assert_array_equal(unnamed, ~named)
    assert unnamed[:, 3 if case == "ball" else 9].all()


# ---------------------------------------------------------------------------
# (b) the piecewise sum
# ---------------------------------------------------------------------------

def group_lanes(elems):
    """Lanes that take one row: the least power of two >= elems, up to 32."""
    g = 1
    while g < elems and g < 32:
        g *= 2
    return g


def piecewise_sum(g, idx, n, vec4, rs=None):
    """K7's sum on the CSR form of ``idx``, in the kernels' order, in
    float32.  The CSR build zeroes the rows no index names; the pieces'
    warps then run in a random order (``rs``): a warp that writes a row's
    partial takes the next ticket of the row, and the one that takes its
    last ticket adds the row's partials in piece order."""
    rs = rs or np.random.RandomState(0)
    b, m, c = g.shape
    offsets, order = csr_reference(idx, n)
    groups = 32 // group_lanes(c // 4 if vec4 else c)
    pieces = -(-m // L)
    out = np.full((b, n, c), np.nan, F32)
    part = np.full((b, max(pieces, 1), 2, c), np.nan, F32)
    writes = np.zeros((b, n), np.int64)
    for bi in range(b):
        unnamed = offsets[bi, 1:] == offsets[bi, :-1]
        out[bi, unnamed] = 0.0
        writes[bi, unnamed] += 1
        tickets = np.zeros(n, np.int64)
        total = offsets[bi, n]
        for p in rs.permutation(pieces):
            s = p * L
            if s >= total:
                continue
            cnt = min(L, total - s)
            ms = order[bi, s:s + cnt]
            rows = idx[bi, ms]
            head_open = offsets[bi, rows[0]] < s
            tail_open = offsets[bi, rows[-1] + 1] > s + cnt
            starts = [i for i in range(cnt) if i == 0 or rows[i] != rows[i - 1]]
            for lo, hi in zip(starts, starts[1:] + [cnt]):
                acc = [np.zeros(c, F32) for _ in range(groups)]
                for i in range(lo, hi):  # entry i belongs to group i % groups
                    acc[i % groups] = acc[i % groups] + g[bi, ms[i]]
                h = 1
                while h < groups:  # the xor-shuffle tree
                    acc = [acc[q] + acc[q ^ h] for q in range(groups)]
                    h *= 2
                r = rows[lo]
                first = lo == 0 and head_open
                if not (first or (hi == cnt and tail_open)):
                    out[bi, r] = acc[0]
                    writes[bi, r] += 1
                    continue
                part[bi, p, 0 if first else 1] = acc[0]
                p0 = offsets[bi, r] // L
                p1 = (offsets[bi, r + 1] - 1) // L
                tickets[r] += 1
                if tickets[r] == p1 - p0 + 1:  # the row's last ticket
                    total_r = part[bi, p0, 1]
                    for q in range(p0 + 1, p1 + 1):
                        total_r = total_r + part[bi, q, 0]
                    out[bi, r] = total_r
                    writes[bi, r] += 1
    assert (writes == 1).all()  # every row written exactly once
    assert not np.isnan(out).any()
    return out


def jax_gather_grad(n, idx, cot):
    """``jax.grad`` through the Pallas gather in interpret mode, whose
    backward is ``_gather_bwd_kernel``; ``idx`` [B, M], ``cot`` [B, M, C]."""
    b, m, c = cot.shape
    pts = jnp.zeros((b, n, c), jnp.float32)
    return np.asarray(jax.grad(lambda p: jnp.sum(
        mxu_group_points(p, j(idx)[:, :, None], True)[:, :, 0] * j(cot)))(pts))


# (C, vec4): the smoothness loss's C=3 (groups of 4 lanes), a single float4
# (32 groups of one lane), the sa encoder's C=32 on the float4 path (groups
# of 8) and on the scalar path (the whole warp), a row of 32 float4s
SUM_WIDTHS = [(3, False), (4, True), (32, True), (32, False), (128, True)]


@pytest.mark.parametrize("c, vec4", SUM_WIDTHS)
def test_piecewise_sum_on_skewed_indices(rs, c, vec4):
    b, n = 2, 128
    idx = with_edges(ball_indices(b, n, 8.0, 16), n)  # M = 2048
    exact = bf16_exact(rs, idx.shape + (c,))
    got = piecewise_sum(exact, idx, n, vec4)
    np.testing.assert_array_equal(got, jax_gather_grad(n, idx, exact))
    cot = rs.randn(*idx.shape, c).astype(F32)
    got = piecewise_sum(cot, idx, n, vec4)
    # the warps' order decides who adds a row's partials, never the sum
    np.testing.assert_array_equal(
        got, piecewise_sum(cot, idx, n, vec4, np.random.RandomState(1)))
    want = jax_gather_grad(n, idx, cot)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())
    plain = fused.gather_rows_backward(t(cot), t(idx), n).numpy()
    np.testing.assert_allclose(got, plain, rtol=0,
                               atol=1e-5 * np.abs(plain).max())


@pytest.mark.parametrize("c, vec4", [(3, False), (32, True), (128, True)])
def test_piecewise_sum_one_row_named_by_every_m(rs, c, vec4):
    """Every m names row 5 (M = 300, not a multiple of the piece): the row
    spans ten pieces and is added from their partials; every other row is
    zero."""
    b, n, m = 2, 40, 300
    idx = np.full((b, m), 5, np.int32)
    idx[1, 7] = n  # one index outside [0, N)
    exact = bf16_exact(rs, (b, m, c))
    got = piecewise_sum(exact, idx, n, vec4)
    np.testing.assert_array_equal(got, jax_gather_grad(n, idx, exact))
    assert (np.delete(got, 5, axis=1) == 0).all()
    cot = rs.randn(b, m, c).astype(F32)
    got = piecewise_sum(cot, idx, n, vec4)
    want = jax_gather_grad(n, idx, cot)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


# ---------------------------------------------------------------------------
# (c) K2: lane lists and the warp merge
# ---------------------------------------------------------------------------

def knn_model(k, dist):
    """K2 on the squared distances ``dist`` [Q, N] (float32, invalid points
    at BIG), vectorised over queries and lanes."""
    q, n = dist.shape
    kmax = next(x for x in (8, 16, 32, 64) if k <= x)
    inf, none = np.float32(np.inf), np.iinfo(np.int32).max
    bd = np.full((q, 32, kmax), inf, F32)
    bj = np.full((q, 32, kmax), none, np.int64)
    lanes = np.arange(32)
    for j0 in range(0, n, 32):
        jj = j0 + lanes
        live = jj < n
        cd = np.where(live[None, :], dist[:, np.minimum(jj, n - 1)], inf)
        cj = np.broadcast_to(jj, (q, 32)).copy()
        enter = live[None, :] & (cd < bd[..., -1])  # strictly smaller only
        for slot in range(kmax):
            less = enter & ((cd < bd[..., slot])
                            | ((cd == bd[..., slot]) & (cj < bj[..., slot])))
            td, tj = bd[..., slot].copy(), bj[..., slot].copy()
            bd[..., slot] = np.where(less, cd, td)
            bj[..., slot] = np.where(less, cj, tj)
            cd, cj = np.where(less, td, cd), np.where(less, tj, cj)
    out = np.zeros((q, k), np.int64)
    rows = np.arange(q)
    for slot in range(k):
        d, jw = bd[..., 0].copy(), bj[..., 0].copy()
        for off in (16, 8, 4, 2, 1):  # the butterfly argmin
            od, oj = d[:, lanes ^ off], jw[:, lanes ^ off]
            less = (od < d) | ((od == d) & (oj < jw))
            d, jw = np.where(less, od, d), np.where(less, oj, jw)
        assert (jw == jw[:, :1]).all()  # every lane agrees
        win = jw[:, 0]
        out[:, slot] = win
        lane = win % 32
        bd[rows, lane, :-1] = bd[rows, lane, 1:].copy()
        bj[rows, lane, :-1] = bj[rows, lane, 1:].copy()
        bd[rows, lane, -1], bj[rows, lane, -1] = inf, none
    return out.astype(np.int32)


def knn_case(rs, case):
    """(query [B,S,3], points [B,N,3], valid [B,N] or None)."""
    if case == "ties":  # four distinct points, each 50 times: exact ties
        base = np.array([[0.0, 0, 0], [1, 0, 0], [1, 0, 0], [2, 0, 0]], F32)
        p = np.tile(base, (2, 50, 1))
        return p[:, :128].copy(), p, None
    if case == "invalid_tail":  # N=200; element 0 has 5 valid points
        p = (rs.rand(2, 200, 3) * 20).astype(F32)
        v = np.arange(200)[None, :] < np.array([[5], [150]])
        v[1, rs.rand(200) < 0.2] = False
        return (rs.rand(2, 128, 3) * 20).astype(F32), p, v
    p = (rs.rand(2, 77, 3) * 20).astype(F32)  # N not a multiple of 32
    p[:, 40:60] = p[:, 10:30]                # duplicate points
    return p[:, :64].copy(), p, None


@pytest.mark.parametrize("k", [1, 8, 33, 64])
@pytest.mark.parametrize("case", ["ties", "invalid_tail", "ragged"])
def test_knn_lane_lists_and_merge(rs, case, k):
    q, p, v = knn_case(rs, case)
    b, s, _ = q.shape
    dist = neighbors.masked_square_distance(
        t(q), t(p), None if v is None else t(v)).numpy()
    got = knn_model(k, dist.reshape(b * s, -1)).reshape(b, s, k)
    want = neighbors.knn_plain(k, t(q), t(p), None if v is None else t(v))
    np.testing.assert_array_equal(got, want.numpy())
    np.testing.assert_array_equal(
        got, knn_pallas(k, j(q), j(p), True, points_valid=j(v)))


# ---------------------------------------------------------------------------
# (d) K4b: query tiles, neighbour chunks, the hidden layer once per pair
# ---------------------------------------------------------------------------

def cv_agg_constant(name):
    src = (build.CSRC / "cost_volume.cu").read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


def cv_agg_model(p2p, idx, zq, wn, plan=None):
    """K4b on numpy float32 arrays, block by block and chunk by chunk as the
    kernel runs, its threads' channels vectorised: (out, how often each row
    was written).  ``plan``: ``fused.cv_agg_plan``'s chunk of the kernel at
    any C (``cv_agg_any_kernel``: ``cells`` cells of four channels a
    block, ``per`` queries a thread); None for the C = 512 kernel, whose
    block the source's constants give."""
    threads = cv_agg_constant("kAggThreads")
    kc = cv_agg_constant("kAggKc")
    b0, w1, b1, w2, b2 = wn
    bsz, n, c = p2p.shape
    k, h = idx.shape[2], zq.shape[2]
    if plan is None:
        assert c == fused.CV_WIDTH
        cells, per = c // 4, cv_agg_constant("kAggPer")
    else:
        cells, per = plan["cells"], plan["per"]
    slots = threads // cells
    q_tile = slots * per
    if plan is None:
        assert q_tile == cv_agg_constant("kAggQ")
    assert q_tile * kc <= cv_agg_constant("kAggMaxPairs")
    chunks = -(-(-(-c // 4)) // cells)
    out = np.full(p2p.shape, np.nan, F32)
    writes = np.zeros((bsz, n), np.int64)
    tiles = -(-n // q_tile)
    for blk in range(bsz * tiles):
        e, i0 = blk // tiles, (blk % tiles) * q_tile
        for chunk in range(chunks):  # blockIdx.y; cells past C stay idle
            ch = slice(4 * cells * chunk, min(c, 4 * cells * (chunk + 1)))
            acc = np.zeros((q_tile, ch.stop - ch.start), F32)
            for k0 in range(0, k, kc):
                # a thread per (query, neighbour) of the chunk, the hidden
                # layer again for each chunk of the row
                h_s = np.zeros((q_tile, kc, h), F32)
                j_s = np.full((q_tile, kc), -1)
                for qi in range(q_tile):
                    for kk in range(kc):
                        i = i0 + qi
                        if i >= n or k0 + kk >= k:
                            continue
                        jj = idx[e, i, k0 + kk]
                        inside = 0 <= jj < n
                        d = ((zq[e, jj] if inside else np.zeros(h, F32))
                             - zq[e, i])
                        a = np.maximum(d + b0, F32(0))
                        hid = np.zeros(h, F32)
                        for m in range(h):  # ascending m
                            hid = hid + a[m] * w1[m]
                        h_s[qi, kk] = np.maximum(hid + b1, F32(0))
                        j_s[qi, kk] = jj if inside else -1
                kn = min(kc, k - k0)
                for s in range(per):
                    for slot in range(slots):
                        qi = slot + slots * s
                        if i0 + qi >= n:
                            continue
                        g = [p2p[e, j, ch] if j >= 0
                             else np.zeros(ch.stop - ch.start, F32)
                             for j in j_s[qi]]
                        for kk in range(kn):  # ascending k
                            t_ = np.zeros(ch.stop - ch.start, F32)
                            for m in range(h):
                                t_ = t_ + h_s[qi, kk, m] * w2[m, ch]
                            acc[qi] = acc[qi] + np.maximum(
                                t_ + b2[ch], F32(0)) * g[kk]
            for qi in range(q_tile):
                if i0 + qi < n:
                    out[e, i0 + qi, ch] = acc[qi]
                    writes[e, i0 + qi] += 1
    assert (writes == chunks).all()
    return out, writes // chunks


def check_cv_agg_schedule(rs, k, dtype, c=fused.CV_WIDTH, plan=None):
    b, n, h = 2, 37, fused.WEIGHTNET_HIDDEN
    assert n % cv_agg_constant("kAggQ")  # a ragged last tile
    p2p = t(rs.randn(b, n, c).astype(F32)).to(dtype)
    zq = rs.randn(b, n, h).astype(F32)
    idx = rs.randint(0, n, (b, n, k)).astype(np.int32)
    idx[0, :3, 0] = [-1, n, 4096]
    idx[1, -1, -1] = -7
    wn = [(rs.randn(*shape) * 0.5).astype(F32)
          for shape in ((h,), (h, h), (h,), (h, c), (c,))]
    got, writes = cv_agg_model(p2p.float().numpy(), idx, zq, wn, plan)
    assert (writes == 1).all()
    want = fused.cost_volume_agg_plain(p2p, t(idx), t(zq),
                                       [t(w) for w in wn]).numpy()
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert scale > 0.1 and err <= 1e-4 and err <= 1e-5 * scale, (err, scale)


@pytest.mark.parametrize("k", [1, 8, 40])
def test_cv_agg_schedule(rs, k):
    check_cv_agg_schedule(rs, k, torch.float32)


@pytest.mark.parametrize("k", [1, 8, 40])
def test_cv_agg_bf16_schedule(rs, k):
    check_cv_agg_schedule(rs, k, BF16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [1, 3, 100, 511, 768, 826])
def test_cv_agg_any_c_schedule(rs, c, dtype):
    """K4b at any C (``cv_agg_any_kernel``) in the chunks its plan gives the
    served shape (B=16, N=256: config B's C=768 in three chunks of 64 cells,
    24 queries a block), on two clouds of 37 points: rows whose last cell
    holds fewer than four channels (C = 1, 3, 511, 826), chunks past the
    row's cells idle, against the plain version (bf16 p2p widened
    exactly)."""
    plan = fused.cv_agg_plan(c, 16, 256)
    if c == 768:
        assert (plan["cells"], plan["chunks"], plan["queries"]) == (64, 3, 24)
    check_cv_agg_schedule(rs, 8, dtype, c, plan)


# ---------------------------------------------------------------------------
# (e) the bf16 arms of K5 and K4a: tiles, queries over tiles, clusters
# ---------------------------------------------------------------------------

BF16 = torch.bfloat16


def src_constant(source, name):
    text = (build.CSRC / source).read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


def bf16_round(x):
    """float32 values rounded to bf16 (to nearest even), as float32."""
    return torch.from_numpy(np.ascontiguousarray(x, F32)).to(BF16).float(
        ).numpy()


# the card the bf16 schedules are planned for here: few blocks, so that a
# block takes several queries and a query runs over tiles
BF16_SLOTS = 4


def bf16_schedule(source, tile_name, total, k):
    """The launch and tiles of a bf16 arm, from its wrapper's plan on a
    card of BF16_SLOTS blocks: (queries a block, tiles a block, blocks of
    the grid, rows a tile, blocks a cluster)."""
    tile_rows = src_constant(source, tile_name)
    cluster = src_constant(source, "kBf16Cluster")
    plan = (fused.plf_plan(total, k, BF16_SLOTS) if source == "plf.cu"
            else fused.cv_p2p_plan(total, k, BF16_SLOTS, cluster))
    assert tile_rows == (fused.PLF_ROWS if source == "plf.cu"
                         else fused.CV_P2P_ROWS)
    return plan["qpb"], plan["tiles"], plan["grid"], tile_rows, cluster


def bf16_arm_model(source, tile_name, idx, n, tile_fn, combine, c_out):
    """A bf16 arm block by block and tile by tile, in full tiles across
    query boundaries: ``tile_fn(q, j, used)`` gives the tile's rows
    (query, neighbour row in the batch or -1, used) their values;
    ``combine(acc, values)`` folds a query's rows of one tile into its
    running result, ``acc`` None on its first tile; a query is written at
    its last row.  Returns (out, how often each row was written, tiles
    each block ran, by cluster)."""
    bsz, _, k = idx.shape
    total = bsz * n
    qpb, tiles, blocks, tile_rows, cluster = bf16_schedule(
        source, tile_name, total, k)
    flat = idx.reshape(total, k)
    out = np.full((total, c_out), np.nan, F32)
    writes = np.zeros(total, np.int64)
    ran = np.zeros(blocks, np.int64)
    assert blocks % cluster == 0 and blocks * qpb >= total
    for blk in range(blocks):
        q0 = blk * qpb
        rows = max(0, min(qpb, total - q0)) * k
        carry = {}
        for tile in range(tiles):  # every block, its padding too
            ran[blk] += 1
            rg = tile * tile_rows + np.arange(tile_rows)
            used = rg < rows
            q = np.where(used, q0 + rg // k, 0)
            jj = np.where(used, flat[q, rg % k], -1)
            inside = used & (jj >= 0) & (jj < n)
            j = np.where(inside, (q // n) * n + jj, -1)
            vals = tile_fn(q, j, used)
            qend = min(((tile + 1) * tile_rows - 1) // k + 1, rows // k)
            for qi in range(tile * tile_rows // k, qend):
                lo = max(qi * k, tile * tile_rows)
                hi = min(qi * k + k, (tile + 1) * tile_rows)
                carry[qi] = combine(carry.get(qi),
                                    vals[lo - tile * tile_rows:
                                         hi - tile * tile_rows])
                if hi == qi * k + k:
                    out[q0 + qi] = carry.pop(qi)
                    writes[q0 + qi] += 1
    return out, writes, ran.reshape(-1, cluster)


def plf_bf16_model(base, idx, xyz_c, chain):
    """K5's bf16 arm: base [B*N, C1] and the chain's wrel and Dense kernels
    bf16 values in float32, the affines float32."""
    wrel, s0, b0, w1, s1, b1, w2, s2, b2 = chain
    n = idx.shape[1]

    def tile_fn(q, j, used):
        g = np.where((j >= 0)[:, None], base[np.maximum(j, 0)], F32(0))
        x0 = np.maximum((g - xyz_c[q] @ wrel) * s0 + b0, F32(0))
        x0 = bf16_round(np.where(used[:, None], x0, F32(0)))
        x1 = bf16_round(np.maximum((x0 @ w1) * s1 + b1, F32(0)))
        return np.maximum((x1 @ w2) * s2 + b2, F32(0))

    def running_max(acc, rows):
        m = rows.max(axis=0)
        return m if acc is None else np.maximum(acc, m)

    return bf16_arm_model("plf.cu", "kRows", idx, n, tile_fn, running_max,
                          w2.shape[1])


def cv_p2p_bf16_model(f1c, f2c, idx, z1, z2, dense, wn):
    """K4a's bf16 arm: f1c, f2c [B*N, C] and the Dense kernels bf16 values
    in float32; the sum over k ascending, rounded to bf16 once."""
    b0, w1, b1, w2, b2 = dense
    n = idx.shape[1]

    def leaky(x):
        return np.where(x > 0, x, F32(0.1) * x)

    def tile_fn(q, j, used):
        g = np.where((j >= 0)[:, None], f2c[np.maximum(j, 0)], F32(0))
        x0 = bf16_round(np.where(used[:, None], leaky((f1c[q] + g) + b0),
                                 F32(0)))
        x1 = bf16_round(leaky(x0 @ w1 + b1))
        x2 = leaky(x1 @ w2 + b2)
        zj = np.where((j >= 0)[:, None], z2[np.maximum(j, 0)], F32(0))
        w = fused._weightnet_tail(t(zj - z1[q]), [t(a) for a in wn]).numpy()
        return w * x2

    def running_sum(acc, rows):
        for v in rows:  # k ascending
            acc = v.copy() if acc is None else acc + v
        return acc

    out, writes, ran = bf16_arm_model("cost_volume.cu", "kP2pRows", idx, n,
                                      tile_fn, running_sum, f1c.shape[1])
    return bf16_round(out), writes, ran


def bf16_close(got, want):
    got, want = np.asarray(got, F32), np.asarray(want, F32)
    assert got.shape == want.shape
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert scale > 0.1 and err <= 1e-2 * scale, (err, scale)


def plf_bf16_case(rs, k, b=1, n=37):
    """Full-width K5 inputs in bf16 (the chain as ``_cast_chain`` casts
    it); indices with some outside [0, N)."""
    c1, c2, c3 = fused.PLF_WIDTHS
    xyz = (rs.randn(b, n, 3) * 5).astype(F32)
    feat = rs.randn(b, n, c1).astype(F32)
    idx = rs.randint(-2, n + 2, (b, n, k)).astype(np.int32)
    chain = [(rs.randn(3, c1) * 0.3).astype(F32)]
    for cin, cout in ((None, c1), (c1, c2), (c2, c3)):
        if cin:
            chain.append((rs.randn(cin, cout) / np.sqrt(cin)).astype(F32))
        chain += [rs.uniform(0.5, 1.5, cout).astype(F32),
                  rs.uniform(-0.2, 0.2, cout).astype(F32)]
    chain = [bf16_round(a) if i % 3 == 0 else a for i, a in enumerate(chain)]
    return bf16_round(feat), idx, xyz, chain


@pytest.mark.parametrize("k", [8, 100, 128, 129, 200])
def test_plf_bf16_schedule(rs, k):
    """37 queries in 4 blocks of 10 (the last 7): a block's rows in one
    tile (k=8), tiles holding pieces of two queries (100), whole tiles a
    query (128), queries over two or three tiles (129, 200): against the
    plain bf16 version."""
    feat, idx, xyz, chain = plf_bf16_case(rs, k)
    tchain = [t(a).to(BF16) if i % 3 == 0 else t(a)
              for i, a in enumerate(chain)]
    xyz_c = fused.center_xyz(t(xyz))
    base = fused.make_plf_base(t(feat).to(BF16), xyz_c, tchain[0], BF16)
    got, writes, ran = plf_bf16_model(
        base.float().numpy().reshape(-1, fused.PLF_WIDTHS[0]), idx,
        xyz_c.numpy().reshape(-1, 3), chain)
    assert (writes == 1).all() and (ran == ran[0, 0]).all()
    want = fused.fused_point_local_feature_plain(
        t(feat).to(BF16), t(idx), t(xyz), tchain).numpy()
    bf16_close(got.reshape(want.shape), want)


@pytest.mark.parametrize("k", [16, 129])
def test_plf_bf16_schedule_against_pallas(rs, k):
    """The model against the JAX kernel in interpret mode, at a K inside
    the old limit (64) and past it."""
    feat, idx, xyz, chain = plf_bf16_case(rs, k)
    tchain = [t(a).to(BF16) if i % 3 == 0 else t(a)
              for i, a in enumerate(chain)]
    xyz_c = fused.center_xyz(t(xyz))
    base = fused.make_plf_base(t(feat).to(BF16), xyz_c, tchain[0], BF16)
    got, writes, _ = plf_bf16_model(
        base.float().numpy().reshape(-1, fused.PLF_WIDTHS[0]), idx,
        xyz_c.numpy().reshape(-1, 3), chain)
    assert (writes == 1).all()
    jchain = tuple(j(a).astype(jnp.bfloat16) if i % 3 == 0 else j(a)
                   for i, a in enumerate(chain))
    want = jfused.fused_point_local_feature(
        j(feat).astype(jnp.bfloat16), j(idx), j(xyz), jchain, True)
    bf16_close(got.reshape(want.shape), want)


def cv_bf16_case(rs, k, b=1, n=37):
    """Full-width K4a inputs: bf16 frame features, bf16 ``wd``, ``w1``,
    ``w2`` (as JAX's ``_cost_volume`` casts them), float32 biases and
    WeightNets; kNN-like indices with some outside [0, N)."""
    c, h = fused.CV_WIDTH, fused.WEIGHTNET_HIDDEN
    xyz1 = (rs.randn(b, n, 3) * 5).astype(F32)
    xyz2 = xyz1 + (rs.randn(b, n, 3) * 0.3).astype(F32)
    f1t, f2t = (bf16_round(rs.randn(b, n, c)) for _ in range(2))
    idx2 = rs.randint(-2, n + 2, (b, n, k)).astype(np.int32)
    idx1 = rs.randint(0, n, (b, n, 8)).astype(np.int32)
    dense = [bf16_round(rs.randn(3, c) * 0.3), rs.randn(c).astype(F32) * 0.1]
    for _ in range(2):
        dense += [bf16_round(rs.randn(c, c) / np.sqrt(c)),
                  (rs.randn(c) * 0.1).astype(F32)]

    def wn():
        return [(rs.randn(3, h) * 0.3).astype(F32),
                (rs.randn(h) * 0.1).astype(F32),
                (rs.randn(h, h) / np.sqrt(h)).astype(F32),
                (rs.randn(h) * 0.1).astype(F32),
                (rs.randn(h, c) / np.sqrt(h)).astype(F32),
                (rs.randn(c) * 0.1).astype(F32)]
    return f1t, f2t, idx2, idx1, xyz1, xyz2, dense, wn(), wn()


def cv_bf16_model_p2p(case):
    """The folds as the port computes them, then the model's p2p; also the
    folds' zq for K4b."""
    f1t, f2t, idx2, _, xyz1, xyz2, dense, wn1, wn2 = case
    tdense = [t(a).to(BF16) if i % 2 == 0 else t(a)
              for i, a in enumerate(dense)]
    f1c, f2c, z1, z2, zq = fused.cost_volume_folds(
        t(f1t).to(BF16), t(f2t).to(BF16), t(xyz1), t(xyz2), tdense[0],
        t(wn1[0]), t(wn2[0]), BF16)
    c = fused.CV_WIDTH
    p2p, writes, ran = cv_p2p_bf16_model(
        f1c.float().numpy().reshape(-1, c), f2c.float().numpy().reshape(-1, c),
        idx2, z1.numpy().reshape(-1, 8), z2.numpy().reshape(-1, 8),
        dense[1:], wn1[1:])
    args = (f1c, f2c, t(idx2), z1, z2, tdense[1:], [t(a) for a in wn1[1:]])
    return p2p.reshape(f1c.shape), writes, ran, args, zq


@pytest.mark.parametrize("k", [8, 33, 64, 65, 100])
def test_cv_p2p_bf16_schedule(rs, k):
    """37 queries in 4 blocks of 10 (two clusters; the last block 7): whole
    queries in a tile (k=8), tiles holding pieces of several queries (33),
    whole tiles a query (64), queries over two tiles (65, 100): against the
    plain bf16 version."""
    p2p, writes, ran, args, _ = cv_bf16_model_p2p(cv_bf16_case(rs, k))
    assert (writes == 1).all() and (ran == ran[0, 0]).all()
    want = fused.cost_volume_p2p_plain(*args)
    assert want.dtype == BF16
    bf16_close(p2p, want.float().numpy())


@pytest.mark.parametrize("k", [8, 65])
def test_cv_bf16_schedule_against_pallas(rs, k):
    """The model's p2p through K4b's plain version against the JAX cost
    volume in interpret mode, at a K inside the old limit (32) and past
    it."""
    case = cv_bf16_case(rs, k)
    f1t, f2t, idx2, idx1, xyz1, xyz2, dense, wn1, wn2 = case
    p2p, writes, _, _, zq = cv_bf16_model_p2p(case)
    assert (writes == 1).all()
    got = fused.cost_volume_agg_plain(t(p2p).to(BF16), t(idx1), zq,
                                      [t(a) for a in wn2[1:]])
    jdense = tuple(j(a).astype(jnp.bfloat16) if i % 2 == 0 else j(a)
                   for i, a in enumerate(dense))
    want = jfused.fused_cost_volume(
        j(f1t).astype(jnp.bfloat16), j(f2t).astype(jnp.bfloat16), j(idx2),
        j(xyz1), j(idx1), j(xyz2), True, dense=jdense,
        wn1=tuple(map(j, wn1)), wn2=tuple(map(j, wn2)))
    bf16_close(got.numpy(), want)


# ---------------------------------------------------------------------------
# (f) K3's bf16 arm: the first layer formed per gathered row
# ---------------------------------------------------------------------------

def fma32(a, b, c):
    """float32 a * b + c rounded once (the float64 product is exact)."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64)
            + np.asarray(c, np.float64)).astype(F32)


def dot_chain(x, w):
    """``x [..., C] @ w [C, D]`` as the kernel forms it: the first
    channel's product, then one fused multiply-add per channel, in
    ascending order."""
    acc = (x[..., :1] * w[0]).astype(F32)
    for c in range(1, x.shape[-1]):
        acc = fma32(x[..., c:c + 1], w[c], acc)
    return acc


def mse_bf16_base_model(feats, xyz, ctr, w0r, w0f):
    """``csrc/mse.cu::first_layer_bf16``'s base of each point, [B, N, C1]
    per scale: ``feats @ w0f`` and ``(xyz - ctr) @ w0r`` as
    :func:`dot_chain`s, one float32 add, one rounding to bf16."""
    d = (xyz - ctr[:, None, :]).astype(F32)
    f = dot_chain(feats, w0f) if feats.shape[-1] else 0.0
    return bf16_round((f + dot_chain(d, w0r)).astype(F32))


def mse_bf16_model(feats, idx_list, xyz, ctr, packed):
    """The bf16 arm per (query, neighbour) row: the gathered base (zero
    outside [0, N)) less the query's offset (``fmaf(p2, w2, fmaf(p1, w1,
    p0 * w0))``, p = xyz_q - ctr), affine, ReLU, bf16; two products of bf16
    operands (their float32 sums in float64, the tensor cores' order being
    their own), each after affine and ReLU; the max over the neighbours.
    Returns (out, each scale's base)."""
    w0r, w0f, s0, b0, w1, s1, b1, w2, s2, b2 = packed
    bsz, n, _ = xyz.shape
    p = (xyz - ctr[:, None, :]).astype(F32)
    outs, bases = [], []
    for s, idx in enumerate(idx_list):
        c1, c2, c3 = w1.shape[1], w1.shape[2], w2.shape[2]
        r1, r2, r3 = (slice(s * c, (s + 1) * c) for c in (c1, c2, c3))
        base = mse_bf16_base_model(feats, xyz, ctr, w0r[s], w0f[s])
        bases.append(base)
        inside = (idx >= 0) & (idx < n)
        rows = base[np.arange(bsz)[:, None, None], np.where(inside, idx, 0)]
        rows = np.where(inside[..., None], rows, 0.0).astype(F32)
        off = fma32(p[..., 2:3], w0r[s][2], fma32(
            p[..., 1:2], w0r[s][1], (p[..., :1] * w0r[s][0]).astype(F32)))
        x = np.maximum(fma32(rows - off[:, :, None, :], s0[r1], b0[r1]), 0)
        for w, sc, bi in ((w1[s], s1[r2], b1[r2]), (w2[s], s2[r3], b2[r3])):
            prod = (bf16_round(x).astype(np.float64) @ w.astype(np.float64))
            x = np.maximum(fma32(prod.astype(F32), sc, bi), 0)
        outs.append(x.max(axis=2))
    return np.concatenate(outs, axis=-1).astype(F32), bases


def mse_bf16_case(rs, cf, b=1, n=64, ks=(4, 8, 16, 32)):
    """Narrow sa-encoder inputs: bf16 features (channel-strided, as
    collated), points, ball-query indices; weights with ``w1``/``w2``
    rounded to bf16 (the packed layout of
    ``mse_narrow_params_from_variables``, as numpy)."""
    c1, c2, c3 = fused.MSE_WIDTHS
    xyz = (rs.rand(b, n, 3) * 8 + 30).astype(F32)  # away from the origin
    feats = bf16_round(rs.randn(b, n, cf))
    radii = tuple(2.0 * (i + 1) for i in range(len(ks)))
    idx = [np.asarray(i) for i in neighbors.ball_query_multi(
        radii, ks, t(xyz), t(xyz))]
    s_cnt = len(ks)
    w0r = [(rs.randn(3, c1) * 0.5).astype(F32) for _ in ks]
    w0f = [(rs.randn(cf, c1) * 0.5).astype(F32) for _ in ks]
    aff = [rs.uniform(lo, hi, s_cnt * c).astype(F32)
           for c in (c1, c2, c3) for lo, hi in ((0.5, 1.5), (-0.2, 0.2))]
    w1 = bf16_round(rs.randn(s_cnt, c1, c2) / np.sqrt(c1))
    w2 = bf16_round(rs.randn(s_cnt, c2, c3) / np.sqrt(c2))
    packed = (w0r, w0f, aff[0], aff[1], w1, aff[2], aff[3], w2, aff[4],
              aff[5])
    return feats, idx, xyz, packed


def torch_packed(packed):
    w0r, w0f, *rest = packed
    return (tuple(map(t, w0r)), tuple(map(t, w0f))) + tuple(
        t(a).to(BF16) if i in (2, 5) else t(a) for i, a in enumerate(rest))


@pytest.mark.parametrize("cf", [3, 5])
def test_mse_bf16_first_layer(rs, cf):
    """The base each gathered row forms in the kernel is ``make_mse_base``
    bit for bit (centred on ``xyz.mean(dim=1)``, as the wrapper's one other
    launch computes it); through the chain, with indices outside [0, N),
    the model lies within 1e-2 of the output's largest magnitude from the
    plain bf16 version."""
    feats, idx, xyz, packed = mse_bf16_case(rs, cf)
    idx = [i.copy() for i in idx]
    for i in idx:
        i[0, :3, -1] = [-1, xyz.shape[1], 1000]
    tp = torch_packed(packed)
    ctr = t(xyz).mean(dim=1).numpy()
    got, bases = mse_bf16_model(feats, idx, xyz, ctr, packed)
    want = fused.make_mse_base(t(feats).to(BF16), fused.center_xyz(t(xyz)),
                               tp[0], tp[1], BF16).float().numpy()
    np.testing.assert_array_equal(np.concatenate(bases, -1), want)
    tfeats = t(np.ascontiguousarray(feats.transpose(0, 2, 1))).transpose(1, 2)
    plain = fused.fused_multi_scale_encoder_plain(
        tfeats.to(BF16), [t(i) for i in idx], t(xyz), tp).numpy()
    bf16_close(got, plain)


def test_mse_bf16_first_layer_against_pallas(rs):
    """The model against the JAX kernel in bf16, in interpret mode (its
    weights block-diagonal, as the JAX packer lays them out)."""
    from jax.scipy.linalg import block_diag
    feats, idx, xyz, packed = mse_bf16_case(rs, 3)
    ctr = t(xyz).mean(dim=1).numpy()
    got, _ = mse_bf16_model(feats, idx, xyz, ctr, packed)
    w0r, w0f, s0, b0, w1, s1, b1, w2, s2, b2 = packed
    jpacked = (tuple(map(j, w0r)), tuple(map(j, w0f)), j(s0), j(b0),
               block_diag(*map(j, w1)).astype(jnp.bfloat16), j(s1), j(b1),
               block_diag(*map(j, w2)).astype(jnp.bfloat16), j(s2), j(b2))
    ks = tuple(i.shape[-1] for i in idx)
    want = jfused.fused_multi_scale_encoder(
        j(feats).astype(jnp.bfloat16), [j(i) for i in idx], j(xyz), jpacked,
        ks, True, fused.MSE_WIDTHS[2])
    bf16_close(got, want)


# ---------------------------------------------------------------------------
# (g) K2 past k = 64: a radix select of the window bounds, then a sort
# ---------------------------------------------------------------------------

def neighbors_constant(name):
    text = (build.CSRC / "neighbors.cu").read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


def below(key, bound):
    """The keys below a (prefix, shift) bound; None: none, "all": all."""
    if bound is None:
        return np.zeros(key.shape, bool)
    if bound == "all":
        return np.ones(key.shape, bool)
    prefix, shift = bound
    return (key >> np.uint64(shift)) < np.uint64(prefix)


def knn_select_model(k, dist, window):
    """knn_select_kernel on ``dist`` [Q, N]: (indices [Q, k], the radix
    passes of every select)."""
    q, n = dist.shape
    keys = ((dist.astype(F32).view(np.uint32).astype(np.uint64)
             << np.uint64(32)) | np.arange(n, dtype=np.uint64))
    jbits = 8
    while jbits < 32 and (n - 1) >> jbits:
        jbits += 8
    out = np.zeros((q, k), np.int32)
    passes = []
    for row in range(q):
        key = keys[row]
        lo = None
        for r0 in range(0, k, window):
            r1 = min(r0 + window, k)
            hi = "all"
            if r1 < n:
                prefix, shift, need, count = 0, 64, r1, 0
                while True:
                    nxt = jbits - 8 if shift == 32 else shift - 8
                    if shift == 32:
                        prefix <<= 32 - jbits
                    shift = nxt
                    if shift + 8 >= 64:
                        match = np.ones(n, bool)
                    else:
                        match = (key >> np.uint64(shift + 8)) == np.uint64(
                            prefix)
                    digits = ((key[match] >> np.uint64(shift))
                              & np.uint64(255)).astype(np.int64)
                    hist = np.bincount(digits, minlength=256)
                    cum = np.cumsum(hist)
                    d = int(np.searchsorted(cum, need, side="right"))
                    prefix = (prefix << 8) | d
                    need -= int(cum[d] - hist[d])
                    count += 1
                    if need == 0:
                        break
                hi = (prefix, shift)
                passes.append(count)
            chosen = np.sort(key[below(key, hi) & ~below(key, lo)])
            assert len(chosen) == r1 - r0  # exactly the window's ranks
            out[row, r0:r1] = (chosen & np.uint64(0xffffffff)).astype(
                np.int32)
            lo = hi
    return out, passes


@pytest.mark.parametrize("window", ["source", 32])
@pytest.mark.parametrize("k", [65, 100, 128])
@pytest.mark.parametrize("case", ["random", "ties", "invalid_tail"])
def test_knn_select_model(rs, case, k, window):
    if case == "random":
        q, p, v = (rs.rand(1, 24, 3) * 20).astype(F32), \
            (rs.rand(1, 300, 3) * 20).astype(F32), None
    else:
        q, p, v = knn_case(rs, case)
        q = q[:, :24].copy()
    window = neighbors_constant("kSelWindow") if window == "source" else window
    b, s, _ = q.shape
    tv = None if v is None else t(v)
    dist = neighbors.masked_square_distance(t(q), t(p), tv).numpy()
    got, passes = knn_select_model(k, dist.reshape(b * s, -1), window)
    got = got.reshape(b, s, k)
    np.testing.assert_array_equal(got, neighbors.knn_plain(
        k, t(q), t(p), tv).numpy())
    np.testing.assert_array_equal(got, jpo.knn(k, j(q), j(p), j(v)))
    if case == "random":  # distinct distances: the select ends in d's bytes
        assert max(passes) <= 4, passes
    else:  # k == N: no select at all
        n = p.shape[1]
        got, passes = knn_select_model(n, dist.reshape(b * s, -1), window)
        np.testing.assert_array_equal(got.reshape(b, s, n), jpo.knn(
            n, j(q), j(p), j(v)))
        assert len(passes) == b * s * (-(-n // window) - 1)


# ---------------------------------------------------------------------------
# (h) FPS: registers, a tree argmax, redux over lanes and warps
# ---------------------------------------------------------------------------

def fps_model(xyz, npoint, warps):
    """csrc/sampling.cu's fps_kernel on one cloud ``xyz`` [N, 3]."""
    n = xyz.shape[0]
    r = 1
    while r < 32 and 32 * warps * r < n:
        r *= 2
    threads = 32 * warps
    none = np.uint32(0xffffffff)
    dist = np.full(n, 1e10, F32)
    out = np.zeros(npoint, np.int32)
    cur = 0
    # the thread and slot of each point: j = t + r * T in registers, the
    # rest past R * T in ascending j per thread
    for i in range(npoint):
        out[i] = cur
        dx, dy, dz = (xyz - xyz[cur]).T
        dist = np.minimum(dist, (dx * dx + dy * dy) + dz * dz)
        regs = min(n, r * threads)
        vals = np.full((r, threads), -1.0, F32)
        vals.reshape(-1)[:regs] = dist[:regs]
        vals, slot = vals.T.copy(), np.tile(np.arange(r), (threads, 1))
        step = 1
        while step < r:  # the tree: the lower r keeps a tie
            for a in range(0, r - step, 2 * step):
                take = vals[:, a + step] > vals[:, a]
                vals[:, a] = np.where(take, vals[:, a + step], vals[:, a])
                slot[:, a] = np.where(take, slot[:, a + step], slot[:, a])
            step *= 2
        best = vals[:, 0].copy()
        best_j = (np.arange(threads) + slot[:, 0] * threads).astype(np.int64)
        for j0 in range(r * threads, n, threads):  # past the registers
            jj = np.arange(j0, min(j0 + threads, n))
            d = dist[jj]
            take = d > best[:len(jj)]
            best[:len(jj)] = np.where(take, d, best[:len(jj)])
            best_j[:len(jj)] = np.where(take, jj, best_j[:len(jj)])
        key = np.where(best < 0, 0, best).astype(F32).view(np.uint32)
        bj = np.where(best < 0, none, best_j).astype(np.uint32)
        key, bj = key.reshape(warps, 32), bj.reshape(warps, 32)
        wkey = key.max(axis=1)
        wj = np.where(key == wkey[:, None], bj, none).min(axis=1)
        cur = int(np.where(wkey == wkey.max(), wj, none).min())
    return out


@pytest.mark.parametrize("warps", [1, 2, 4, 8])
@pytest.mark.parametrize("n,npoint", [(1, 3), (31, 33), (256, 64),
                                      (1024, 40), (2049, 20), (5000, 12)])
def test_fps_model(n, npoint, warps):
    rs = np.random.RandomState(n)
    xyz = rs.randn(n, 3).astype(F32)
    xyz /= np.linalg.norm(xyz, axis=-1, keepdims=True)
    if n > 8:
        xyz[n // 2:n // 2 + 5] = xyz[2:7]  # exact ties
    got = fps_model(xyz, npoint, warps)
    want = jpo.farthest_point_sample(j(xyz[None]), npoint)
    np.testing.assert_array_equal(got, np.asarray(want)[0])
    np.testing.assert_array_equal(
        got, sampling.farthest_point_sample_plain(t(xyz[None]), npoint)[0])


# ---------------------------------------------------------------------------
# clouds above the kernels' tile of 2048 points
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("masked", [False, True])
def test_neighbors_above_2048_points(rs, masked):
    n = 2500
    p = (rs.rand(1, n, 3) * 40).astype(F32)
    q = p[:, ::20].copy()  # 125 queries
    v = (rs.rand(1, n) > 0.2) if masked else None
    tv = None if v is None else t(v)
    got = neighbors.knn(8, t(q), t(p), tv)
    np.testing.assert_array_equal(got.numpy(), jpo.knn(8, j(q), j(p), j(v)))
    for r, k in ((2.0, 16), (4.0, 32)):
        (got,) = neighbors.ball_query_multi((r,), (k,), t(p), t(q), tv)
        np.testing.assert_array_equal(
            got.numpy(), jpo.ball_query(r, k, j(p), j(q), j(v)))
