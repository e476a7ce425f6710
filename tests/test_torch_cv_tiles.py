"""The cost volume's two arms at any width and K (``csrc/cost_volume.cu``)
on the CPU: the host plans and the K4a full-tile walks (float32 and bf16)
as numpy models, the constants the kernels declare, and the plain versions
at the new shapes against the JAX kernels in interpret mode.

* ``ops/fused.py::cv_p2p_plan``, float32 K4a's full-tile arm
  (``cv_p2p_full_kernel``, at a K past 64 or whose tile of whole queries
  is less than 7/8 full, ``cv_p2p_full``): every query in exactly one
  block, the blocks' queries contiguous runs of whole queries, their rows
  in full tiles (no tile runs for nothing), the grid within the card's
  SMs, and the tiles at least 97% full at B=16, N=256, k=48 and 100.  The k that divide 64 never take that arm, nor the k whose whole
  queries nearly fill a tile (5, 7, 12, 63).
* The full-tile walk: 64-row tiles across query boundaries, each query's
  pieces summed in k order, its sum carried from one tile to the next.
  Fed per-row terms, it gives, bit for bit, the sum over k ascending in
  one pass (the order of a tile of whole queries, the parent arm's), and
  lies within the float32 bars of the plain version's ``torch.sum``
  (which sums in an order of its own).
* bf16 K4a in full tiles (``cv_p2p_bf16_kernel`` on ``cv_p2p_plan`` in
  clusters of two, at every k; float32 keeps its 7/8 rule): every query in
  exactly one block, the runs contiguous, each block's rows in full tiles
  but its last, the grid whole clusters within the card's blocks, every
  block (both of a cluster) running the plan's tiles. Its walk, the same
  sums carried in registers, gives the one-pass float32 sum over k ascending
  bit for bit (the kernel rounds that sum to bf16 once, as tiles of whole
  queries did).
* The constants ``ops/fused.py`` plans with are the ones the CUDA source
  declares (read by regex).
* The plain versions of K4a at k = 48 and 100 and of K4b at C = 100 and
  826 (``fused_cost_volume``, both halves, B=1, N=128) against JAX's
  ``fused_cost_volume`` in interpret mode (``_cv_kernel`` then
  ``_cv_agg_kernel``), on one flax ``FeatureCorrelator``'s weights carried
  across by ``load_flax_variables``: within 1e-4, or 1e-5 of the output's
  largest magnitude where that is more (at k = 100 the sums reach ~1,600,
  where one float32 ulp is 1.2e-4; the JAX kernels gather through hi/lo
  bf16 pairs, ``tests/test_torch_fused_ops.py`` holds the other K and C);
  in bf16 at k = 48 (both halves' bf16 arms, the plain versions) against
  JAX's bf16 kernels at the bf16 bar, 1e-2 of the largest magnitude.
"""

import re

import jax
import numpy as np
import pytest
import torch
from flax.core import unfreeze

from cmflow_tpu.nn import blocks as jblocks
from cmflow_tpu.ops import fused as jfused
from cmflow_tpu.ops import pointops as jpo
from cmflow_tpu_torch.models.convert import load_flax_variables
from cmflow_tpu_torch.native import build
from cmflow_tpu_torch.nn import blocks
from cmflow_tpu_torch.ops import fused

F32 = np.float32
SMS = 132
FULL_K = (5, 33, 48, 65, 100, 130)
F32_ATOL, F32_RTOL = 1e-4, 1e-5  # abs, and of the largest magnitude
BF16_RTOL = 1e-2  # of the largest magnitude
BF16_FULL_K = (5, 7, 8, 12, 16, 24, 33, 48, 64, 65, 100, 128, 130)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def cv_constant(pattern):
    text = (build.CSRC / "cost_volume.cu").read_text()
    return int(re.search(pattern, text).group(1))


# ---------------------------------------------------------------------------
# the constants
# ---------------------------------------------------------------------------

def test_cv_constants_match_kernel():
    def const(name):
        return cv_constant(rf"constexpr int {name} = (\d+);")

    assert fused.CV_P2P_ROWS == const("kP2pRows")
    assert fused.CV_AGG_THREADS == const("kAggThreads")
    assert fused.CV_AGG_PER == const("kAggPer")
    assert fused.CV_AGG_KC == const("kAggKc")
    assert fused.CV_AGG_MAX_PAIRS == const("kAggMaxPairs")
    assert fused.CV_AGG_BLOCKS == cv_constant(
        r"__launch_bounds__\(kAggThreads, (\d+)\)\s+cv_agg_any_kernel")
    # the tuned K4b's block: 16 queries, 8 a thread, whole 512-wide rows
    assert (fused.CV_AGG_THREADS // (fused.CV_WIDTH // 4) * fused.CV_AGG_PER
            == const("kAggQ"))
    # the bf16 arm's clusters, on either plan
    assert fused.CV_P2P_BF16_CLUSTER == const("kBf16Cluster")


# ---------------------------------------------------------------------------
# K4a: the plan and the full-tile walk
# ---------------------------------------------------------------------------

def block_queries(plan, total):
    """Each block's run of queries, [first, end)."""
    return [(blk * plan["qpb"], min((blk + 1) * plan["qpb"], total))
            for blk in range(plan["blocks"])]


def block_tiles(first, end, k):
    """The tiles a block runs, as the kernel counts them: its rows'."""
    return -(-(end - first) * k // fused.CV_P2P_ROWS)


@pytest.mark.parametrize("k", FULL_K)
@pytest.mark.parametrize("total", [1, 37, 4096, 4097])
def test_cv_p2p_plan(total, k):
    plan = fused.cv_p2p_plan(total, k, SMS)
    rows_tile = fused.CV_P2P_ROWS
    runs = block_queries(plan, total)
    # every query in exactly one block, in contiguous runs of whole queries
    seen = np.zeros(total, np.int64)
    for first, end in runs:
        if first < end:
            seen[first:end] += 1
    assert (seen == 1).all()
    assert all(first < end for first, end in runs)
    assert runs == sorted(runs)
    # each block's rows fill its tiles but the last, which holds some of
    # them (no tile runs for nothing); the fullest block runs ``tiles``
    tiles = [block_tiles(first, end, k) for first, end in runs]
    for (first, end), t in zip(runs, tiles):
        assert (t - 1) * rows_tile < (end - first) * k <= t * rows_tile
    assert max(tiles) == plan["tiles"]
    # the grid: one block an SM, all at once
    assert plan["blocks"] <= SMS
    assert plan["fill"] == pytest.approx(
        total * k / (sum(tiles) * rows_tile))


@pytest.mark.parametrize("k", [48, 100])
def test_cv_p2p_plan_fills_tiles(k):
    """At B=16, N=256 the rows run are at least 97% (query, neighbour)
    rows; a tile of whole queries filled 75% (k=48) and 78% (k=100)."""
    plan = fused.cv_p2p_plan(16 * 256, k, SMS)
    assert plan["fill"] >= 0.97
    whole = k / (-(-k // fused.CV_P2P_ROWS) * fused.CV_P2P_ROWS)
    assert whole < 0.8


def test_cv_p2p_divisors_keep_their_arm():
    for k in (1, 2, 4, 8, 16, 32, 64, 3, 5, 7, 12, 20, 63):
        assert not fused.cv_p2p_full(k)
    for k in (24, 33, 40, 48, 65, 100, 128, 130):
        assert fused.cv_p2p_full(k)


def p2p_walk(terms, sms):
    """The full-tile arm's walk over per-row terms [total, k, C]: each
    block's tiles in order, in each tile the queries with rows there, each
    query's rows in k order (its first row starts the sum, the others add
    to it), a query's sum carried into the next tile where its rows run on.
    Returns (out, how often each query was written, tiles each block
    ran, the tiles its rows fill)."""
    total, k, c = terms.shape
    plan = fused.cv_p2p_plan(total, k, sms)
    rows_tile = fused.CV_P2P_ROWS
    out = np.full((total, c), np.nan, F32)
    writes = np.zeros(total, np.int64)
    ran = np.zeros(plan["blocks"], np.int64)
    fill = np.zeros(plan["blocks"], np.int64)
    for blk, (q0, end) in enumerate(block_queries(plan, total)):
        rows = (end - q0) * k
        fill[blk] = block_tiles(q0, end, k)
        carry = None
        for tile in range(-(-rows // rows_tile)):
            ran[blk] += 1
            qfirst = tile * rows_tile // k
            qcount = min(((tile + 1) * rows_tile - 1) // k + 1,
                         rows // k) - qfirst
            for qi in range(qfirst, qfirst + qcount):
                lo = max(qi * k, tile * rows_tile)
                hi = min(qi * k + k, (tile + 1) * rows_tile)
                s = None if lo == qi * k else carry
                for rg in range(lo, hi):
                    v = terms[q0 + qi, rg - qi * k]
                    s = v.copy() if rg == qi * k else (s + v).astype(F32)
                if hi == qi * k + k:
                    out[q0 + qi] = s
                    writes[q0 + qi] += 1
                else:
                    carry = s
    return out, writes, ran, fill


@pytest.mark.parametrize("k", FULL_K)
def test_cv_p2p_walk_keeps_the_order(k):
    """Two clouds of 37 queries (74) on a card of 4 blocks: every block
    takes 19 queries (one 18), so tiles hold pieces of several queries and
    queries run over tiles.  The walk's sums are the one-pass sums over k
    ascending bit for bit, every query is written once, and every block
    runs the tiles its rows fill."""
    rs = np.random.RandomState(k)
    total, c = 74, 16
    terms = (rs.randn(total, k, c) * 3).astype(F32)
    got, writes, ran, fill = p2p_walk(terms, sms=4)
    assert (writes == 1).all() and (ran == fill).all()
    want = terms[:, 0].copy()
    for kk in range(1, k):
        want = (want + terms[:, kk]).astype(F32)
    np.testing.assert_array_equal(got, want)
    plain = torch.sum(torch.from_numpy(terms), dim=1).numpy()
    err, scale = np.abs(got - plain).max(), np.abs(plain).max()
    assert err <= F32_ATOL and err <= F32_RTOL * scale, (err, scale)


# ---------------------------------------------------------------------------
# bf16 K4a: the plan in clusters and the full-tile walk
# ---------------------------------------------------------------------------

def bf16_blocks(plan, total):
    """Each block of the bf16 grid (padded to whole clusters) with its run
    of queries, [first, end), empty past the last query."""
    return [(min(blk * plan["qpb"], total),
             min((blk + 1) * plan["qpb"], total))
            for blk in range(plan["grid"])]


@pytest.mark.parametrize("k", BF16_FULL_K)
@pytest.mark.parametrize("total, slots", [(1, 132), (37, 132), (4096, 132),
                                          (4097, 132), (4096, 130),
                                          (74, 4)])
def test_cv_p2p_bf16_plan(total, slots, k):
    cluster = fused.CV_P2P_BF16_CLUSTER
    plan = fused.cv_p2p_plan(total, k, slots, cluster)
    rows_tile = fused.CV_P2P_ROWS
    runs = bf16_blocks(plan, total)
    seen = np.zeros(total, np.int64)
    for first, end in runs:
        seen[first:end] += 1
    assert (seen == 1).all()
    # the blocks that hold queries come first, each a contiguous run
    held = [r for r in runs if r[0] < r[1]]
    assert held == runs[:plan["blocks"]] and held == sorted(held)
    # each block's rows fill its tiles but its last; every block runs the
    # plan's tiles, the most any block's rows fill, so both blocks of a
    # cluster take part in the same weight stages
    need = [-(-(end - first) * k // rows_tile) for first, end in runs]
    for (first, end), t in zip(held, need):
        assert (t - 1) * rows_tile < (end - first) * k <= t * rows_tile
    assert max(need) == plan["tiles"]
    # the grid: whole clusters, all at once on the card
    assert plan["grid"] % cluster == 0
    assert plan["blocks"] <= plan["grid"] <= slots - slots % cluster
    assert plan["grid"] - plan["blocks"] < cluster


@pytest.mark.parametrize("k", [2, 4, 8, 16, 32, 64, 128])
def test_cv_p2p_bf16_plan_at_the_divisors(k):
    """bf16 K4a runs full tiles at every k, the divisors of 64 too (timed
    faster there as well): at B=16, N=256 their full tiles are as full as
    tiles of whole queries, 32 queries a block in 64 clusters of two;
    float32 keeps tiles of whole queries there."""
    plan = fused.cv_p2p_plan(16 * 256, k, SMS, fused.CV_P2P_BF16_CLUSTER)
    assert plan["fill"] == 1.0
    assert (plan["qpb"], plan["blocks"], plan["grid"]) == (32, 128, 128)
    assert not fused.cv_p2p_full(k) or k > fused.CV_P2P_ROWS


def p2p_bf16_walk(terms, slots):
    """The bf16 full-tile arm's walk over per-row terms [total, k, C]: every
    block of the grid runs the plan's tiles; in each, the queries with rows
    there in order, each query's rows in k order (its first row starts the
    sum), the sum of the query that runs on carried in the block's
    registers.  Returns (out, writes per query, tiles each block ran)."""
    total, k, c = terms.shape
    plan = fused.cv_p2p_plan(total, k, slots, fused.CV_P2P_BF16_CLUSTER)
    rows_tile = fused.CV_P2P_ROWS
    out = np.full((total, c), np.nan, F32)
    writes = np.zeros(total, np.int64)
    ran = np.zeros(plan["grid"], np.int64)
    for blk in range(plan["grid"]):
        q0 = blk * plan["qpb"]
        rows = max(0, min(plan["qpb"], total - q0)) * k
        carry = np.zeros(c, F32)
        for tile in range(plan["tiles"]):
            ran[blk] += 1
            qfirst = tile * rows_tile // k
            qend = min(((tile + 1) * rows_tile - 1) // k + 1, rows // k)
            for qi in range(qfirst, qend):
                lo = max(qi * k, tile * rows_tile)
                hi = min(qi * k + k, (tile + 1) * rows_tile)
                s = carry.copy()
                for rg in range(lo, hi):
                    v = terms[q0 + qi, rg - qi * k]
                    s = v.copy() if rg == qi * k else (s + v).astype(F32)
                if hi == qi * k + k:
                    out[q0 + qi] = s
                    writes[q0 + qi] += 1
                else:
                    carry = s
    return out, writes, ran


@pytest.mark.parametrize("k", BF16_FULL_K)
def test_cv_p2p_bf16_walk_keeps_the_order(k):
    """Two clouds of 37 queries (74) on a card of 4 blocks (two clusters):
    every block runs the same tiles, every query is written once, and each
    sum is the one-pass float32 sum over k ascending bit for bit."""
    rs = np.random.RandomState(100 + k)
    total, c = 74, 16
    terms = (rs.randn(total, k, c) * 3).astype(F32)
    got, writes, ran = p2p_bf16_walk(terms, slots=4)
    assert (writes == 1).all() and (ran == ran[0]).all()
    want = terms[:, 0].copy()
    for kk in range(1, k):
        want = (want + terms[:, kk]).astype(F32)
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# the plain versions against the JAX kernels at the new shapes
# ---------------------------------------------------------------------------

def flax_vars(module, *args):
    v = unfreeze(module.init({"params": jax.random.PRNGKey(0)}, *args))
    _, mut = module.apply(v, *args, mutable=["batch_stats"])
    if "batch_stats" in mut:
        v["batch_stats"] = mut["batch_stats"]
    return jax.tree_util.tree_map(np.asarray, v)


@pytest.mark.parametrize("c, k", [(64, 48), (64, 100), (100, 8), (826, 8)])
def test_cost_volume_plain_matches_pallas(c, k):
    """Both halves at C x k: K4a past 64 and at a k that does not divide 64
    (48, 100), K4b at widths that are not multiples of a 16-byte cell of
    a 512 row (100) or of four channels at all (826); B=1, N=128, masked
    clouds, features 24 wide."""
    b, n, d = 1, 128, 24
    rs = np.random.RandomState(c + k)
    xyz1 = (rs.randn(b, n, 3) * 5.0).astype(F32)
    xyz2 = xyz1 + (rs.randn(b, n, 3) * 0.3).astype(F32)
    p1, p2 = (rs.randn(b, n, d).astype(F32) for _ in range(2))
    real = n - n // 4
    v1, v2 = ((rs.rand(b, n) > 0.1) & (np.arange(n)[None, :] < real)
              for _ in range(2))
    jnp_ = jax.numpy
    mod = jblocks.FeatureCorrelator(nsample=k, mlp=(c, c, c))
    v = flax_vars(mod, jnp_.asarray(xyz1), jnp_.asarray(xyz2),
                  jnp_.asarray(p1), jnp_.asarray(p2), True,
                  jnp_.asarray(v1), jnp_.asarray(v2))
    port = blocks.FeatureCorrelator(k, d, d, (c, c, c))
    load_flax_variables(port, v)
    idx2 = jpo.knn(k, jnp_.asarray(xyz1), jnp_.asarray(xyz2),
                   jnp_.asarray(v2))
    idx1 = jpo.knn(k, jnp_.asarray(xyz1), jnp_.asarray(xyz1),
                   jnp_.asarray(v1))
    w0 = v["params"]["w0"]
    dense, wn1, wn2 = jfused.cv_params_from_variables(v["params"])
    want = np.asarray(jfused.fused_cost_volume(
        jnp_.asarray(p1) @ w0[:d], jnp_.asarray(p2) @ w0[d:2 * d], idx2,
        jnp_.asarray(xyz1), idx1, jnp_.asarray(xyz2), True, dense=dense,
        wn1=wn1, wn2=wn2))
    pdense, pwn1, pwn2 = fused.cv_params_from_variables(port)
    pw0 = port.w0
    t = torch.from_numpy
    with torch.no_grad():
        got = fused.fused_cost_volume(
            t(p1) @ pw0[:d], t(p2) @ pw0[d:2 * d],
            t(np.array(idx2)), t(xyz1), t(np.array(idx1)), t(xyz2),
            dense=pdense, wn1=pwn1, wn2=pwn2).numpy()
    assert got.shape == want.shape == (b, n, c)
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert scale > 0.1, scale  # not degenerate
    assert err <= max(F32_ATOL, F32_RTOL * scale), (err, scale)


def test_cost_volume_bf16_plain_matches_pallas():
    """Both halves' bf16 arms at C=64, k=48 (K4a past its tile of whole
    queries): the plain versions on the CPU against JAX's bf16
    ``fused_cost_volume`` in interpret mode, bf16 ``f1t``/``f2t`` and dense
    kernels as the engines cast them, at the bf16 bar (1e-2 of the largest
    magnitude); B=1, N=128, masked clouds, features 24 wide."""
    b, n, d, c, k = 1, 128, 24, 64, 48
    rs = np.random.RandomState(148)
    xyz1 = (rs.randn(b, n, 3) * 5.0).astype(F32)
    xyz2 = xyz1 + (rs.randn(b, n, 3) * 0.3).astype(F32)
    p1, p2 = (rs.randn(b, n, d).astype(F32) for _ in range(2))
    real = n - n // 4
    v1, v2 = ((rs.rand(b, n) > 0.1) & (np.arange(n)[None, :] < real)
              for _ in range(2))
    jnp_ = jax.numpy
    mod = jblocks.FeatureCorrelator(nsample=k, mlp=(c, c, c))
    v = flax_vars(mod, jnp_.asarray(xyz1), jnp_.asarray(xyz2),
                  jnp_.asarray(p1), jnp_.asarray(p2), True,
                  jnp_.asarray(v1), jnp_.asarray(v2))
    port = blocks.FeatureCorrelator(k, d, d, (c, c, c))
    load_flax_variables(port, v)
    idx2 = jpo.knn(k, jnp_.asarray(xyz1), jnp_.asarray(xyz2),
                   jnp_.asarray(v2))
    idx1 = jpo.knn(k, jnp_.asarray(xyz1), jnp_.asarray(xyz1),
                   jnp_.asarray(v1))
    w0 = v["params"]["w0"]
    dense, wn1, wn2 = jfused.cv_params_from_variables(v["params"])
    jdense = tuple(x.astype(jnp_.bfloat16) if i % 2 == 0 else x
                   for i, x in enumerate(dense))
    want = np.asarray(jfused.fused_cost_volume(
        (jnp_.asarray(p1) @ w0[:d]).astype(jnp_.bfloat16),
        (jnp_.asarray(p2) @ w0[d:2 * d]).astype(jnp_.bfloat16), idx2,
        jnp_.asarray(xyz1), idx1, jnp_.asarray(xyz2), True, dense=jdense,
        wn1=wn1, wn2=wn2), F32)
    t = torch.from_numpy
    bf16 = torch.bfloat16
    with torch.no_grad():
        pdense, pwn1, pwn2 = fused.cv_params_from_variables(port)
        pdense = tuple(x.to(bf16) if i % 2 == 0 else x
                       for i, x in enumerate(pdense))
        got = fused.fused_cost_volume(
            (t(p1) @ port.w0[:d]).to(bf16), (t(p2) @ port.w0[d:2 * d]).to(
                bf16), t(np.array(idx2)), t(xyz1), t(np.array(idx1)),
            t(xyz2), dense=pdense, wn1=pwn1, wn2=pwn2).numpy()
    assert got.shape == want.shape == (b, n, c)
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert scale > 0.1, scale  # not degenerate
    assert err <= BF16_RTOL * scale, (err, scale)
