"""K5's bf16 arm in full tiles (``csrc/plf.cu::plf_bf16_kernel`` on
``plf_plan``) on the CPU: its host plan and its walk over tiles as numpy
models, the constants the kernel declares, and the plain bf16 version past
a tile of whole queries against the JAX kernel in interpret mode.

* ``ops/fused.py::plf_plan``, bf16 K5's launch at every K: every query
  in exactly one block, the blocks' queries contiguous runs of
  whole queries, each block's rows in full tiles but its last, the grid
  within the card's SMs (one block an SM) in whole clusters, every block
  running the plan's tiles; at the K that divide 128 the full tiles are
  as full as tiles of whole queries.
* The walk: 128-row tiles across query boundaries, each query's max over
  its rows in a tile taken on from the running max of the tiles before,
  the max of the query that runs on past a tile's end carried in one row
  of a double-buffered carry (a tile reads the last tile's row and writes
  its own), the query written at its last row.  Fed per-row values, it
  gives the max of one pass over each query's rows at K = 33, 48, 65,
  100, 160 and 200, bit for bit (a float max is exact), each query
  written once.
* The constants ``ops/fused.py`` plans with are the ones the CUDA source
  declares (read by regex).
* The plain bf16 version at K = 65 (narrow widths, B=1, N=128, masked)
  against JAX's bf16 ``fused_point_local_feature`` in interpret mode, on
  one flax ``PointLocalFeature``'s weights carried across by
  ``load_flax_variables``, at the bf16 bar (1e-2 of the largest
  magnitude).
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import unfreeze

from cmflow_tpu.models import inference as jinf
from cmflow_tpu.nn import blocks as jblocks
from cmflow_tpu.ops import fused as jfused
from cmflow_tpu.ops import pointops as jpo
from cmflow_tpu_torch.models import inference
from cmflow_tpu_torch.models.convert import load_flax_variables
from cmflow_tpu_torch.native import build
from cmflow_tpu_torch.nn import blocks
from cmflow_tpu_torch.ops import fused

F32 = np.float32
SMS = 132
FULL_K = (4, 8, 16, 24, 32, 33, 48, 65, 100, 128, 160, 200)
BF16_RTOL = 1e-2  # of the largest magnitude


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def plf_constant(pattern):
    text = (build.CSRC / "plf.cu").read_text()
    return int(re.search(pattern, text).group(1))


def test_plf_constants_match_kernel():
    def const(name):
        return plf_constant(rf"constexpr int {name} = (\d+);")

    assert fused.PLF_ROWS == const("kRows")
    assert fused.PLF_BF16_CLUSTER == const("kBf16Cluster")
    assert fused.PLF_WIDTHS == (const("kC1"), const("kC2"), const("kC3"))


# ---------------------------------------------------------------------------
# the plan and the rule
# ---------------------------------------------------------------------------

def block_runs(plan, total):
    """Each block of the grid with its run of queries, [first, end), empty
    past the last query."""
    return [(min(blk * plan["qpb"], total),
             min((blk + 1) * plan["qpb"], total))
            for blk in range(plan["grid"])]


@pytest.mark.parametrize("k", FULL_K)
@pytest.mark.parametrize("total", [1, 37, 4096, 4097, 256 * 64])
def test_plf_plan(total, k):
    plan = fused.plf_plan(total, k, SMS)
    rows_tile = fused.PLF_ROWS
    runs = block_runs(plan, total)
    seen = np.zeros(total, np.int64)
    for first, end in runs:
        seen[first:end] += 1
    assert (seen == 1).all()
    held = [r for r in runs if r[0] < r[1]]
    assert held == runs[:plan["blocks"]] and held == sorted(held)
    # each block's rows fill its tiles but its last; every block runs the
    # plan's tiles, the most any block's rows fill
    need = [-(-(end - first) * k // rows_tile) for first, end in held]
    for (first, end), t in zip(held, need):
        assert (t - 1) * rows_tile < (end - first) * k <= t * rows_tile
    assert max(need) == plan["tiles"]
    # the grid: one block an SM, whole clusters, all at once
    assert plan["grid"] % fused.PLF_BF16_CLUSTER == 0
    assert plan["blocks"] <= plan["grid"] <= SMS
    assert plan["fill"] == pytest.approx(
        total * k / (sum(need) * rows_tile))


@pytest.mark.parametrize("k, whole", [(48, 0.75), (65, 65 / 128),
                                      (160, 0.625)])
def test_plf_plan_fills_tiles(k, whole):
    """At B=16, N=256 the rows run are at least 95% (query, neighbour)
    rows, where tiles of whole queries filled 75% (K=48), 51% (K=65) and
    62.5% (K=160, a query over two tiles)."""
    plan = fused.plf_plan(16 * 256, k, SMS)
    assert plan["fill"] >= 0.95 > whole + 0.15
    rows = fused.PLF_ROWS
    assert whole == (rows // k * k / rows if k <= rows
                     else k / (-(-k // rows) * rows))


@pytest.mark.parametrize("k", [4, 8, 16, 32, 64, 128, 256])
def test_plf_plan_at_the_divisors(k):
    """bf16 K5 runs full tiles at every K, those that fill tiles of whole
    queries too (timed faster there as well): at B=16, N=256 their full
    tiles are as full, 32 queries a block on 128 of the 132 SMs."""
    plan = fused.plf_plan(16 * 256, k, SMS)
    assert plan["fill"] == 1.0
    assert (plan["qpb"], plan["blocks"], plan["grid"]) == (32, 128, 128)


# ---------------------------------------------------------------------------
# the walk
# ---------------------------------------------------------------------------

def plf_walk(values, sms):
    """The full-tile arm's walk over per-row values [total, k, C]: every
    block runs the plan's tiles; in each, the queries with rows there, each
    query's max over its rows in the tile taken on from the carried max
    where its rows began in a tile before, the max of the query that runs
    on written into the tile's row of the double-buffered carry (tile t
    writes row t % 2 and reads row (t + 1) % 2).  Returns (out, writes per
    query, the carry rows each tile read and wrote)."""
    total, k, c = values.shape
    plan = fused.plf_plan(total, k, sms)
    rows_tile = fused.PLF_ROWS
    out = np.full((total, c), np.nan, F32)
    writes = np.zeros(total, np.int64)
    rows_touched = []
    for blk in range(plan["grid"]):
        q0 = blk * plan["qpb"]
        rows = max(0, min(plan["qpb"], total - q0)) * k
        carry = np.full((2, c), np.nan, F32)
        for tile in range(plan["tiles"]):
            qfirst = tile * rows_tile // k
            qcount = min(((tile + 1) * rows_tile - 1) // k + 1,
                         rows // k) - qfirst
            read, wrote = set(), set()
            for qi in range(qfirst, qfirst + max(0, qcount)):
                lo = max(qi * k, tile * rows_tile)
                hi = min(qi * k + k, (tile + 1) * rows_tile)
                if lo == qi * k:
                    m = np.full(c, -np.inf, F32)
                else:
                    m = carry[(tile + 1) % 2].copy()
                    read.add((tile + 1) % 2)
                    assert not np.isnan(m).any()  # written by the tile before
                for rg in range(lo, hi):
                    m = np.fmax(m, values[q0 + qi, rg - qi * k])
                if hi == qi * k + k:
                    out[q0 + qi] = m
                    writes[q0 + qi] += 1
                else:
                    carry[tile % 2] = m
                    wrote.add(tile % 2)
            rows_touched.append((read, wrote))
    return out, writes, rows_touched


@pytest.mark.parametrize("k", [33, 48, 65, 100, 160, 200])
def test_plf_walk_carries_the_max(k):
    """Two clouds of 37 queries (74) on a card of 4 blocks: tiles hold
    pieces of several queries and queries run over tiles (K=160, 200 over
    two or three).  Every query is written once with the max of one pass
    over its rows, and no tile reads the carry row it writes."""
    rs = np.random.RandomState(k)
    total, c = 74, 16
    values = np.maximum(rs.randn(total, k, c), 0).astype(F32)
    got, writes, touched = plf_walk(values, sms=4)
    assert (writes == 1).all()
    np.testing.assert_array_equal(got, values.max(axis=1))
    assert all(not (read & wrote) for read, wrote in touched)


# ---------------------------------------------------------------------------
# the plain bf16 version against the JAX kernel past a tile
# ---------------------------------------------------------------------------

def flax_vars(module, *args):
    v = unfreeze(module.init({"params": jax.random.PRNGKey(0)}, *args))
    _, mut = module.apply(v, *args, mutable=["batch_stats"])
    if "batch_stats" in mut:
        v["batch_stats"] = mut["batch_stats"]
    return jax.tree_util.tree_map(np.asarray, v)


def test_plf_bf16_plain_matches_pallas_past_a_tile():
    """A PointLocalFeature at narrow widths (C1=64, mlp 64,32,32), K=65
    (past half a tile: the full-tile arm's shape on the card), B=1, N=128,
    masked; the chain and the base in bf16 as the engines cast them
    (``_cast_chain``); the port's plain bf16 version against JAX's bf16
    Pallas kernel in interpret mode at the bf16 bar."""
    b, n, k, d = 1, 128, 65, 35
    rs = np.random.RandomState(65)
    xyz = (rs.randn(b, n, 3) * 5.0).astype(F32)
    feats = rs.randn(b, n, d).astype(F32)
    real = n - n // 4
    valid = (rs.rand(b, n) > 0.1) & (np.arange(n)[None, :] < real)
    mod = jblocks.PointLocalFeature(radius=8.0, nsample=k, mlp=(64, 32, 32),
                                    mlp2=(32, 32, 32))
    v = flax_vars(mod, jnp.asarray(xyz), jnp.asarray(feats), True,
                  jnp.asarray(valid))
    port = blocks.PointLocalFeature(8.0, k, d, (64, 32, 32), (32, 32, 32))
    load_flax_variables(port, v)
    idx = jpo.ball_query(8.0, k, jnp.asarray(xyz), jnp.asarray(xyz),
                         jnp.asarray(valid))
    chain, feat_w, _ = jfused.plf_params_from_variables(v["params"],
                                                         v["batch_stats"])
    want = np.asarray(jfused.fused_point_local_feature(
        (jnp.asarray(feats) @ feat_w).astype(jnp.bfloat16), idx,
        jnp.asarray(xyz), jinf._cast_chain(chain, jnp.bfloat16), True), F32)
    with torch.no_grad():
        pchain, pfeat_w, _ = fused.plf_params_from_variables(port)
        got = fused.fused_point_local_feature(
            (torch.from_numpy(feats) @ pfeat_w).to(torch.bfloat16),
            torch.from_numpy(np.array(idx)), torch.from_numpy(xyz),
            inference._cast_chain(pchain, torch.bfloat16)).numpy()
    assert got.shape == want.shape == (b, n, 32)
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert scale > 0.1, scale  # not degenerate
    assert err <= BF16_RTOL * scale, (err, scale)
