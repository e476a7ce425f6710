"""K3 past K = 32 (``csrc/mse.cu::mse_long_kernel``, ``mse_bf16_long_kernel``)
on the CPU: the plain version against the JAX kernel, and the long kernels'
host plan, order of work and weight layouts as numpy models.

* The port's ``fused_multi_scale_encoder_plain`` (what the CPU and the
  card's checks run) against JAX's ``fused_multi_scale_encoder`` in
  interpret mode at K = 33, 48 and 64, one scale, B=2, N=64, on the same
  weights (a flax ``init`` plus one train apply, carried across by
  ``load_flax_variables``) and inputs made from a numpy seed (random
  neighbours, some outside [0, N)).  Bars: float32 1e-4 abs and 1e-5 of
  the output's largest magnitude; bf16 1e-2 of it (a float32 sum in
  another order can flip a bf16 rounding by one ulp).
* ``ops/fused.py::mse_long_plan``, the launch a function of the shapes:
  every quad of every scale past K = 32 in exactly one block, the grid
  within the card's resident blocks, the bf16 span where it fits.
* The kernels' order of work (block, warpgroup, step, warp, row) as the
  device code computes it: every (query, neighbour) row of every scale past
  K = 32 reached, rows past K only repeating the first neighbour, a
  query's units in one warp's consecutive steps, every warp of a warpgroup
  taking the same steps.
* The weights as the kernels stage them into ``wgmma`` B tiles: the
  float32 arm from ``mse_tc_weights``' image, split into TF32 hi and lo
  (``tc_gemm.cuh``'s no-swizzle layout, the K order of the A operands the
  kernel forms), and the bf16 arm's from ``w1``/``w2`` as they lie.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import unfreeze

from cmflow_tpu.nn import blocks as jblocks
from cmflow_tpu.ops import fused as jfused
from cmflow_tpu_torch.models.convert import load_flax_variables
from cmflow_tpu_torch.native import build
from cmflow_tpu_torch.nn import blocks
from cmflow_tpu_torch.ops import fused

BF16 = torch.bfloat16
F32_ATOL, F32_RTOL = 1e-4, 1e-5  # abs, and of the largest magnitude
BF16_RTOL = 1e-2  # of the largest magnitude
WIDTHS = (32, 32, 64)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def mse_constant(name):
    """An integer constant of ``csrc/mse.cu``, as an expression of earlier
    ones (``kLongGroups``, ``kL1 = kL0 + 2 * kTile32``, ...)."""
    text = (build.CSRC / "mse.cu").read_text()
    consts = {}
    for decl in re.findall(r"constexpr (?:int|uint32_t) ([^;]+);", text):
        for part in decl.split(","):
            key, expr = (x.strip() for x in part.split("=", 1))
            try:
                consts.setdefault(key, eval(expr, {}, dict(consts)))  # noqa: S307
            except (NameError, SyntaxError):
                pass  # a template's constant (of M), or of sizeof
    return consts[name]


# ---------------------------------------------------------------------------
# the plain version against the JAX kernel
# ---------------------------------------------------------------------------

def flax_vars(module, *args):
    v = unfreeze(module.init({"params": jax.random.PRNGKey(0)}, *args))
    _, mut = module.apply(v, *args, mutable=["batch_stats"])
    if "batch_stats" in mut:
        v["batch_stats"] = mut["batch_stats"]
    return jax.tree_util.tree_map(np.asarray, v)


@pytest.mark.parametrize("dtype", [torch.float32, BF16])
@pytest.mark.parametrize("k", [33, 48, 64])
def test_mse_plain_past_k_matches_pallas(k, dtype):
    b, n = 2, 64
    rs = np.random.RandomState(k)
    xyz = (rs.randn(b, n, 3) * 5.0).astype(np.float32)
    feats = rs.randn(b, n, 3).astype(np.float32)
    valid = np.ones((b, n), bool)
    mod = jblocks.MultiScaleEncoder((4.0,), (k,), WIDTHS, (64, 64, 64))
    v = flax_vars(mod, jnp.asarray(xyz), jnp.asarray(feats), True,
                  jnp.asarray(valid))
    port = blocks.MultiScaleEncoder((4.0,), (k,), 3, WIDTHS, (64, 64, 64))
    load_flax_variables(port, v)
    idx = rs.randint(-2, n + 2, (b, n, k)).astype(np.int32)
    bf16 = dtype == BF16
    jdt = jnp.bfloat16 if bf16 else jnp.float32
    jpacked, _ = jfused.mse_narrow_params_from_variables(
        v["params"], v["batch_stats"], 1, jdt)
    want = np.asarray(jfused.fused_multi_scale_encoder(
        jnp.asarray(feats).astype(jdt), [jnp.asarray(idx)],
        jnp.asarray(xyz), jpacked, (k,), True, 64), np.float32)
    with torch.no_grad():
        packed, _ = fused.mse_narrow_params_from_variables(port, dtype)
        got = fused.fused_multi_scale_encoder_plain(
            torch.from_numpy(feats).to(dtype), [torch.from_numpy(idx)],
            torch.from_numpy(xyz), packed).numpy()
    assert got.shape == want.shape == (b, n, 64)
    scale = np.abs(want).max()
    assert scale > 0.1, scale  # not degenerate
    err = np.abs(got - want).max()
    if bf16:
        assert err <= BF16_RTOL * scale, (err, scale)
    else:
        assert err <= F32_ATOL and err <= F32_RTOL * scale, (err, scale)


# ---------------------------------------------------------------------------
# the host plan
# ---------------------------------------------------------------------------

PLAN_CASES = [((8, 16, 32, 64), 16, 256), ((48,), 16, 256),
              ((100,), 16, 256), ((33, 1, 200), 16, 256),
              ((48, 4, 64), 3, 200), ((4, 33, 8, 48, 16, 64, 32, 100), 16,
                                      256), ((64,), 2, 64),
              ((64,), 64, 4096), ((40,), 1, 3), ((4, 8, 16, 32), 16, 256)]


def test_mse_long_constants_match_kernel():
    """The plan's constants are the kernels'."""
    for bf16, groups, blocks_ in ((False, "kLongGroups", "kLongBlocks"),
                                  (True, "kLongBf16Groups",
                                   "kLongBf16Blocks")):
        assert fused.MSE_LONG_GROUPS[bf16] == mse_constant(groups)
        assert fused.MSE_LONG_BLOCKS[bf16] == mse_constant(blocks_)
    assert fused.MSE_TILE_MAX_K == mse_constant("kMaxK")
    assert fused.MSE_SPAN_POINTS == mse_constant("kBf16SpanPoints")
    assert fused.MSE_POINT_BYTES == {False: 4 * mse_constant("kPointFloats"),
                                     True: 4 * mse_constant("kPointWords")}
    # static shared memory: the weight tiles and the warps' rings
    ring = 4 * mse_constant("kRingWarpInts")
    assert (2 * mse_constant("kBf16LongTiles")
            + 4 * mse_constant("kBf16Floats")
            + 4 * mse_constant("kLongBf16Groups") * ring
            <= fused.MSE_LONG_STATIC_SMEM[True])
    assert (4 * (mse_constant("kLongFloats") + mse_constant("kAffine"))
            + 4 * mse_constant("kLongGroups") * ring
            <= fused.MSE_LONG_STATIC_SMEM[False] <= 48 * 1024)
    # the float32 tiles: hi and lo of every fragment slot of the image
    assert mse_constant("kLongFloats") == 4 * mse_constant("kSlots")


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("case", PLAN_CASES)
def test_mse_long_plan(case, bf16):
    ks, b, n = case
    total = b * n
    plan = fused.mse_long_plan(ks, total, n, bf16, sms=132)
    quads = -(-total // 4)
    cap = 132 * fused.MSE_LONG_BLOCKS[bf16]
    assert len(plan["qpb"]) == len(plan["blocks"]) == len(ks)
    for k, q, nb in zip(ks, plan["qpb"], plan["blocks"]):
        if k <= fused.MSE_TILE_MAX_K:
            assert q == nb == 0
            continue
        # every quad in exactly one block, none empty
        assert q >= 1 and nb == -(-quads // q) and (nb - 1) * q < quads
    assert plan["grid"] == sum(plan["blocks"])
    long_ks = [k for k in ks if k > fused.MSE_TILE_MAX_K]
    assert (plan["grid"] > 0) == bool(long_ks)
    # within the resident blocks, but for one block a scale at least
    assert plan["grid"] <= max(cap, len(long_ks))
    assert plan["steps"] == quads * sum(-(-k // 16) for k in long_ks)
    if not plan["span"]:
        assert plan["smem"] == plan["span_points"] == 0
        return
    # the span holds every element a block's queries lie in, and fits
    for q, nb in zip(plan["qpb"], plan["blocks"]):
        for blk in range(nb):
            first, last = 4 * q * blk, min(4 * q * (blk + 1), total) - 1
            assert (last // n - first // n + 1) * n <= plan["span_points"]
    assert plan["span_points"] <= fused.MSE_SPAN_POINTS
    assert plan["smem"] == plan["span_points"] * fused.MSE_POINT_BYTES[bf16]
    held = (fused.MSE_LONG_STATIC_SMEM[bf16] + plan["smem"]
            + fused.SMEM_RESERVED)
    assert fused.MSE_LONG_BLOCKS[bf16] * held <= fused.SMEM_SM


def test_mse_long_plan_spreads_work():
    """At the served shape (config A's K=64, B=16, N=256) the plan uses
    most of the card's resident blocks and a span, and a B*N of 2^18
    points in clouds of 4,096 leaves the span out (a block's clouds would
    not fit)."""
    for bf16 in (False, True):
        plan = fused.mse_long_plan((8, 16, 32, 64), 16 * 256, 256, bf16,
                                   sms=132)
        cap = 132 * fused.MSE_LONG_BLOCKS[bf16]
        assert 0.9 * cap <= plan["grid"] <= cap
    for bf16 in (False, True):
        assert fused.mse_long_plan((64,), 16 * 256, 256, bf16)["span"] == 1
        assert fused.mse_long_plan((64,), 64 * 4096, 4096, bf16)["span"] == 0


# ---------------------------------------------------------------------------
# the order of work
# ---------------------------------------------------------------------------

def long_rows(ks, total, bf16):
    """Every (scale, query, neighbour slot) the long kernel's rows take, by
    (scale, block, warpgroup, step, warp, row): ``long_quads``, the step's
    query ``4 * (quad0 + groups * (f / units)) + warp`` and ``long_row``'s
    slot ``16u + g (+ 8)``, past K the first."""
    plan = fused.mse_long_plan(ks, total, 64, bf16, sms=4)
    groups = fused.MSE_LONG_GROUPS[bf16]
    quads = -(-total // 4)
    seen = {}
    for s, (k, qpb, nb) in enumerate(zip(ks, plan["qpb"], plan["blocks"])):
        units = -(-k // 16)
        for blk in range(nb):
            end = min((blk + 1) * qpb, quads)
            for wg in range(groups):
                first = blk * qpb + wg
                count = -(-(end - first) // groups) if first < end else 0
                for f in range(count * units):
                    u = f % units
                    for warp in range(4):
                        q = 4 * (first + groups * (f // units)) + warp
                        if q >= total:
                            continue
                        for r in range(16):
                            kk = 16 * u + r
                            seen.setdefault((s, q), []).append(
                                (blk, wg, warp, f, kk if kk < k else 0))
    return seen


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("case", [((48, 4, 64), 3 * 70), ((33,), 37),
                                  ((100, 200), 64), ((64,), 4096)])
def test_mse_long_order_of_work(case, bf16):
    ks, total = case
    seen = long_rows(ks, total, bf16)
    for s, k in enumerate(ks):
        for q in range(total):
            rows = seen.get((s, q), [])
            if k <= fused.MSE_TILE_MAX_K:
                assert not rows
                continue
            # one warp of one warpgroup of one block, consecutive steps
            assert len({r[:3] for r in rows}) == 1
            steps = sorted({r[3] for r in rows})
            assert steps == list(range(steps[0], steps[0] + -(-k // 16)))
            slots = [r[4] for r in rows]
            assert sorted(set(slots)) == list(range(k))
            assert len(slots) == 16 * -(-k // 16)  # the rest repeat slot 0
            assert all(sl == 0 for sl in slots[k:])


# ---------------------------------------------------------------------------
# the weights as the long kernels stage them
# ---------------------------------------------------------------------------

def tile_offset(n, p, depth):
    """tc_gemm.cuh's no-swizzle B layout: element (column n, K position p)
    of a step ``depth`` deep (8 float32 or 16 bf16) in elements."""
    half = depth // 2
    return ((n // 8 * 2 + p // half) * 8 + n % 8) * half + p % half


def encoder_packed(dtype, cf=3, seed=0):
    port = blocks.MultiScaleEncoder((2.0, 4.0), (48, 64), cf, WIDTHS,
                                    (64, 64, 64))
    gen = torch.Generator().manual_seed(seed)
    blocks.init_parameters(port, gen)
    with torch.no_grad():
        for m in port.modules():  # scales of both signs
            if isinstance(m, blocks.BatchNorm):
                m.weight.uniform_(-1.3, 1.3, generator=gen)
        packed, _ = fused.mse_narrow_params_from_variables(port, dtype)
    return tuple(tuple(t.detach() for t in x) if isinstance(x, tuple)
                 else x.detach() for x in packed)


def f32_tiles(image):
    """``csrc/mse.cu::stage_long`` for one scale of the image: the float32
    wgmma tiles, each k8 step's TF32 hi tile then its lo tile, the last
    product's columns of negative scale negated."""
    slots1, slots2 = mse_constant("kSlots1"), mse_constant("kSlots2")
    slots = mse_constant("kSlots")
    bases = (mse_constant("kL0"), mse_constant("kL1"), mse_constant("kL2"))
    sizes = (mse_constant("kTile32"), mse_constant("kTile32"),
             mse_constant("kTile64"))
    out = np.full(mse_constant("kLongFloats"), np.nan, np.float32)
    pairs = image[:2 * slots].reshape(slots, 2).copy()
    s2 = image[2 * slots + mse_constant("kS2"):][:WIDTHS[2]]
    for e in range(slots2, slots):
        if s2[8 * ((e - slots2) // 32 % 8) + (e - slots2) % 32 // 4] < 0:
            pairs[e] = -pairs[e]
    hi, lo = (x.numpy() for x in fused.tf32_split(torch.from_numpy(pairs)))
    for e in range(slots):
        prod = 0 if e < slots1 else 1 if e < slots2 else 2
        f = e - (0, slots1, slots2)[prod]
        tiles = WIDTHS[prod] // 8 if prod < 2 else WIDTHS[2] // 8
        lane, nt, j = f % 32, f // 32 % tiles, f // 32 // tiles
        at = bases[prod] + 2 * sizes[prod] * j
        for v, p in ((0, lane % 4), (1, lane % 4 + 4)):
            o = tile_offset(8 * nt + lane // 4, p, 8)
            out[at + o] = hi[e, v]
            out[at + sizes[prod] + o] = lo[e, v]
    return out


def test_mse_long_f32_tiles():
    """Each product's B read back from the staged tiles (hi + lo) is its
    weights in the K order of the A the kernel forms: the first product's
    position p is input channel p ([w0r; w0f; 0]); a later product's
    position t of k8 step j is channel 8j + 2t, position t + 4 channel
    8j + 2t + 1 (the previous accumulator's columns, as chain_a takes
    them); the last product's columns of negative scale negated (the
    kernels' max over rows, fold_max)."""
    packed = encoder_packed(torch.float32)
    w0rel, w0feat, _, _, w1, _, _, w2, s2, _ = packed
    assert (s2 < 0).any() and (s2 > 0).any()  # both kinds of column
    image = fused.mse_tc_weights(packed)
    for s in range(2):
        tiles = f32_tiles(image[s].numpy())
        assert not np.isnan(tiles).any()  # every element written once
        w0 = np.zeros((8, 32), np.float32)
        w0[:3], w0[3:6] = w0rel[s].numpy(), w0feat[s].numpy()
        sign = np.where(s2[64 * s:64 * (s + 1)].numpy() < 0, -1.0, 1.0)
        for prod, (w, base, size, steps) in enumerate((
                (w0, "kL0", "kTile32", 1), (w1[s].numpy(), "kL1", "kTile32",
                                            4),
                (w2[s].numpy() * sign, "kL2", "kTile64", 4))):
            cols = w.shape[1]
            for j in range(steps):
                at = mse_constant(base) + 2 * mse_constant(size) * j
                for p in range(8):
                    ch = p if prod == 0 else 8 * j + 2 * (p % 4) + p // 4
                    o = np.array([tile_offset(c, p, 8) for c in range(cols)])
                    got = (tiles[at + o].astype(np.float64)
                           + tiles[at + mse_constant(size) + o])
                    np.testing.assert_allclose(got, w[ch], rtol=2 ** -21,
                                               atol=1e-30)


def test_mse_long_bf16_tiles():
    """``csrc/mse.cu::stage_bf16_long``: element (n, p) of step j of each
    product's tile is ``w[16j + p][n]`` (natural K order), w1's two steps
    then w2's, w2's columns of negative scale negated; every element
    written once."""
    packed = encoder_packed(BF16)
    w1, w2, s2 = packed[4], packed[7], packed[8]
    assert (s2 < 0).any() and (s2 > 0).any()  # both kinds of column
    t1, t2 = mse_constant("kBf16Tile1"), mse_constant("kBf16Tile2")
    for s in range(2):
        sign = np.where(s2[64 * s:64 * (s + 1)].numpy() < 0, -1.0, 1.0)
        tiles = np.full(mse_constant("kBf16LongTiles"), np.nan, np.float32)
        for second, w in ((False, w1[s].float().numpy()),
                          (True, w2[s].float().numpy() * sign)):
            cout = w.shape[1]
            for k in range(w.shape[0]):
                for n in range(cout):
                    j, p = k // 16, k % 16
                    at = 2 * t1 + j * t2 if second else j * t1
                    o = at + tile_offset(n, p, 16)
                    assert np.isnan(tiles[o])
                    tiles[o] = w[k, n]
        assert not np.isnan(tiles).any()
        for second, w, at0, size in ((False, w1[s].float().numpy(), 0, t1),
                                     (True, w2[s].float().numpy() * sign,
                                      2 * t1, t2)):
            for j in range(2):
                for p in range(16):
                    o = np.array([tile_offset(c, p, 16)
                                  for c in range(w.shape[1])])
                    np.testing.assert_array_equal(
                        tiles[at0 + j * size + o], w[16 * j + p])
