"""The generic kernel's tensor-core arm (``csrc/chain.cu::chain_tc_kernel``,
K3's and K5's chains at any widths, K4a's at any C) on the CPU: its packer,
its plan and its design, and a chain deeper than it once took.

* The packed weight image (``ops/fused.py::chain_tc_weights``), read back by
  a plain reader written here from the layout the kernel's wgmma
  descriptors assume (``csrc/tc_gemm.cuh``: per stage, k8 or k16 steps of
  no-swizzle B tiles, the K order a row's four consecutive channels give),
  equals the Dense kernels (bf16 exactly; the TF32 hi and lo halves sum to
  them within 2^-22), with zeros in every padded row and column.
* The plan (``chain_tc_plan``) fits a block's shared memory at every shape
  the port's tests and ``chip_smoke.py`` serve, gives two blocks an SM at
  config B in bf16, and sends a middle activation to device scratch only
  where keeping it in shared memory would leave fewer blocks an SM.
* A numpy model of the kernel reads the plan, the layer table, the
  parameter array and the weight stages as the kernel reads them (rows a
  query ``span`` apart, masked past K, a query over tiles past 64, each
  stage's B tiles at the descriptors' offsets, A in ``from_rows`` order,
  products in float64, bf16 rounding where the bf16 arm rounds) and is
  held to the plain versions at the kernels' bars.
* A K5 chain of 34 Dense layers, which the generic kernel once refused,
  through the port's ``fused_point_local_feature`` on the CPU against the
  JAX package's in interpret mode.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmflow_tpu.ops import fused as jfused
from cmflow_tpu_torch.ops import fused

FUSED_ATOL = 1e-4
FUSED_RTOL = 1e-5  # of the output's largest magnitude
BF16_RTOL = 1e-2
BF16 = torch.bfloat16
# chains the packer and the plan are held at: (C0, Dense output widths) of
# config B's K5, K4a and K3, the lifted chains, odd widths and C = 826
CHAINS = [(768, (384, 96)), (768, (768, 768)), (64, (64, 128)),
          (200, (100, 36)), (96, (64, 48, 32)), (24, (40, 56)),
          (826, (826, 826)), (100, (100, 100)), (37, (45, 19, 3))]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def weights(rs, c0, widths, dtype=torch.float32):
    ws, cin = [], c0
    for w in widths:
        ws.append(torch.from_numpy((rs.randn(cin, w) / np.sqrt(cin)).astype(
            np.float32)).to(dtype))
        cin = w
    return ws


def read_image(img: torch.Tensor, c0: int, widths, bf16: bool):
    """Each layer's padded weights ``[cin_p, cols]`` (float64) read back from
    the packed stages by the kernel's layout, and for float32 the hi and lo
    halves apart: the layout of ``csrc/chain.cu`` and ``tc_gemm.cuh``,
    written out here rather than taken from the packer."""
    chans, cols = fused.chain_tc_arm(bf16)
    cins, couts = fused.chain_tc_widths(c0, widths, bf16)
    flat = img.float().numpy().astype(np.float64)
    per_stage = fused.CHAIN_TC_STAGE // (2 if bf16 else 4)
    steps = 2
    at, out = 0, []
    n = np.arange(cols)[:, None]
    for ci, co in zip(cins, couts):
        blocks = -(-co // cols)
        parts = [np.zeros((ci, blocks * cols)) for _ in range(1 if bf16
                                                              else 2)]
        for cb in range(blocks):
            for s in range(ci // chans):
                stage = flat[at:at + per_stage]
                at += per_stage
                for e in range(steps):
                    if bf16:  # k16 steps of 256 columns, 8 KB each
                        p = np.arange(16)[None, :]
                        off = 4096 * e + ((n // 8 * 2 + p // 8) * 8
                                          + n % 8) * 8 + p % 8
                        ch = 32 * s + 16 * e + 4 * (p % 8 // 2) + 2 * (
                            p // 8) + p % 2
                        parts[0][ch, cb * cols + n] = stage[off]
                    else:  # k8 steps of 128 columns, hi then lo, 4 KB each
                        p = np.arange(8)[None, :]
                        off = 1024 * e + ((n // 8 * 2 + p // 4) * 8
                                          + n % 8) * 4 + p % 4
                        ch = 16 * s + 4 * (p % 4) + 2 * e + p // 4
                        parts[0][ch, cb * cols + n] = stage[off]
                        parts[1][ch, cb * cols + n] = stage[2048 + off]
        out.append(parts)
    assert at == flat.size
    return out


@pytest.mark.parametrize("chain", CHAINS)
@pytest.mark.parametrize("bf16", [False, True])
def test_packed_image_reads_back(chain, bf16):
    c0, widths = chain
    rs = np.random.RandomState(sum(widths) + c0)
    ws = weights(rs, c0, widths, BF16 if bf16 else torch.float32)
    img = fused.chain_tc_weights(ws, c0)
    assert img.dtype == (BF16 if bf16 else torch.float32)
    plan = fused.chain_tc_plan(bf16, c0, widths, 16, 4096)
    assert img.numel() * img.element_size() == (
        fused.CHAIN_TC_STAGE * plan["period"])
    for w, parts in zip(ws, read_image(img, c0, widths, bf16)):
        cin, cout = w.shape
        want = w.double().numpy()
        got = parts[0] if bf16 else parts[0] + parts[1]
        if bf16:
            np.testing.assert_array_equal(got[:cin, :cout], want)
        else:
            np.testing.assert_allclose(got[:cin, :cout], want, rtol=0,
                                       atol=2.0 ** -21 * np.abs(want).max())
            # hi is TF32 (13 low mantissa bits clear); lo is the rest
            hi = parts[0].astype(np.float32).view(np.int32)
            assert not (hi & 0x1FFF).any()
            assert np.abs(parts[1]).max() <= 2.0 ** -10 * np.abs(want).max()
        for part in parts:  # zeros in every padded row and column
            assert not part[cin:].any() and not part[:, cout:].any()


def served_chains():
    """(bf16, C0, widths, K, B*N): every chain the generic kernel serves in
    tests/test_torch_fused_shapes.py (config B at B=2, N=128),
    tests/test_torch_cuda.py and chip_smoke.py (config B at B=16, N=256, the
    lifted shapes, each tuned shape on the generic route, depth 40, K=100)."""
    out = []
    for bf16 in (False, True):
        for total in (256, 4096):
            for k in (16, 32, 64):  # config B: K3 and K5
                out.append((bf16, 64, (64, 128), k, total))
                out.append((bf16, 768, (384, 96), k, total))
            out.append((bf16, 768, (768, 768), 16, total))  # config B K4a
        for k in (1, 3, 5, 8, 16, 33, 48, 64, 65, 100, 129, 300):
            out += [(bf16, 24, (40, 56), k, 4096),
                    (bf16, 200, (100, 36), k, 4096),
                    (bf16, 96, (64, 48, 32), k, 4096),
                    (bf16, 512, (256, 64), k, 4096),
                    (bf16, 32, (32, 64), k, 4096)]
        for c in (100, 512, 768, 826):
            for k in (8, 16, 33, 100):
                out.append((bf16, c, (c, c), k, 4096))
        out.append((bf16, 32, (32,) * 40, 16, 4096))
        out.append((bf16, 19, (23,) * 40, 100, 4096))
    return out


def test_plan_fits_every_served_shape():
    for bf16, c0, widths, k, total in served_chains():
        plan = fused.chain_tc_plan(bf16, c0, widths, k, total)
        held = plan["smem"] + fused.CHAIN_TC_STATIC_SMEM
        assert held <= fused.SMEM_BLOCK, (bf16, c0, widths, k)
        assert plan["blocks_per_sm"] >= 1
        # rows: whole queries of `span` rows a tile, or one over tiles
        if k <= 64:
            assert plan["span"] >= k and plan["tiles"] == 1
            assert plan["span"] * plan["qpt"] == fused.CHAIN_TC_ROWS
        else:
            assert plan["tiles"] * fused.CHAIN_TC_ROWS >= k
        assert plan["grid"] % fused.CHAIN_TC_CLUSTER == 0
        assert plan["grid"] * plan["iters"] >= plan["works"]
        # a buffer goes to scratch only where shared memory would leave
        # fewer blocks an SM (or not fit at all)
        if plan["x_global"] or plan["y_global"]:
            elt = 2 if bf16 else 4
            ring = fused.CHAIN_TC_STAGES * fused.CHAIN_TC_STAGE
            kept = fused.CHAIN_TC_ROWS * elt * (
                plan["xw"] * (1 - plan["x_global"])
                + plan["yw"] * (1 - plan["y_global"]))
            rest = plan["smem"] - ring - kept  # the reduction and the carry
            held_all = (ring + fused.CHAIN_TC_ROWS * elt * (
                plan["xw"] + plan["yw"]) + rest
                + fused.CHAIN_TC_STATIC_SMEM)
            blocks_all = (0 if held_all > fused.SMEM_BLOCK else min(
                fused.CHAIN_TC_BLOCKS,
                fused.SMEM_SM // (held_all + fused.SMEM_RESERVED)))
            assert blocks_all < plan["blocks_per_sm"], (bf16, c0, widths, k)
            assert plan["scratch"] == plan["grid"] * plan["scratch_block"] > 0
        else:
            assert plan["scratch"] == 0
    # config B in bf16: two blocks an SM (K3's and K5's middle activation in
    # shared memory, K4a's 768 in device scratch)
    for c0, widths in ((768, (384, 96)), (768, (768, 768)), (64, (64, 128))):
        for k in (16, 32, 64):
            plan = fused.chain_tc_plan(True, c0, widths, k, 4096)
            assert plan["blocks_per_sm"] >= 2
            assert plan["x_global"] == (widths[0] == 768)


def test_plan_and_table_are_shapes_alone():
    """The plan is a function of the shapes: the same dict twice, and its
    fields are those the kernel reads (``CHAIN_TC_PLAN``, but the strides
    the wrapper adds)."""
    a = fused.chain_tc_plan(False, 768, (384, 96), 16, 4096)
    assert a == fused.chain_tc_plan(False, 768, (384, 96), 16, 4096)
    missing = set(fused.CHAIN_TC_PLAN) - set(a)
    assert missing == {"n", "k", "src_stride", "out_stride"}
    table, floats = fused.chain_tc_table("p2p", False, 100, (100, 100))
    assert len(table) == 8 + 4 * 2
    assert table[0] == 112 and table[7] == 128
    assert all(x % 4 == 0 for x in table[1:8] if x >= 0)  # float4 loads
    assert floats == 112 + 128 + 128 + 8 * 128 + 128 + 80


# ---------------------------------------------------------------------------
# a numpy model of chain_tc_kernel
# ---------------------------------------------------------------------------

def bf16_round(x: np.ndarray) -> np.ndarray:
    return torch.from_numpy(np.asarray(x, np.float32)).to(BF16).float(
    ).double().numpy()


def model_chain_tc(kind, bf16, c0, widths, k, idx, src, f1c=None,
                   xyz=None, layers=(), wrel=None, s0=None, b0=None,
                   z1=None, z2=None, wn=()):
    """``[B*N, C_last]``: what the kernel computes, from the plan, the layer
    table, the parameter array and the weight stages as it reads them."""
    b, n, _ = src.shape
    total = b * n
    plan = fused.chain_tc_plan(bf16, c0, widths, k, total)
    table, _ = fused.chain_tc_table(kind, bf16, c0, widths)
    prm = fused.chain_tc_params(kind, c0, layers, wrel, s0, b0,
                                wn).double().numpy()
    img = fused.chain_tc_weights([w for w, _, _ in layers], c0)
    stages_img = img.float().numpy().astype(np.float64).reshape(
        plan["period"], -1)
    chans, cols = fused.chain_tc_arm(bf16)
    head = table[:8]
    c0p, clp = head[0], head[7]
    rows_t = fused.CHAIN_TC_ROWS
    src_f = src.float().reshape(total, -1).double().numpy()
    f1c_f = None if f1c is None else f1c.float().reshape(
        total, -1).double().numpy()
    idx_f = idx.reshape(total, k).numpy()
    out = np.full((total, widths[-1]), np.nan)
    span, qpt, tiles = plan["span"], plan["qpt"], plan["tiles"]
    r = np.arange(rows_t)
    # the B of one stage, [chans, cols], read at the descriptors' offsets
    n_ = np.arange(cols)[:, None]

    def stage_b(stage):
        """The B of one stage (its k steps), [positions, cols], read at the
        descriptors' offsets (hi + lo in float32)."""
        out = []
        for e in range(2):
            if bf16:
                p = np.arange(16)[None, :]
                off = 4096 * e + ((n_ // 8 * 2 + p // 8) * 8 + n_ % 8) * 8 \
                    + p % 8
                out.append(stage[off].T)
            else:
                p = np.arange(8)[None, :]
                off = 1024 * e + ((n_ // 8 * 2 + p // 4) * 8 + n_ % 8) * 4 \
                    + p % 4
                out.append((stage[off] + stage[2048 + off]).T)
        return np.concatenate(out)

    def stage_channels(s):
        """The input channel at each position of stage s's k steps
        (from_rows)."""
        if bf16:
            p = np.arange(16)
            return np.concatenate([32 * s + 16 * e + 4 * (p % 8 // 2)
                                   + 2 * (p // 8) + p % 2
                                   for e in range(2)])
        p = np.arange(8)
        return np.concatenate([16 * s + 4 * (p % 4) + 2 * e + p // 4
                               for e in (0, 1)])

    bs = [stage_b(st) for st in stages_img]
    for wk in range(plan["works"]):
        q0 = wk * qpt
        carry = None
        for tile in range(tiles):
            if tiles == 1:
                qi, kk = r // span, r % span
            else:
                qi, kk = np.zeros_like(r), tile * rows_t + r
            q = q0 + qi
            valid = (kk < k) & (q < total)
            qs = np.where(valid, q, 0)
            jj = np.where(valid, idx_f[qs, np.minimum(kk, k - 1)], -1)
            j = np.where((jj >= 0) & (jj < n), (qs // n) * n + jj, -1)
            # x0 at every padded channel
            c = np.arange(c0p)
            g = np.where((j[:, None] >= 0) & (c[None, :] < c0),
                         src_f[np.maximum(j, 0)][:, np.minimum(c, c0 - 1)],
                         0.0)
            if kind == "max":
                xq = np.where(valid[:, None], xyz.reshape(total, 3).double(
                ).numpy()[qs], 0.0)
                wr = prm[head[1]:head[1] + 3 * c0p].reshape(3, c0p)
                off = xq @ wr
                x = np.maximum((g - off) * prm[head[2]:head[2] + c0p]
                               + prm[head[3]:head[3] + c0p], 0.0)
            else:
                f1 = np.where(valid[:, None] & (c[None, :] < c0),
                              f1c_f[qs][:, np.minimum(c, c0 - 1)], 0.0)
                v = f1 + g + prm[head[3]:head[3] + c0p]
                x = np.where(v > 0, v, 0.1 * v)
            chunk = 0
            for li in range(len(widths)):
                cin, cout, s_off, b_off = table[8 + 4 * li:12 + 4 * li]
                assert x.shape[1] == cin
                a = bf16_round(x) if bf16 else x
                y = np.zeros((rows_t, cout))
                for cb in range(-(-cout // cols)):
                    nsub = min(cols // 64, (cout - cb * cols) // 64)
                    for s in range(cin // chans):
                        bm = bs[chunk]
                        chunk += 1
                        y[:, cb * cols:cb * cols + 64 * nsub] += (
                            a[:, stage_channels(s)] @ bm[:, :64 * nsub])
                bias = prm[b_off:b_off + cout]
                if kind == "max":
                    x = np.maximum(y * prm[s_off:s_off + cout] + bias, 0.0)
                else:
                    v = y + bias
                    x = np.where(v > 0, v, 0.1 * v)
            assert chunk == plan["period"]
            if kind == "max":
                vals = np.where(valid[:, None], x, -np.inf)
            else:
                wb0, ww1, wb1 = (prm[head[6]:head[6] + 8],
                                 prm[head[6] + 8:head[6] + 72].reshape(8, 8),
                                 prm[head[6] + 72:head[6] + 80])
                zq = z1.reshape(total, 8).double().numpy()[qs]
                zn = np.where(j[:, None] >= 0, z2.reshape(
                    total, 8).double().numpy()[np.maximum(j, 0)], 0.0)
                d = zn - np.where(valid[:, None], zq, 0.0)
                h = np.maximum(np.maximum(d + wb0, 0.0) @ ww1 + wb1, 0.0)
                ww2 = prm[head[4]:head[4] + 8 * clp].reshape(8, clp)
                w = np.maximum(h @ ww2 + prm[head[5]:head[5] + clp], 0.0)
                vals = np.where(valid[:, None], w[:, :x.shape[1]] * x, 0.0)
            for qq in range(qpt):
                rows = (qi == qq)
                red = (vals[rows].max(0) if kind == "max"
                       else vals[rows].sum(0))
                if tiles > 1:
                    carry = red if carry is None else (
                        np.maximum(carry, red) if kind == "max"
                        else carry + red)
                    red = carry
                if q0 + qq < total and tile + 1 == tiles:
                    out[q0 + qq] = red[:widths[-1]]
    return out.reshape(b, n, -1)


def assert_bars(got, want, bf16):
    got, want = np.asarray(got, np.float64), want.double().numpy()
    top = np.abs(want).max()
    err = np.abs(got - want).max()
    if bf16:
        assert err <= BF16_RTOL * top, (err, top)
    else:
        assert err <= FUSED_ATOL and err <= FUSED_RTOL * top, (err, top)


def plf_inputs(rs, b, n, k, widths, dtype):
    c0 = widths[0]
    xyz = torch.from_numpy(rs.randn(b, n, 3).astype(np.float32) * 3)
    feat = torch.from_numpy(rs.randn(b, n, c0).astype(np.float32))
    idx = torch.from_numpy(rs.randint(-2, n + 2, (b, n, k)).astype(np.int32))
    chain = [torch.from_numpy(rs.randn(3, c0).astype(np.float32) * 0.3),
             torch.from_numpy(rs.uniform(0.8, 1.2, c0).astype(np.float32)),
             torch.from_numpy(rs.uniform(-0.1, 0.1, c0).astype(np.float32))]
    for w in weights(rs, c0, widths[1:]):
        cout = w.shape[1]
        chain += [w,
                  torch.from_numpy(rs.uniform(0.8, 1.2, cout).astype(
                      np.float32)),
                  torch.from_numpy(rs.uniform(-0.1, 0.1, cout).astype(
                      np.float32))]
    chain = [t.to(dtype) if i % 3 == 0 else t for i, t in enumerate(chain)]
    return feat.to(dtype), idx, xyz, chain


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("case", [((37, 45, 19), 1), ((37, 45, 19), 3),
                                  ((64, 64, 128), 8), ((40, 70), 16),
                                  ((24, 40, 56), 20), ((96, 64, 48, 32), 64),
                                  ((23, 33), 100)])
def test_kernel_model_max(bf16, case):
    """K5's (and K3's) chains: every reduction path of the kernel (a query
    of 1, 4, 8, 16, 32, 64 rows, and over two tiles) at odd widths."""
    widths, k = case
    rs = np.random.RandomState(k + sum(widths))
    dtype = BF16 if bf16 else torch.float32
    feat, idx, xyz, chain = plf_inputs(rs, 2, 40, k, widths, dtype)
    want = fused.fused_point_local_feature_plain(feat, idx, xyz, chain)
    xyz_c = fused.center_xyz(xyz)
    base = fused.make_plf_base(feat, xyz_c, chain[0], dtype)
    layers = list(zip(chain[3::3], chain[4::3], chain[5::3]))
    got = model_chain_tc("max", bf16, widths[0], widths[1:], k, idx, base,
                         xyz=xyz_c, layers=layers, wrel=chain[0].float(),
                         s0=chain[1], b0=chain[2])
    assert_bars(got, want, bf16)


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("case", [(100, 5), (37, 16), (64, 33), (20, 100)])
def test_kernel_model_p2p(bf16, case):
    """K4a's chain at C not a multiple of 64, K of one, several and over
    two tiles, with its WeightNet."""
    c, k = case
    rs = np.random.RandomState(c + k)
    dtype = BF16 if bf16 else torch.float32
    b, n = 2, 40
    f1c, f2c = (torch.from_numpy(rs.randn(b, n, c).astype(np.float32)).to(
        dtype) for _ in range(2))
    z1, z2 = (torch.from_numpy(rs.randn(b, n, 8).astype(np.float32))
              for _ in range(2))
    idx = torch.from_numpy(rs.randint(-2, n + 2, (b, n, k)).astype(np.int32))
    w1, w2 = weights(rs, c, (c, c), dtype)
    b0, b1, b2 = (torch.from_numpy(rs.uniform(-0.1, 0.1, c).astype(
        np.float32)) for _ in range(3))
    wn = [torch.from_numpy(rs.uniform(-0.5, 0.5, s).astype(np.float32))
          for s in ((8,), (8, 8), (8,), (8, c), (c,))]
    dense = (b0, w1, b1, w2, b2)
    want = fused.cost_volume_p2p_plain(f1c, f2c, idx, z1, z2, dense, wn)
    got = model_chain_tc("p2p", bf16, c, (c, c), k, idx, f2c, f1c=f1c,
                         layers=[(w1, None, b1), (w2, None, b2)], b0=b0,
                         z1=z1, z2=z2, wn=wn)
    if bf16:  # the kernel rounds its sum to bf16 once, as the plain one
        got = bf16_round(got)
    assert_bars(got, want.float(), bf16)


def test_deep_chain_matches_jax():
    """A K5 chain of 34 Dense layers (narrow widths, B=2, N=128), which the
    generic kernel once refused (at most 32), through the port's wrapper on
    the CPU against the JAX package's ``fused_point_local_feature`` in
    interpret mode, at the float32 serving bars."""
    rs = np.random.RandomState(34)
    widths = (16,) * 35
    feat, idx, xyz, chain = plf_inputs(rs, 2, 128, 8, widths, torch.float32)
    idx = torch.from_numpy(rs.randint(0, 128, (2, 128, 8)).astype(np.int32))
    # He-scaled layers keep the activations of order one over 34 layers
    chain = [t * np.sqrt(2.0) if i >= 3 and i % 3 == 0 else t
             for i, t in enumerate(chain)]
    got = fused.fused_point_local_feature(feat, idx, xyz, chain)
    want = np.asarray(jfused.fused_point_local_feature(
        jnp.asarray(feat.numpy()), jnp.asarray(idx.numpy()),
        jnp.asarray(xyz.numpy()), tuple(jnp.asarray(t.numpy())
                                        for t in chain), True))
    assert got.shape == (2, 128, 16)
    top = np.abs(want).max()
    assert 0.1 < top < 1e3
    err = np.abs(got.numpy() - want).max()
    assert err <= FUSED_ATOL and err <= FUSED_RTOL * top, (err, top)
    # the plan takes it: one table row a layer, 34 layers
    plan = fused.chain_tc_plan(False, 16, widths[1:], 8, 256)
    assert plan["layers"] == 34
    assert len(fused.chain_tc_table("max", False, 16, widths[1:])[0]) == (
        8 + 4 * 34)


@pytest.mark.parametrize("seed", [40, 41])
def test_deep_bf16_chain_matches_jax(seed):
    """A K5 chain of 40 Dense layers, 64 wide, with dense He-scaled bf16
    kernels (B=1, N=32, K=4): the port's plain bf16 version on the CPU
    against the JAX package's bf16 ``fused_point_local_feature`` in
    interpret mode, at the bf16 bar (1e-2 of the largest magnitude).  Both
    round each activation to bf16 where the other does and sum in float32
    in their own orders, so a rounding that one order flips compounds
    through the layers; at this size they lie 1.7e-7-1.5e-3 apart, while
    each lies 2.6-3.0% from its own float32 chain (seeds 40-42), as the
    card's kernel lies 1.46% from its plain version at B=16, N=256, K=16
    (``chip_smoke.py``'s ``deep_bf16_witness``)."""
    rs = np.random.RandomState(seed)
    widths = (64,) * 41
    feat, idx, xyz, chain = plf_inputs(rs, 1, 32, 4, widths, torch.float32)
    idx = torch.from_numpy(rs.randint(0, 32, (1, 32, 4)).astype(np.int32))
    chain = [t * np.sqrt(2.0) if i >= 3 and i % 3 == 0 else t
             for i, t in enumerate(chain)]
    out = {}
    for dtype, jdtype in ((BF16, jnp.bfloat16), (torch.float32,
                                                 jnp.float32)):
        typed = [t.to(dtype) if i % 3 == 0 else t
                 for i, t in enumerate(chain)]
        f = feat.to(dtype)
        out[dtype] = fused.fused_point_local_feature(f, idx, xyz, typed)
        out[jdtype] = np.asarray(jfused.fused_point_local_feature(
            jnp.asarray(f.float().numpy()).astype(jdtype),
            jnp.asarray(idx.numpy()), jnp.asarray(xyz.numpy()),
            tuple(jnp.asarray(t.float().numpy()).astype(jdtype)
                  if i % 3 == 0 else jnp.asarray(t.numpy())
                  for i, t in enumerate(typed)), True), np.float32)
    got, want = out[BF16].numpy(), out[jnp.bfloat16]
    assert got.shape == want.shape == (1, 32, 64)
    top = np.abs(want).max()
    assert 0.1 < top < 1e3
    err = np.abs(got - want).max()
    assert err <= BF16_RTOL * top, (err, top)
    # JAX's bf16 lies from its own float32 as the port's does from its own
    drift = np.abs(want - out[jnp.float32]).max() / top
    assert 1e-3 < drift < 0.1, drift
