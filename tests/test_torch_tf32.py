"""The precision argument of the tensor-core kernels K5 (``csrc/plf.cu``),
K4a (``csrc/cost_volume.cu``) and K3 (``csrc/mse.cu``), on the CPU.

The kernels compute their float32 products as three TF32 products (3xTF32,
``csrc/tc_gemm.cuh``): each operand is split into ``hi = tf32(x)`` and
``lo = tf32(x - hi)``, rounded to nearest with ties away from zero as
``cvt.rna.tf32.f32`` rounds, and ``x @ w`` becomes
``lo @ w_hi + hi @ w_lo + hi @ w_hi``.  Here a plain emulation of that
arithmetic, written in this file and used by nothing in the package, runs
K5's and K4a's full-width chains (512 -> 256 -> 64 and 512 -> 512 -> 512)
and K3's (the first layer formed from each gathered point, 8 -> 32 -> 32 ->
64, four scales) and is held to the plain float32 versions at the kernels'
bars (1e-4 abs and 1e-5 of the output's largest magnitude).  A single TF32
product per product misses the relative bar: the margin is printed and
checked.  The weights' split and the order in which
``ops/fused.py::tc_weights`` and ``mse_tc_weights`` lay them out for the
kernels are held to this emulation and to the kernels' index arithmetic.

The emulation sums in float64: it models what the split drops (``lo @
w_lo`` and the rounding of ``lo``), not the tensor cores' own rounding of
their sums, which the kernels keep short (``tc::promote``); the card test
``tests/test_torch_cuda.py`` holds the kernels themselves to the bars.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from cmflow_tpu_torch.native import build
from cmflow_tpu_torch.nn import blocks
from cmflow_tpu_torch.ops import fused, neighbors

FUSED_ATOL = 1e-4
FUSED_RTOL = 1e-5  # of the output's largest magnitude


def rna_tf32(x: np.ndarray) -> np.ndarray:
    """Round float32 ``x`` to 10 mantissa bits, to nearest, ties away from
    zero, computed in float64 from the exponent (not from the bits)."""
    x = x.astype(np.float64)
    out = np.zeros_like(x)
    nz = x != 0
    ulp = np.exp2(np.floor(np.log2(np.abs(x[nz]))) - 10)
    out[nz] = np.sign(x[nz]) * np.floor(np.abs(x[nz]) / ulp + 0.5) * ulp
    return out.astype(np.float32)


def split(x: np.ndarray):
    hi = rna_tf32(x)
    return hi, rna_tf32(x - hi)


def mm3(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` as the kernels compute it: three TF32 products, summed
    exactly (float64), rounded to float32."""
    xh, xl = (torch.from_numpy(a).double() for a in split(x.numpy()))
    wh, wl = (torch.from_numpy(a).double() for a in split(w.numpy()))
    return (xl @ wh + xh @ wl + xh @ wh).float()


def mm1(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` as one TF32 product."""
    xh, wh = (torch.from_numpy(rna_tf32(a.numpy())).double() for a in (x, w))
    return (xh @ wh).float()


def margins(got, want):
    err = float((got.double() - want.double()).abs().max())
    return err, float(want.abs().max())


def seeded(module, seed):
    """Seeded weights, BatchNorm statistics near the identity."""
    gen = torch.Generator().manual_seed(seed)
    blocks.init_parameters(module, gen)
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, blocks.BatchNorm):
                m.weight.uniform_(0.7, 1.3, generator=gen)
                m.bias.uniform_(-0.2, 0.2, generator=gen)
                m.running_mean.uniform_(-0.1, 0.1, generator=gen)
                m.running_var.uniform_(0.5, 2.0, generator=gen)
    return module


# ---------------------------------------------------------------------------
# the split
# ---------------------------------------------------------------------------

def test_split_properties():
    rs = np.random.RandomState(41)
    x = (rs.randn(20000) * np.exp2(rs.randint(-30, 30, 20000))).astype(
        np.float32)
    x[:4] = [0.0, -0.0, 1.0, -3.0]
    hi, lo = fused.tf32_split(torch.from_numpy(x))
    hi, lo = hi.numpy(), lo.numpy()
    for part in (hi, lo):  # at most 10 mantissa bits: the low 13 are zero
        assert not (part.view(np.uint32) & 0x1FFF).any()
    want_hi, want_lo = split(x)
    assert np.array_equal(hi, want_hi) and np.array_equal(lo, want_lo)
    x64 = x.astype(np.float64)
    nz = x64 != 0
    rel = np.abs(hi.astype(np.float64) + lo - x64)[nz] / np.abs(x64[nz])
    assert rel.max() <= 2.0 ** -22, rel.max()
    assert not hi[~nz].any() and not lo[~nz].any()
    assert np.abs(hi.astype(np.float64) - x).max() > 0  # hi alone is not x


def test_split_rounds_ties_away_from_zero():
    # 1 + 2^-11 lies half way between two TF32 values
    x = np.array([1 + 2.0 ** -11, -(1 + 2.0 ** -11), 1 + 2.0 ** -12],
                 dtype=np.float32)
    hi, _ = fused.tf32_split(torch.from_numpy(x))
    assert hi.tolist() == [1 + 2.0 ** -10, -(1 + 2.0 ** -10), 1.0]


# ---------------------------------------------------------------------------
# the packed weights, read as the kernels read them
# ---------------------------------------------------------------------------

def kernel_channel(step, p, from_rows):
    """The input channel a kernel puts at k8 step ``step``, position ``p``
    (csrc/plf.cu, csrc/cost_volume.cu)."""
    if from_rows:
        q, e = step // 2, step % 2
        return 16 * q + 4 * (p % 4) + 2 * e + p // 4
    return 8 * step + 2 * (p % 4) + p // 4


def read_tiles(flat: np.ndarray, cin: int, cout: int, from_rows: bool):
    """Undo the B-tile layout of csrc/tc_gemm.cuh: element (n, p) of a step
    at ((n // 8 * 2 + p // 4) * 8 + n % 8) * 4 + p % 4; returns the
    ``[cin, cout]`` matrix the kernel multiplies by."""
    steps = flat.reshape(cin // 8, cout * 8)
    n = np.arange(cout)[:, None]
    p = np.arange(8)[None, :]
    off = ((n // 8 * 2 + p // 4) * 8 + n % 8) * 4 + p % 4
    w = np.zeros((cin, cout), np.float32)
    for s in range(cin // 8):
        for pp in range(8):
            w[kernel_channel(s, pp, from_rows)] = steps[s, off[:, pp]]
    return w


@pytest.mark.parametrize("widths", [(512, 256, 64), (512, 512, 512)],
                         ids=["K5", "K4a"])
def test_tc_weights_layout(widths):
    """``tc_weights`` holds hi of w1 and w2, then lo of both, each step in
    the kernels' K order and tile layout."""
    c0, c1, c2 = widths
    rs = np.random.RandomState(42)
    w1 = rs.randn(c0, c1).astype(np.float32)
    w2 = rs.randn(c1, c2).astype(np.float32)
    packed = fused.tc_weights(torch.from_numpy(w1),
                              torch.from_numpy(w2)).numpy()
    n1, n2 = c0 * c1, c1 * c2
    assert packed.shape == (2 * (n1 + n2),)
    for half, want in ((packed[:n1 + n2], 0), (packed[n1 + n2:], 1)):
        got1 = read_tiles(half[:n1], c0, c1, True)
        got2 = read_tiles(half[n1:], c1, c2, False)
        assert np.array_equal(got1, split(w1)[want])
        assert np.array_equal(got2, split(w2)[want])
    # the stages the kernels stream are whole k8 steps of one product
    assert (n1 * 4) % 32768 == 0 and (n2 * 4) % 16384 == 0


def descriptor_read(step, rows):
    """A k16 step of a bf16 wgmma operand (A or B, K-major, no swizzle) as
    the tensor cores read it through a descriptor with LBO 128 and SBO 256
    bytes (csrc/tc_gemm.cuh): ``[rows, 16]``, element (r, p) at element
    ``((r // 8 * 2 + p // 8) * 8 + r % 8) * 8 + p % 8``."""
    r = np.arange(rows)[:, None]
    p = np.arange(16)[None, :]
    return step[((r // 8 * 2 + p // 8) * 8 + r % 8) * 8 + p % 8]


@pytest.mark.parametrize("widths", [(512, 256, 64), (512, 512, 512)],
                         ids=["K5", "K4a"])
def test_tc_weights_bf16_layout(widths):
    """``tc_weights_bf16`` holds w1 then w2, each k16 step of channels in
    natural order a B tile; x0 stored as the bf16 kernels store it (row r's
    channels 8h .. 8h+7 of a step at byte ``a_offset(r, h)``, a step
    ``kAStep`` bytes) and read through the A descriptor, times the B tiles,
    gives ``x0 @ w1``."""
    c0, c1, c2 = widths
    rs = np.random.RandomState(43)
    w1 = torch.from_numpy(rs.randn(c0, c1).astype(np.float32)).to(
        torch.bfloat16)
    w2 = torch.from_numpy(rs.randn(c1, c2).astype(np.float32)).to(
        torch.bfloat16)
    packed = fused.tc_weights_bf16(w1, w2).float().numpy()
    n1 = c0 * c1
    assert packed.shape == (n1 + c1 * c2,)
    for flat, w in ((packed[:n1], w1), (packed[n1:], w2)):
        cin, cout = w.shape
        steps = flat.reshape(cin // 16, cout * 16)
        got = np.concatenate([descriptor_read(st, cout).T for st in steps])
        assert np.array_equal(got, w.float().numpy())
    # x0 of 64 rows as the kernels store it, 8 channels a 16-byte store
    header = (Path(build.__file__).parents[1] / "csrc" /
              "tc_gemm.cuh").read_text()
    a_step = int(re.search(r"kAStep = (\d+);", header).group(1))
    assert a_step == 64 * 16 * 2
    x0 = rs.randn(64, c0).astype(np.float32)
    tiles = np.zeros(c0 // 16 * a_step // 2, np.float32)
    for r in range(64):
        for c8 in range(c0 // 8):
            at = (c8 // 2) * a_step + (((r // 8 * 2 + c8 % 2) * 8 + r % 8)
                                       * 16)  # a_offset(r, c8 % 2)
            tiles[at // 2:at // 2 + 8] = x0[r, 8 * c8:8 * c8 + 8]
    steps_a = tiles.reshape(c0 // 16, a_step // 2)
    steps_b = packed[:n1].reshape(c0 // 16, c1 * 16)
    prod = sum(descriptor_read(a, 64).astype(np.float64)
               @ descriptor_read(b, c1).T.astype(np.float64)
               for a, b in zip(steps_a, steps_b))
    want = x0.astype(np.float64) @ w1.double().numpy()
    np.testing.assert_allclose(prod, want, rtol=1e-12, atol=1e-9)
    # the stages the kernels stream are whole k16 steps of one product
    assert (n1 * 2) % 32768 == 0 and (c1 * c2 * 2) % 32768 == 0


RADII = (2.0, 4.0, 8.0, 16.0)
KS = (4, 8, 16, 32)


def seeded_mse(seed, cf=3):
    mse = seeded(blocks.MultiScaleEncoder(RADII, KS, cf, (32, 32, 64),
                                          (64, 64, 64)), seed)
    with torch.no_grad():
        packed, _ = fused.mse_narrow_params_from_variables(mse)
    return packed


def first_layer(packed, s):
    """Scale s's first layer as K3 multiplies by it: ``[w0r; w0f]`` with
    zero rows up to 8."""
    w = torch.cat((packed[0][s], packed[1][s]))
    return torch.cat((w, w.new_zeros(8 - w.shape[0], w.shape[1])))


@pytest.mark.parametrize("cf", [3, 5])
def test_mse_weights_layout(cf):
    """``mse_tc_weights`` holds, per scale, the (b0, b1) pair of each
    mma.sync B fragment slot of K3's three products, read here as
    csrc/mse.cu reads them (slot (step, tile, lane) at
    ``(step * tiles + tile) * 32 + lane``; lane (g, t) holds rows t and
    t + 4 of column g of the tile; the first product's rows in channel
    order, the others' in the accumulator's order), then the affines."""
    packed = seeded_mse(47, cf)
    with torch.no_grad():
        image = fused.mse_tc_weights(packed).numpy()
        layers = [[first_layer(packed, s), packed[4][s], packed[7][s]]
                  for s in range(len(KS))]
    s_cnt = len(KS)
    assert image.shape == (s_cnt, fused.MSE_IMAGE) == (s_cnt, 3584)
    for s in range(s_cnt):
        want = layers[s]
        at = 0
        for product, (steps, tiles) in enumerate(((1, 4), (4, 4), (4, 8))):
            cin, cout = want[product].shape
            got = np.full((cin, cout), np.nan, np.float32)
            for j in range(steps):
                for nt in range(tiles):
                    for lane in range(32):
                        g, t = lane // 4, lane % 4
                        for e, p in enumerate((t, t + 4)):
                            k = p if product == 0 else kernel_channel(
                                j, p, False)
                            got[k, 8 * nt + g] = image[s, at + e]
                        at += 2
            assert np.array_equal(got, want[product].numpy()), product
        aff = image[s, at:]
        c = (32, 32, 32, 32, 64, 64)
        for i, (vec, width) in enumerate(zip((2, 3, 5, 6, 8, 9), c)):
            lo = sum(c[:i])
            assert np.array_equal(
                aff[lo:lo + width],
                packed[vec][s * width:(s + 1) * width].numpy())
        assert at + sum(c) == fused.MSE_IMAGE


# ---------------------------------------------------------------------------
# the chains: 3xTF32 meets the bars, one TF32 product does not
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def plf_case():
    rs = np.random.RandomState(43)
    b, n, k = 2, 64, 16
    xyz = torch.from_numpy((rs.rand(b, n, 3) * 10).astype(np.float32))
    feat_tx = torch.from_numpy(rs.randn(b, n, 512).astype(np.float32))
    plf = seeded(blocks.PointLocalFeature(4.0, k, 1027, (512, 256, 64),
                                          (64, 64, 64)), 44)
    (idx,) = neighbors.ball_query_multi_plain((4.0,), (k,), xyz, xyz)
    with torch.no_grad():
        chain, _, _ = fused.plf_params_from_variables(plf)
    return feat_tx, idx, xyz, chain


def plf_emulated(feat_tx, idx, xyz, chain, mm):
    """``fused_point_local_feature_plain`` with its products taken by
    ``mm``."""
    wrel, s0, b0, w1, s1, b1, w2, s2, b2 = chain
    xyz_c = fused.center_xyz(xyz)
    base = fused.make_plf_base(feat_tx, xyz_c, wrel)
    b, s, k = idx.shape
    x = (fused.gather_rows_plain(base, idx.reshape(b, s * k)).reshape(
        b, s, k, -1) - (xyz_c @ wrel)[:, :, None, :])
    x = torch.relu(x * s0 + b0)
    x = torch.relu(mm(x.reshape(-1, x.shape[-1]), w1) * s1 + b1)
    x = torch.relu(mm(x, w2) * s2 + b2)
    return torch.amax(x.reshape(b, s, k, -1), dim=2)


@pytest.fixture(scope="module")
def cv_case():
    rs = np.random.RandomState(45)
    b, n, k = 2, 64, 8
    fc = seeded(blocks.FeatureCorrelator(k, 512, 512, (512, 512, 512)), 46)
    with torch.no_grad():
        dense, wn1, _ = fused.cv_params_from_variables(fc)
    f1c, f2c = (torch.from_numpy(rs.randn(b, n, 512).astype(np.float32))
                for _ in range(2))
    z1, z2 = (torch.from_numpy(rs.randn(b, n, 8).astype(np.float32))
              for _ in range(2))
    xyz = torch.from_numpy((rs.rand(b, n, 3) * 10).astype(np.float32))
    idx = neighbors.knn_plain(k, xyz, xyz)
    return f1c, f2c, idx, z1, z2, dense[1:], wn1[1:]


def cv_emulated(f1c, f2c, idx, z1, z2, dense, wn, mm):
    """``cost_volume_p2p_plain`` with its two 512x512 products taken by
    ``mm``."""
    b0, w1, b1, w2, b2 = dense
    b, s, k = idx.shape
    flat = idx.reshape(b, s * k)
    g2 = fused.gather_rows_plain(f2c, flat).reshape(b, s, k, -1)
    x = fused._leaky((f1c[:, :, None, :] + g2) + b0).reshape(b * s * k, -1)
    x = fused._leaky(mm(x, w1) + b1)
    x = fused._leaky(mm(x, w2) + b2).reshape(b, s, k, -1)
    gz = fused.gather_rows_plain(z2, flat).reshape(b, s, k, -1)
    w = fused._weightnet_tail(gz - z1[:, :, None, :], wn)
    return torch.sum(w * x, dim=2)


def test_plf_chain_3xtf32_meets_bars(plf_case):
    with torch.no_grad():
        want = fused.fused_point_local_feature_plain(*plf_case)
        err, scale = margins(plf_emulated(*plf_case, mm3), want)
        err1, _ = margins(plf_emulated(*plf_case, mm1), want)
    print(f"K5: 3xTF32 {err:.3g}, one TF32 product {err1:.3g}, at a largest "
          f"magnitude of {scale:.3g}; relative bar {FUSED_RTOL * scale:.3g}")
    assert scale > 0.1
    assert err <= FUSED_ATOL and err <= FUSED_RTOL * scale
    assert err1 > FUSED_RTOL * scale  # why the kernels do not use one


@pytest.fixture(scope="module")
def mse_case():
    rs = np.random.RandomState(48)
    b, n = 2, 96
    xyz = torch.from_numpy((rs.rand(b, n, 3) * 20).astype(np.float32))
    feats = torch.from_numpy(rs.randn(b, n, 3).astype(np.float32))
    idx = list(neighbors.ball_query_multi_plain(RADII, KS, xyz, xyz))
    idx[1][0, :3, 0] = torch.tensor([-1, n, n + 5], dtype=torch.int32)
    return feats, idx, xyz, seeded_mse(49)


def mse_emulated(feats, idx_list, xyz, packed, mm):
    """``fused_multi_scale_encoder_plain`` as csrc/mse.cu computes it, its
    products taken by ``mm``: each query's K rows padded to the next power
    of two with its first neighbour, the first layer of each row from
    ``[xyz[j] - xyz[i], feats[j], 0, 0]`` (the cloud's centroid with zero
    features for an index outside [0, N)), then the chain and the max."""
    _, _, s0, b0, _, s1, b1, _, s2, b2 = packed
    b, n, cf = feats.shape
    ctr = xyz.mean(dim=1, keepdim=True)
    outs = []
    for s, idx in enumerate(idx_list):
        k = idx.shape[2]
        p = 1 << (k - 1).bit_length()
        idx = torch.cat([idx, idx[..., :1].expand(b, n, p - k)], dim=-1)
        inside = (idx >= 0) & (idx < n)
        pts = torch.where(inside[..., None], fused._group(xyz, idx),
                          ctr[:, :, None])
        v = torch.cat([pts - xyz[:, :, None], fused._group(feats, idx),
                       feats.new_zeros(b, n, p, 8 - 3 - cf)], dim=-1)
        r1, r2, r3 = (slice(s * c, (s + 1) * c) for c in (32, 32, 64))
        x = v.reshape(-1, 8)
        x = torch.relu(mm(x, first_layer(packed, s)) * s0[r1] + b0[r1])
        x = torch.relu(mm(x, packed[4][s]) * s1[r2] + b1[r2])
        x = torch.relu(mm(x, packed[7][s]) * s2[r3] + b2[r3])
        outs.append(torch.amax(x.reshape(b, n, p, -1), dim=2))
    return torch.cat(outs, dim=-1)


def test_mse_chain_3xtf32_meets_bars(mse_case):
    with torch.no_grad():
        want = fused.fused_multi_scale_encoder_plain(*mse_case)
        err, scale = margins(mse_emulated(*mse_case, mm3), want)
        err1, _ = margins(mse_emulated(*mse_case, mm1), want)
    print(f"K3: 3xTF32 {err:.3g}, one TF32 product {err1:.3g}, at a largest "
          f"magnitude of {scale:.3g}; relative bar {FUSED_RTOL * scale:.3g}")
    assert scale > 0.1
    assert err <= FUSED_ATOL and err <= FUSED_RTOL * scale
    assert err1 > FUSED_RTOL * scale


def test_cv_chain_3xtf32_meets_bars(cv_case):
    with torch.no_grad():
        want = fused.cost_volume_p2p_plain(*cv_case)
        err, scale = margins(cv_emulated(*cv_case, mm3), want)
        err1, _ = margins(cv_emulated(*cv_case, mm1), want)
    print(f"K4a: 3xTF32 {err:.3g}, one TF32 product {err1:.3g}, at a largest "
          f"magnitude of {scale:.3g}; relative bar {FUSED_RTOL * scale:.3g}")
    assert scale > 0.1
    assert err <= FUSED_ATOL and err <= FUSED_RTOL * scale
    assert err1 > FUSED_RTOL * scale
