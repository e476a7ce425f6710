"""The precision argument of the tensor-core kernels K5 (``csrc/plf.cu``)
and K4a (``csrc/cost_volume.cu``), on the CPU.

Both kernels compute their float32 products as three TF32 products (3xTF32,
``csrc/tc_gemm.cuh``): each operand is split into ``hi = tf32(x)`` and
``lo = tf32(x - hi)``, rounded to nearest with ties away from zero as
``cvt.rna.tf32.f32`` rounds, and ``x @ w`` becomes
``lo @ w_hi + hi @ w_lo + hi @ w_hi``.  Here a plain emulation of that
arithmetic, written in this file and used by nothing in the package, runs
K5's and K4a's full-width chains (512 -> 256 -> 64 and 512 -> 512 -> 512)
and is held to the plain float32 versions at the kernels' bars (1e-4 abs
and 1e-5 of the output's largest magnitude).  A single TF32 product per
product misses the relative bar: the margin is printed and checked.  The
weights' split and the order in which ``ops/fused.py::tc_weights`` lays
them out for the kernels are held to this emulation and to the kernels'
index arithmetic.

The emulation sums in float64: it models what the split drops (``lo @
w_lo`` and the rounding of ``lo``), not the tensor cores' own rounding of
their sums, which the kernels keep short (``tc::promote``); the card test
``tests/test_torch_cuda.py`` holds the kernels themselves to the bars.
"""

import numpy as np
import pytest
import torch

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
