"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Run them on a machine with an NVIDIA GPU and nvcc:

    python -m pytest -m cuda tests/test_torch_cuda.py

Without a CUDA device every test here skips (the check is made inside the
``dev`` fixture, when a test runs).  Tolerance: none.  The kernels compute
squared distances in the plain versions' float32 operation order and a
gather copies, so indices and rows must be bit-identical.
"""

import numpy as np
import pytest
import torch

from cmflow_tpu_torch.ops import fused, neighbors, pointops

pytestmark = pytest.mark.cuda

RADII = (2.0, 4.0, 8.0, 16.0)
KS = (4, 8, 16, 32)


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


def test_rejects_non_contiguous(dev, rs):
    p = cloud(rs, 2, 128, dev)
    pt = p.transpose(0, 1).contiguous().transpose(0, 1)
    with pytest.raises(ValueError, match="contiguous"):
        neighbors.knn(8, pt, pt)
