"""Port parity: neighbour search, point ops, the row gather and its
backward of ``cmflow_tpu_torch.ops`` against the JAX package on the CPU.

On CPU tensors the port's wrappers run their kernels' plain PyTorch
versions.  They are held to the Pallas kernels run in interpret mode
(``ball_query_multi``, ``knn_pallas``, ``mxu_group_points``) and to the XLA
references (``_ball_query_xla``, ``_knn_xla``, the vmap gather).
Tolerance: none.  Indices and gathered rows must be bit-identical, because
both sides compute squared distances in the same float32 operation order
and a gather copies.  The gather's backward (K7) sums cotangent rows: on
values with at most 15 significant bits (which the JAX kernel's hi/lo bf16
one-hot products carry exactly, and whose sums float32 holds exactly) it is
bit-identical too; on normal values it is held to 1e-5 of the output's
largest magnitude (the one-hot products keep ~16 bits of each term).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmflow_tpu.ops import pointops as jpo
from cmflow_tpu.ops.fused import mxu_group_points
from cmflow_tpu.ops.neighbors import ball_query_multi as jax_ball_query_multi
from cmflow_tpu.ops.neighbors import knn_pallas
from cmflow_tpu_torch.ops import fused, neighbors, pointops

RADII = (2.0, 4.0, 8.0, 16.0)
KS = (4, 8, 16, 32)
SIZES = (128, 256, 384)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture
def rs():
    return np.random.RandomState(7)


def cloud(rs, b, n, scale=20.0):
    return (rs.rand(b, n, 3) * scale).astype(np.float32)


def valid_mask(rs, b, n):
    """Random holes plus an all-invalid tail, as padding gives."""
    real = np.array([n - n // 4 - 3 * i for i in range(b)])
    return (rs.rand(b, n) > 0.2) & (np.arange(n)[None, :] < real[:, None])


def t(x):
    return torch.from_numpy(np.asarray(x))


def j(x):
    return None if x is None else jnp.asarray(x)


def assert_same(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want)


class TestSquareDistance:
    @pytest.mark.parametrize("n", SIZES)
    def test_bitwise(self, rs, n):
        q, p = cloud(rs, 2, n // 2), cloud(rs, 2, n)
        valid = valid_mask(rs, 2, n)
        assert_same(pointops.square_distance(t(q), t(p)),
                    jpo.square_distance(j(q), j(p)))
        assert_same(pointops.masked_square_distance(t(q), t(p), t(valid)),
                    jpo.masked_square_distance(j(q), j(p), j(valid)))


class TestBallQuery:
    @pytest.mark.parametrize("masked", [False, True])
    @pytest.mark.parametrize("n", SIZES)
    def test_all_scales(self, rs, n, masked):
        b = 2
        p = cloud(rs, b, n)
        valid = valid_mask(rs, b, n) if masked else None
        got = neighbors.ball_query_multi(RADII, KS, t(p), t(p),
                                         None if valid is None else t(valid))
        pallas = jax_ball_query_multi(RADII, KS, j(p), j(p), True,
                                      points_valid=j(valid))
        for r, k, g, pk in zip(RADII, KS, got, pallas):
            assert g.shape == (b, n, k)
            assert_same(g, pk)
            assert_same(g, jpo._ball_query_xla(r, k, j(p), j(p), j(valid)))
        # one radius per call, as the model calls it
        for r, k, g in zip(RADII, KS, got):
            assert_same(pointops.ball_query(
                r, k, t(p), t(p), None if valid is None else t(valid)), g.numpy())

    def test_query_ne_points(self, rs):
        p, q = cloud(rs, 2, 256), cloud(rs, 2, 128, scale=25.0)
        got = neighbors.ball_query_multi((3.0, 6.0), (8, 16), t(p), t(q))
        want = jax_ball_query_multi((3.0, 6.0), (8, 16), j(p), j(q), True)
        for g, w in zip(got, want):
            assert_same(g, w)

    def test_empty_balls_and_far_queries(self, rs):
        p = cloud(rs, 2, 256, scale=200.0)
        (got,) = neighbors.ball_query_multi((0.5,), (8,), t(p), t(p))
        (want,) = jax_ball_query_multi((0.5,), (8,), j(p), j(p), True)
        assert_same(got, want)
        far = p + 1e4
        (got,) = neighbors.ball_query_multi((1.0,), (4,), t(p), t(far))
        assert (got.numpy() == 0).all()
        assert_same(got, jpo._ball_query_xla(1.0, 4, j(p), j(far)))

    def test_all_invalid_cloud(self, rs):
        p = cloud(rs, 1, 128)
        valid = np.zeros((1, 128), bool)
        (got,) = neighbors.ball_query_multi((16.0,), (8,), t(p), t(p), t(valid))
        assert (got.numpy() == 0).all()
        assert_same(got, jpo._ball_query_xla(16.0, 8, j(p), j(p), j(valid)))

    def test_duplicate_points(self, rs):
        base = cloud(rs, 1, 32)
        p = np.tile(base, (1, 8, 1))  # 256 points, every one eight times
        got = neighbors.ball_query_multi(RADII, KS, t(p), t(p))
        want = jax_ball_query_multi(RADII, KS, j(p), j(p), True)
        for g, w in zip(got, want):
            assert_same(g, w)

    def test_more_slots_than_points(self, rs):
        p = cloud(rs, 2, 16, scale=4.0)
        got = pointops.ball_query(3.0, 32, t(p), t(p))
        assert_same(got, jpo._ball_query_xla(3.0, 32, j(p), j(p)))

    # more radii than the kernel fills in one scan (MAX_RADII = 4): the
    # card takes one launch per group of four, JAX one Pallas kernel
    @pytest.mark.parametrize("masked", [False, True])
    @pytest.mark.parametrize("count", [5, 8])
    def test_more_than_four_radii(self, rs, count, masked):
        radii = (0.7, 1.5, 2.0, 3.0, 4.0, 6.0, 8.0, 16.0)[:count]
        ks = (3, 4, 8, 16, 32, 40, 64, 80)[:count]
        p, q = cloud(rs, 2, 256), cloud(rs, 2, 128)
        valid = valid_mask(rs, 2, 256) if masked else None
        got = neighbors.ball_query_multi(radii, ks, t(p), t(q),
                                         None if valid is None else t(valid))
        pallas = jax_ball_query_multi(radii, ks, j(p), j(q), True,
                                      points_valid=j(valid))
        assert len(got) == len(pallas) == count
        for r, k, g, pk in zip(radii, ks, got, pallas):
            assert g.shape == (2, 128, k)
            assert_same(g, pk)
            assert_same(g, jpo._ball_query_xla(r, k, j(p), j(q), j(valid)))


class TestKnn:
    @pytest.mark.parametrize("masked", [False, True])
    @pytest.mark.parametrize("n", SIZES)
    def test_matches_topk(self, rs, n, masked):
        q, p = cloud(rs, 2, n), cloud(rs, 2, n)
        valid = valid_mask(rs, 2, n) if masked else None
        got = pointops.knn(8, t(q), t(p), None if valid is None else t(valid))
        assert got.shape == (2, n, 8)
        assert_same(got, knn_pallas(8, j(q), j(p), True, points_valid=j(valid)))
        assert_same(got, jpo._knn_xla(8, j(q), j(p), j(valid)))

    def test_ties_prefer_lower_index(self):
        base = np.array([[[0.0, 0, 0], [1, 0, 0], [1, 0, 0], [2, 0, 0]]],
                        np.float32)
        p = np.tile(base, (1, 32, 1))  # 128 points, many exact ties
        got = neighbors.knn(8, t(p), t(p))
        assert_same(got, knn_pallas(8, j(p), j(p), True))
        assert_same(got, jpo._knn_xla(8, j(p), j(p)))

    def test_fewer_valid_points_than_k(self, rs):
        # invalid points sit at BIG and fill the tail in index order
        q, p = cloud(rs, 2, 128), cloud(rs, 2, 256)
        valid = np.arange(256)[None, :] < np.array([[5], [256]])
        got = neighbors.knn(8, t(q), t(p), t(valid))
        assert_same(got, knn_pallas(8, j(q), j(p), True, points_valid=j(valid)))

    @pytest.mark.parametrize("k", [1, 3, 16])
    def test_other_k(self, rs, k):
        q, p = cloud(rs, 1, 128), cloud(rs, 1, 128)
        assert_same(neighbors.knn(k, t(q), t(p)), jpo._knn_xla(k, j(q), j(p)))

    # past the warp-per-query kernel's k <= 64 (the card selects the k
    # nearest with a block per query): random clouds with holes and an
    # invalid tail (many keys at BIG), and planted ties (every point four
    # times, so distances tie at the k-th key)
    @pytest.mark.parametrize("case", ["masked", "ties"])
    @pytest.mark.parametrize("k", [65, 100, 128])
    def test_large_k(self, rs, k, case):
        if case == "masked":
            q, p = cloud(rs, 2, 128), cloud(rs, 2, 256)
            valid = valid_mask(rs, 2, 256)
        else:
            q = cloud(rs, 2, 128)
            p = np.tile(cloud(rs, 2, 48), (1, 4, 1))  # 192 points
            q[:, :48] = p[:, :48]
            valid = None
        got = neighbors.knn(k, t(q), t(p), None if valid is None else t(valid))
        assert got.shape == (2, 128, k)
        assert_same(got, jpo.knn(k, j(q), j(p), j(valid)))
        assert_same(got, jpo._knn_xla(k, j(q), j(p), j(valid)))

    def test_k_equals_n(self, rs):
        q, p = cloud(rs, 1, 128), cloud(rs, 1, 130)
        valid = valid_mask(rs, 1, 130)
        got = neighbors.knn(130, t(q), t(p), t(valid))
        assert_same(got, jpo.knn(130, j(q), j(p), j(valid)))

    def test_knn_with_dists(self, rs):
        q, p = cloud(rs, 2, 128), cloud(rs, 2, 256)
        valid = valid_mask(rs, 2, 256)
        d, idx = pointops.knn_with_dists(8, t(q), t(p), t(valid))
        jd, jidx = jpo.knn_with_dists(8, j(q), j(p), j(valid))
        assert_same(idx, jidx)
        assert_same(d, jd)


def bf16_exact(rs, shape):
    """float32 values with at most 15 significant bits, which the one-hot
    hi/lo bf16 gather of the JAX kernel reproduces exactly."""
    return (rs.randint(-2 ** 14, 2 ** 14, shape) / 64.0).astype(np.float32)


class TestGather:
    @pytest.mark.parametrize("c", [3, 32, 512])
    @pytest.mark.parametrize("n", SIZES)
    def test_group_points(self, rs, n, c):
        b, s, k = 2, 64, 8
        pts = rs.randn(b, n, c).astype(np.float32)
        idx = rs.randint(0, n, (b, s, k)).astype(np.int32)
        got = pointops.group_points(t(pts), t(idx))
        assert got.shape == (b, s, k, c)
        assert_same(got, jpo.group_points(j(pts), j(idx)))

    @pytest.mark.parametrize("c", [3, 32])
    def test_matches_pallas_gather(self, rs, c):
        b, n, s, k = 2, 256, 128, 4
        pts = bf16_exact(rs, (b, n, c))
        idx = rs.randint(0, n, (b, s, k)).astype(np.int32)
        idx[0, :4, 0] = [-1, n, n + 7, -100]  # outside [0, N): zero rows
        got = pointops.group_points(t(pts), t(idx))
        assert_same(got, mxu_group_points(j(pts), j(idx), True))
        assert (got[0, :4, 0].numpy() == 0).all()

    def test_gather_points(self, rs):
        pts = rs.randn(2, 128, 5).astype(np.float32)
        idx = rs.randint(0, 128, (2, 40)).astype(np.int32)
        assert_same(pointops.gather_points(t(pts), t(idx)),
                    jpo.gather_points(j(pts), j(idx)))


def jax_gather_grad(pts, idx, cot):
    """``jax.grad`` of ``sum(group_points(p, idx) * cot)`` through the Pallas
    gather in interpret mode, whose backward is ``_gather_bwd_kernel``."""
    return np.asarray(jax.grad(
        lambda p: jnp.sum(mxu_group_points(p, j(idx), True) * j(cot)))(j(pts)))


def port_gather_grad(pts, idx, cot):
    """The same through the port's autograd ``group_points``."""
    p = t(pts).requires_grad_(True)
    (pointops.group_points(p, t(idx)) * t(cot)).sum().backward()
    return p.grad


# (B, N, S, K, C): tests/test_fused.py's backward shapes (square and odd row
# counts, the propagation encoder's C=512) and the train step's widths
BWD_SHAPES = [(2, 64, 64, 8, 3), (2, 64, 64, 8, 32), (2, 64, 64, 8, 128),
              (2, 64, 37, 9, 7), (2, 40, 40, 5, 3), (1, 128, 128, 4, 512),
              (2, 64, 64, 32, 32)]


class TestGatherBackward:
    @pytest.mark.parametrize("shape", BWD_SHAPES)
    def test_matches_pallas_backward(self, rs, shape):
        b, n, s, k, c = shape
        pts = rs.randn(b, n, c).astype(np.float32)
        idx = rs.randint(0, n, (b, s, k)).astype(np.int32)
        idx[0, :3, 0] = [-1, n, n + 5]  # outside [0, N): contribute nothing
        exact = bf16_exact(rs, (b, s, k, c))
        got = port_gather_grad(pts, idx, exact)
        assert got.shape == (b, n, c)
        assert_same(got, jax_gather_grad(pts, idx, exact))
        cot = rs.randn(b, s, k, c).astype(np.float32)
        got = port_gather_grad(pts, idx, cot).numpy()
        want = jax_gather_grad(pts, idx, cot)
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())

    def test_plain_version(self, rs):
        """Rows outside [0, N) drop out; a row named by no index is zero;
        every row is the sum of its cotangent rows."""
        b, n, m, c = 2, 16, 200, 5
        g = t(rs.randn(b, m, c).astype(np.float32))
        idx = rs.randint(-3, n + 3, (b, m)).astype(np.int32)
        idx[:, idx[0] == 7] = 8  # nothing lands on row 7 of element 0
        idx[1, idx[1] == 7] = 8
        got = fused.gather_rows_backward(g, t(idx), n)
        want = np.zeros((b, n, c), np.float64)
        for bi in range(b):
            for mi in range(m):
                if 0 <= idx[bi, mi] < n:
                    want[bi, idx[bi, mi]] += g[bi, mi].double().numpy()
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
        assert (got[:, 7] == 0).all()

    def test_group_points_backward_matches_torch_gather(self, rs):
        b, n, s, k, c = 2, 50, 30, 6, 9
        pts = rs.randn(b, n, c).astype(np.float32)
        idx = rs.randint(0, n, (b, s, k)).astype(np.int32)
        cot = t(rs.randn(b, s, k, c).astype(np.float32))
        p1 = t(pts).requires_grad_(True)
        (pointops.group_points(p1, t(idx)) * cot).sum().backward()
        p2 = t(pts).requires_grad_(True)
        flat = t(idx).long().reshape(b, s * k, 1).expand(b, s * k, c)
        (torch.gather(p2, 1, flat).reshape(b, s, k, c) * cot).sum().backward()
        np.testing.assert_allclose(p1.grad.numpy(), p2.grad.numpy(),
                                   rtol=1e-6, atol=1e-6)
        # a stride-0 expanded cotangent (the gradient of a plain sum)
        p3 = t(pts).requires_grad_(True)
        pointops.gather_points(p3, t(idx[:, :, 0])).sum().backward()
        counts = np.zeros((b, n))
        for bi in range(b):
            np.add.at(counts[bi], idx[bi, :, 0], 1)
        np.testing.assert_array_equal(
            p3.grad.numpy(), np.repeat(counts[..., None], c, -1))

    def test_no_backward_without_grad(self, rs):
        """Gathers of tensors that need no gradient (the cost volume's xyz)
        record nothing, and the wrappers count no launch on the CPU."""
        before = (fused.gather_rows.launches,
                  fused.gather_rows_backward.launches)
        xyz = t(cloud(rs, 1, 64))
        w = torch.ones(3, requires_grad=True)
        idx = pointops.knn(8, xyz, xyz)
        grouped = pointops.group_points(xyz, idx)
        assert grouped.grad_fn is None
        (pointops.group_points(xyz * w, idx).sum()).backward()
        assert w.grad is not None
        assert (fused.gather_rows.launches,
                fused.gather_rows_backward.launches) == before


class TestWrappers:
    def test_cpu_runs_plain_versions_without_launches(self, rs):
        before = (neighbors.ball_query_multi.launches, neighbors.knn.launches,
                  fused.gather_rows.launches)
        p = t(cloud(rs, 1, 128))
        idx = pointops.ball_query(4.0, 8, p, p)
        pointops.group_points(p, idx)
        pointops.knn(8, p, p)
        assert (neighbors.ball_query_multi.launches, neighbors.knn.launches,
                fused.gather_rows.launches) == before
        assert_same(idx, neighbors.ball_query_multi_plain(
            (4.0,), (8,), p, p)[0].numpy())

    def test_rejects_bad_inputs(self, rs):
        p = t(cloud(rs, 1, 128))
        with pytest.raises(TypeError):
            fused.gather_rows(p, torch.zeros((1, 4), dtype=torch.int64))
        with pytest.raises(TypeError):
            neighbors.knn(8, p.double(), p.double())
        g = torch.zeros((1, 4, 3))
        with pytest.raises(TypeError):
            fused.gather_rows_backward(g, torch.zeros((1, 4), dtype=torch.int64),
                                       8)
        with pytest.raises(ValueError):
            fused.gather_rows_backward(g, torch.zeros((1, 5), dtype=torch.int32),
                                       8)
        # five radii are taken (one launch per four on the card) and equal
        # JAX's; no radius at all, or a K per radius missing, is refused
        got = neighbors.ball_query_multi((1.0,) * 5, (4,) * 5, p, p)
        want = jax_ball_query_multi((1.0,) * 5, (4,) * 5, j(p.numpy()),
                                    j(p.numpy()), True)
        assert len(got) == 5
        for g, w in zip(got, want):
            assert_same(g, w)
        with pytest.raises(ValueError):
            neighbors.ball_query_multi((), (), p, p)
        with pytest.raises(ValueError):
            neighbors.ball_query_multi((1.0,) * 5, (4,) * 4, p, p)
        with pytest.raises(ValueError):
            neighbors.knn(129, p, p)  # k > N, as lax.top_k refuses
        with pytest.raises(ValueError):
            neighbors.knn(0, p, p)
        with pytest.raises(ValueError):
            neighbors.knn(8, p[:, :, :2], p[:, :, :2])
        with pytest.raises(ValueError):
            neighbors.knn(8, p.to("meta"), p.to("meta"))
