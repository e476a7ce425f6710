"""The fused serving kernels and the row gather, each beside its plain
PyTorch version, and the parameter packers of the fused engine.

Counterpart of ``cmflow_tpu/ops/fused.py``:

* :func:`gather_rows`: ``mxu_gather_rows`` / ``mxu_group_points`` forward
  (K6, ``csrc/gather.cu``), float32 or bfloat16 points, an exact copy of
  each row in either;
* :func:`gather_rows_backward`: ``_gather_bwd_kernel``, the backward of
  ``mxu_group_points`` (K7, ``csrc/gather.cu``: a CSR build by a
  thread-block cluster per batch element, :func:`gather_rows_csr`, then a
  sum over fixed pieces of the sorted indices); a bfloat16 cotangent is
  summed in float32 and rounded to bfloat16 once, as ``_mxu_gather_bwd``'s
  float32 result cast to the points' dtype;
* :func:`fused_multi_scale_encoder`: ``_mse_kernel`` (K3, ``csrc/mse.cu``);
* :func:`fused_point_local_feature`: ``_plf_kernel`` (K5, ``csrc/plf.cu``);
* :func:`fused_cost_volume`: ``_cv_kernel`` then ``_cv_agg_kernel``, here
  :func:`cost_volume_p2p` and :func:`cost_volume_agg` (K4a, K4b,
  ``csrc/cost_volume.cu``).

Each wrapper sends a CUDA tensor to its kernel and a CPU tensor to its plain
version (``*_plain``), which gathers with ``torch.gather``, runs the chain
with ``torch.matmul`` and the folded affines, and reduces with ``amax`` or
``sum``.  An index outside ``[0, N)`` gathers a zero row, as the JAX
package's one-hot gather does.

What the JAX kernels do only for the TPU is not ported: the one-hot MXU
gathers with their hi/lo bf16 splits, the k-major index layouts and the
stacked block-diagonal scale packing.  Here a gather is a load.  The algebra
is: BatchNorm running statistics fold into per-channel affines
(:func:`fold_bn_affine`), and the first grouped layer folds its offset term
into the gathered base (``gather(f) + (xyz[idx] - xyz_t) @ W ==
gather(f + xyz @ W) - xyz_t @ W``).

The packers read the port's modules (``nn/blocks.py``), which
``models/convert.py`` fills from flax variables.  Dense kernels come out
``[in, out]``, as the flax trees hold them.

Each of K3, K4a, K4b and K5 takes any K and, on the card, picks its kernel
by shape alone (:func:`mse_arm`, :func:`plf_arm`, :func:`cv_p2p_arm`,
:func:`cv_agg_arm`): the tuned kernel at the widths it is written for
(``MSE_WIDTHS``, ``PLF_WIDTHS``, ``CV_WIDTH``), else the generic kernel
(``csrc/chain.cu``: a grouped chain of any widths and depth, max or
WeightNet-weighted sum over K; its products on the tensor cores in 3xTF32
or bf16, with weights packed per call by :func:`chain_tc_weights` and a
launch planned from the shapes by :func:`chain_tc_plan`; a chain with no
product in float32 FMAs), whose every launch :func:`_chain` counts in its
wrapper's ``launches`` and ``launches_generic`` (K3's generic arm launches
once a scale).  K4b, which has no product, runs its tuned design at every
C (``csrc/cost_volume.cu::cv_agg_any_kernel``, in chunks of the row
planned by :func:`cv_agg_plan`), counted the same way; float32 K4a at a K
whose whole queries leave an eighth or more of a 64-row tile empty
(:func:`cv_p2p_full`), and the bf16 arms of K4a and K5 at every K, run
full tiles across query boundaries, one block an SM (:func:`cv_p2p_plan`,
:func:`plf_plan`), counted also in ``launches_full`` (K4a's bf16 ones
also in ``launches_full_bf16``).  The only shapes that raise are those
the JAX package does not take either: a WeightNet whose hidden width is
not 8, and a narrow sa mlp that is not 3 layers.

K3, K4a and K5 each have two arms, picked by the dtype of their operands:
the gathered bases (K3, K5), ``f1c``/``f2c`` (K4a), the point-to-patch cost
(K4b) and the Dense weights.
* float32: the products run on the tensor cores in 3xTF32
  (``csrc/tc_gemm.cuh``).  The K4a and K5 wrappers split the weights into
  TF32 hi and lo parts and lay them out for the kernels on every call
  (:func:`tc_weights`); the K3 wrapper lays its weights out in float32
  (:func:`mse_tc_weights`) and the kernel splits them.
* bfloat16 (the JAX package's bf16 serving mode, ``compute_dtype``
  bfloat16): the bases, ``f1c``/``f2c``, the point-to-patch cost and the
  Dense weights come in bfloat16, every product takes bf16 operands in one
  tensor-core pass and sums in float32, the activations are rounded to bf16
  before each product, and the affines, offsets and WeightNets stay float32
  (:func:`tc_weights_bf16`; K3's bf16 arm reads its weights where they lie
  and forms its bf16 base itself).  K4a writes its
  point-to-patch cost in bf16; every other output is float32.  The plain
  versions round with ``.to(torch.bfloat16)`` and multiply the rounded
  values in float32 (:func:`_mm`), so they differ from the JAX kernels only
  in the order of their float32 sums.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from cmflow_tpu_torch.native import build

Tensor = torch.Tensor

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_SIGNATURES = {
    "gather": {**{name: (_P, _P, _P, _I, _I, _I, _I, _I, _P)
                  for name in ("cmflow_gather_rows",
                               "cmflow_gather_rows_bf16")},
               "cmflow_gather_rows_csr_scratch": (_I, _I),
               "cmflow_gather_rows_csr": (_P, _P, _P, _P, _I, _I, _I, _P),
               "cmflow_gather_rows_backward_slices": (_I,),
               **{name: (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                         _P)
                  for name in ("cmflow_gather_rows_backward",
                               "cmflow_gather_rows_backward_bf16")}},
    "mse": {"cmflow_mse": (_P, _P, _L, _L, _L, _I, _P,
                           ctypes.POINTER(ctypes.c_void_p),
                           ctypes.POINTER(ctypes.c_int), _I,
                           ctypes.POINTER(ctypes.c_int), _I, _P, _P, _I, _I,
                           _P),
            "cmflow_mse_bf16": (_P, _P, _L, _L, _L, _I, _P,
                                ctypes.POINTER(ctypes.c_void_p),
                                ctypes.POINTER(ctypes.c_int), _I,
                                ctypes.POINTER(ctypes.c_int), _I,
                                ctypes.POINTER(ctypes.c_void_p),
                                ctypes.POINTER(ctypes.c_void_p), _P, _P, _P,
                                _P, _P, _P, _P, _P, _P, _I, _I, _P),
            "cmflow_mse_long_static_smem": (_I, _I),
            "cmflow_mse_long_occupancy": (_I, _I, _I)},
    "plf": {"cmflow_plf": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                           _I, _I, _I, _I, _P),
            "cmflow_plf_bf16": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                _P, _I, _I, _I, _I, _I, _I, _P)},
    "cost_volume": {
        "cmflow_cv_p2p": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                          _P, _P, _P, _I, _I, _I, _I, _P),
        "cmflow_cv_p2p_full": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                               _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
        "cmflow_cv_p2p_bf16": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                               _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
        "cmflow_cv_p2p_bf16_slots": (),
        **{name: (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P)
           for name in ("cmflow_cv_agg", "cmflow_cv_agg_bf16")},
        "cmflow_cv_agg_any": (_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                              _I, _I, _I, _I, _I, _P),
    },
    "chain": {
        "cmflow_chain": (_I, _P, _I, _I, _I, _P, _L, _P, _P, _P, _P, _I, _P,
                         _L, _P),
        "cmflow_chain_tc": (_I, _I, ctypes.POINTER(ctypes.c_longlong), _P,
                            _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _P),
        "cmflow_chain_tc_static_smem": (_I, _I),
        "cmflow_chain_tc_occupancy": (_I, _I, _I),
    },
}

# widths the tuned CUDA kernels are written for (the CMFlow sa encoder, the
# propagation encoder and the cost volume); every other width takes the
# generic kernel (csrc/chain.cu), and the plain versions take any
MSE_WIDTHS = (32, 32, 64)
MSE_MAX_SCALES = 8
MSE_MAX_FEATS = 5  # the sa encoder's first layer: 3 + Cf inputs, at most 8
PLF_WIDTHS = (512, 256, 64)
CV_WIDTH = 512
WEIGHTNET_HIDDEN = 8  # fixed in the JAX package too (its zpk operand)


# ---------------------------------------------------------------------------
# shared checks
# ---------------------------------------------------------------------------

def _stream(t: Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _on_card(what: str, floats: Sequence[Tensor],
             ints: Sequence[Tensor] = (),
             operands: Sequence[Tensor] = ()) -> bool:
    """Check dtypes and devices; True for CUDA tensors (the kernel), False
    for CPU tensors (the plain version).  ``floats`` are float32;
    ``operands``, the tensors a bf16 arm takes in bfloat16, are all float32
    or all bfloat16."""
    tensors = (*floats, *operands)
    dev = tensors[0].device
    for t in floats:
        if t.dtype != torch.float32:
            raise TypeError(f"{what}: need float32 tensors, got {t.dtype}")
    kinds = {t.dtype for t in operands}
    if len(kinds) > 1 or not kinds <= {torch.float32, torch.bfloat16}:
        raise TypeError(f"{what}: need its bases, features and Dense "
                        f"weights all float32 or all bfloat16, got "
                        f"{sorted(map(str, kinds))}")
    for t in ints:
        if t.dtype != torch.int32:
            raise TypeError(f"{what}: need int32 indices, got {t.dtype}")
    if any(t.device != dev for t in (*tensors, *ints)):
        raise ValueError(f"{what}: every tensor must share one device")
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"{what}: unsupported device {dev}")
    return True


def _check_kernel_args(what: str, tensors: Sequence[Tensor]) -> None:
    """The tensors a kernel reads by pointer: contiguous, and 16-byte
    aligned (the kernels read float4s)."""
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{what}: the CUDA kernel takes contiguous tensors")
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{what}: the CUDA kernel needs 16-byte aligned "
                         f"tensors")


def _aligned(t: Tensor) -> Tensor:
    """``t`` contiguous and 16-byte aligned, copied where it is not."""
    t = t.contiguous()
    return t.clone() if t.data_ptr() % 16 else t


def _group(points: Tensor, idx: Tensor) -> Tensor:
    """``[B, N, C]`` by ``[B, S, K]`` -> ``[B, S, K, C]``, plain."""
    b, s, k = idx.shape
    return gather_rows_plain(points, idx.reshape(b, s * k)).reshape(
        b, s, k, points.shape[-1])


def _relu_affine(x: Tensor, s: Tensor, b: Tensor) -> Tensor:
    return torch.relu(x * s + b)


def _leaky(x: Tensor) -> Tensor:
    return torch.where(x > 0, x, 0.1 * x)


def _mm(x: Tensor, w: Tensor) -> Tensor:
    """``x @ w`` as the kernels' arm of ``w`` multiplies: for a bfloat16
    ``w``, ``x`` rounded to bf16 and both multiplied in float32 (each
    product exact, the sum in float32), the JAX kernels'
    ``dot(x.astype(w.dtype), w, preferred_element_type=float32)``."""
    if w.dtype == torch.bfloat16:
        return x.to(torch.bfloat16).float() @ w.float()
    return x @ w


# ---------------------------------------------------------------------------
# K6: row gather
# ---------------------------------------------------------------------------

_GATHER_DTYPES = (torch.float32, torch.bfloat16)


def gather_rows_plain(points: Tensor, idx: Tensor) -> Tensor:
    """Plain version of :func:`gather_rows`, in the points' dtype."""
    b, n, c = points.shape
    m = idx.shape[1]
    inside = (idx >= 0) & (idx < n)
    safe = torch.where(inside, idx, 0).long()
    rows = torch.gather(points, 1, safe[..., None].expand(b, m, c))
    return torch.where(inside[..., None], rows, 0.0)


def gather_rows(points: Tensor, idx: Tensor) -> Tensor:
    """``out[b, m] = points[b, idx[b, m]]``.

    Args:
      points: ``[B, N, C]`` float32 or bfloat16.
      idx: ``[B, M]`` int32; an index outside ``[0, N)`` gives a zero row.
    Returns:
      ``[B, M, C]`` in the points' dtype, each row an exact copy.
    """
    if points.dim() != 3 or idx.dim() != 2 or idx.shape[0] != points.shape[0]:
        raise ValueError(f"need points [B, N, C] and idx [B, M], got "
                         f"{tuple(points.shape)} and {tuple(idx.shape)}")
    if points.dtype not in _GATHER_DTYPES or idx.dtype != torch.int32:
        raise TypeError(f"need float32 or bfloat16 points and int32 idx, "
                        f"got {points.dtype} and {idx.dtype}")
    if idx.device != points.device:
        raise ValueError("points and idx must share a device")
    if points.device.type == "cpu":
        return gather_rows_plain(points, idx)
    if points.device.type != "cuda":
        raise ValueError(f"unsupported device {points.device}")
    if not (points.is_contiguous() and idx.is_contiguous()):
        raise ValueError("the CUDA kernel takes contiguous tensors")
    b, n, c = points.shape
    m = idx.shape[1]
    out = torch.empty((b, m, c), dtype=points.dtype, device=points.device)
    # the widest aligned vector that divides a row: 16 bytes, four float32
    # or eight bf16
    bf16 = points.dtype == torch.bfloat16
    vec = (c % (8 if bf16 else 4) == 0 and points.data_ptr() % 16 == 0
           and out.data_ptr() % 16 == 0)
    lib = build.load("gather", _SIGNATURES["gather"])
    launch = lib.cmflow_gather_rows_bf16 if bf16 else lib.cmflow_gather_rows
    code = launch(points.data_ptr(), idx.data_ptr(), out.data_ptr(), b, n, m,
                  c, int(vec), _stream(points))
    build.check(lib, code, "gather_rows")
    gather_rows.launches += 1
    gather_rows.launches_bf16 += bf16
    return out


# every launch, and those of the bf16 arm
gather_rows.launches = 0
gather_rows.launches_bf16 = 0


# ---------------------------------------------------------------------------
# K7: the row gather's backward
# ---------------------------------------------------------------------------

# sorted entries per warp of K7's sum kernel (``csrc/gather.cu::kPiece``)
GATHER_BWD_PIECE = 32


def gather_rows_backward_plain(g: Tensor, idx: Tensor, n: int) -> Tensor:
    """Plain version of :func:`gather_rows_backward`: one float32
    ``index_add_`` over the flattened batch, which on the CPU adds the rows
    in ascending ``m``, then one cast to ``g``'s dtype (none for float32)."""
    b, m, c = g.shape
    inside = (idx >= 0) & (idx < n)
    base = n * torch.arange(b, device=idx.device)[:, None]
    out = torch.zeros((b * n, c), dtype=torch.float32, device=g.device)
    out.index_add_(0, (idx.long() + base)[inside], g[inside].float())
    return out.to(g.dtype).view(b, n, c)


def gather_rows_csr_plain(idx: Tensor, n: int) -> Tuple[Tensor, Tensor]:
    """Plain version of :func:`gather_rows_csr`: a stable sort of each
    element's bins (the row, or ``n`` outside ``[0, n)``) and their counts'
    prefix sums."""
    b, m = idx.shape
    key = torch.where((idx >= 0) & (idx < n), idx.long(), n)
    order = torch.sort(key, dim=-1, stable=True).indices.to(torch.int32)
    counts = torch.zeros((b, n + 1), dtype=torch.long, device=idx.device)
    counts.scatter_add_(1, key, torch.ones_like(key))
    offsets = torch.zeros((b, n + 1), dtype=torch.int32, device=idx.device)
    offsets[:, 1:] = counts[:, :n].cumsum(-1)
    return offsets, order


def _csr_scratch(lib, what: str, idx: Tensor, n: int) -> Tensor:
    """The CSR build's device scratch for its counts: ``[B, S]`` int32, S
    from the library (0 where they fit in shared memory)."""
    if not idx.is_contiguous():
        raise ValueError(f"{what}: the CUDA kernel takes contiguous tensors")
    b, m = idx.shape
    ints = lib.cmflow_gather_rows_csr_scratch(n, m)
    if ints < 0:
        raise ValueError(f"{what}: N={n}, M={m} needs more scratch than the "
                         f"CSR build indexes")
    return torch.empty((b, ints), dtype=torch.int32, device=idx.device)


def gather_rows_csr(idx: Tensor, n: int) -> Tuple[Tensor, Tensor]:
    """The indices of :func:`gather_rows_backward` sorted by row: K7's first
    kernel on its own.

    Args:
      idx: ``[B, M]`` int32.
      n: ``N``, the number of rows.
    Returns:
      ``offsets [B, N+1]`` int32: row ``r``'s entries are the sorted
      positions ``offsets[b, r] .. offsets[b, r+1] - 1``, and ``offsets[b,
      N]`` counts the indices inside ``[0, N)``; ``order [B, M]`` int32: the
      ``m`` at each sorted position, ascending ``m`` within a row, the
      indices outside ``[0, N)`` last.
    """
    if idx.dim() != 2 or n < 1:
        raise ValueError(f"need idx [B, M] and n >= 1, got "
                         f"{tuple(idx.shape)} and {n}")
    if idx.dtype != torch.int32:
        raise TypeError(f"gather_rows_csr: need int32 indices, got "
                        f"{idx.dtype}")
    if idx.device.type == "cpu":
        return gather_rows_csr_plain(idx, n)
    if idx.device.type != "cuda":
        raise ValueError(f"gather_rows_csr: unsupported device {idx.device}")
    lib = build.load("gather", _SIGNATURES["gather"])
    scratch = _csr_scratch(lib, "gather_rows_csr", idx, n)
    b, m = idx.shape
    offsets = torch.empty((b, n + 1), dtype=torch.int32, device=idx.device)
    order = torch.empty((b, m), dtype=torch.int32, device=idx.device)
    code = lib.cmflow_gather_rows_csr(
        idx.data_ptr(), offsets.data_ptr(), order.data_ptr(),
        scratch.data_ptr(), b, n, m, _stream(idx))
    build.check(lib, code, "gather_rows_csr")
    return offsets, order


def gather_rows_backward(g: Tensor, idx: Tensor, n: int) -> Tensor:
    """The transpose of :func:`gather_rows`:
    ``out[b, j] = sum of g[b, m] over every m with idx[b, m] == j``.

    Deterministic on the card: the indices are sorted by row (stable in
    ``m``, :func:`gather_rows_csr`, which also zeroes the rows no index
    names), each warp sums 32 sorted entries in a fixed order, and a row
    that spans several warps is added from their parts in order by the warp
    that finishes last (an atomic ticket picks that warp; no atomic adds).
    Two launches, no sync with the host.

    A bfloat16 cotangent takes the same sums in float32 (each bf16 term
    exact, the float32 arm's order) and rounds each row to bf16 once.

    Args:
      g: ``[B, M, C]`` float32 or bfloat16 cotangent rows, any ``C`` (a
        piece's rows are summed by one warp per 64 elements of the load
        type, each column in the same order whatever the width).
      idx: ``[B, M]`` int32; an index outside ``[0, N)`` contributes nothing.
      n: ``N``, the number of rows of the gathered tensor.
    Returns:
      ``[B, N, C]`` in ``g``'s dtype.
    """
    if g.dim() != 3 or idx.shape != g.shape[:2] or n < 1:
        raise ValueError(f"need g [B, M, C], idx [B, M] and n >= 1, got "
                         f"{tuple(g.shape)}, {tuple(idx.shape)} and {n}")
    if g.dtype not in _GATHER_DTYPES:
        raise TypeError(f"gather_rows_backward: need a float32 or bfloat16 "
                        f"cotangent, got {g.dtype}")
    if not _on_card("gather_rows_backward", (), (idx,), (g,)):
        return gather_rows_backward_plain(g, idx, n)
    b, m, c = g.shape
    bf16 = g.dtype == torch.bfloat16
    lanes = 8 if bf16 else 4  # elements of the 16-byte load
    vec = c % lanes == 0 and g.data_ptr() % 16 == 0
    if not g.is_contiguous():
        raise ValueError("gather_rows_backward: the CUDA kernel takes "
                         "contiguous tensors")
    lib = build.load("gather", _SIGNATURES["gather"])
    scratch = _csr_scratch(lib, "gather_rows_backward", idx, n)
    dev = g.device
    out = torch.empty((b, n, c), dtype=g.dtype, device=dev)
    offsets = torch.empty((b, n + 1), dtype=torch.int32, device=dev)
    order = torch.empty((b, m), dtype=torch.int32, device=dev)
    pieces = -(-m // GATHER_BWD_PIECE)
    # the partial sums stay float32 in both arms
    part = torch.empty((b, max(pieces, 1), 2, c), dtype=torch.float32,
                       device=dev)
    # the sum kernel's tickets per row; the CSR build zeroes them
    slices = lib.cmflow_gather_rows_backward_slices(c // lanes if vec else c)
    tickets = torch.empty((b, n, slices), dtype=torch.int32, device=dev)
    launch = (lib.cmflow_gather_rows_backward_bf16 if bf16
              else lib.cmflow_gather_rows_backward)
    code = launch(g.data_ptr(), idx.data_ptr(), offsets.data_ptr(),
                  order.data_ptr(), scratch.data_ptr(), part.data_ptr(),
                  tickets.data_ptr(), out.data_ptr(), b, n, m, c, int(vec),
                  _stream(g))
    build.check(lib, code, "gather_rows_backward")
    gather_rows_backward.launches += 1
    gather_rows_backward.launches_bf16 += bf16
    return out


# every launch, and those of the bf16 arm
gather_rows_backward.launches = 0
gather_rows_backward.launches_bf16 = 0


# ---------------------------------------------------------------------------
# parameter packers
# ---------------------------------------------------------------------------

def _kernel(linear) -> Tensor:
    """A ``Linear``'s weight as the flax kernel ``[in, out]``."""
    return linear.weight.t().contiguous()


def fold_bn_affine(bn) -> Tuple[Tensor, Tensor]:
    """Eval-mode BatchNorm as a per-channel ``(scale, bias)``:
    ``s = gamma * rsqrt(var + eps)``, ``b = beta - mean * s``."""
    s = bn.weight * torch.rsqrt(bn.running_var + bn.eps)
    return s, bn.bias - bn.running_mean * s


def plf_params_from_variables(plf) -> Tuple[Tuple[Tensor, ...], Tensor,
                                            List[Tuple[Tensor, ...]]]:
    """One ``PointLocalFeature`` scale as ``(chain, feat_w, mlp2)``.

    ``chain = (wrel, s0, b0, w1, s1, b1, ...)`` feeds
    :func:`fused_point_local_feature`; ``feat_w = w0[3:]`` is the per-point
    feature transform; ``mlp2`` is ``[(w, s, b), ...]`` for the per-point
    tail."""
    chain = [plf.w0[:3].contiguous(), *fold_bn_affine(plf.bn0)]
    if plf.mlp is not None:
        for i in range(plf.mlp.depth):
            chain.append(_kernel(getattr(plf.mlp, f"dense_{i}")))
            chain += fold_bn_affine(getattr(plf.mlp, f"bn_{i}"))
    mlp2 = [(_kernel(getattr(plf.mlp2, f"dense_{i}")),
             *fold_bn_affine(getattr(plf.mlp2, f"bn_{i}")))
            for i in range(plf.mlp2.depth)]
    return tuple(chain), plf.w0[3:], mlp2


def mse_narrow_params_from_variables(mse, dtype: torch.dtype = torch.float32
                                     ) -> Tuple[tuple, list]:
    """A narrow ``MultiScaleEncoder`` (3-layer sa mlp) for
    :func:`fused_multi_scale_encoder`, its stacked ``w1``/``w2`` in
    ``dtype`` (the kernel's arm; everything else float32).

    Returns ``(packed, mlp2_bd)``: ``packed = (w0rel tuple, w0feat tuple,
    s0, b0, w1 [S, C1, C2], s1, b1, w2 [S, C2, C3], s2, b2)`` with the
    affines concatenated over scales, and ``mlp2_bd = [(w, s, b), ...]``
    with block-diagonal ``w``, so the per-point tail runs all scales in one
    product per layer.  The JAX package packs ``w1``/``w2`` block-diagonally
    too, for its MXU; the CUDA kernel runs each scale on its own, so they
    are stacked here (the JAX blocks are their diagonal blocks)."""
    parts = [[] for _ in range(10)]
    mlp2_layers = None
    for i in range(mse.scales):
        chain, feat_w, mlp2 = plf_params_from_variables(
            getattr(mse, f"scale_{i}"))
        if len(chain) != 9:
            raise ValueError("the narrow path expects a 3-layer sa mlp")
        for slot, p in zip(parts, (chain[0], feat_w) + chain[1:]):
            slot.append(p)
        if mlp2_layers is None:
            mlp2_layers = [[] for _ in mlp2]
        for layer, wsb in zip(mlp2_layers, mlp2):
            layer.append(wsb)
    w0rel, w0feat, s0, b0, w1, s1, b1, w2, s2, b2 = parts
    packed = (tuple(w0rel), tuple(w0feat), torch.cat(s0), torch.cat(b0),
              torch.stack(w1).to(dtype), torch.cat(s1), torch.cat(b1),
              torch.stack(w2).to(dtype), torch.cat(s2), torch.cat(b2))
    mlp2_bd = [(torch.block_diag(*[w for w, _, _ in layer]),
                torch.cat([s for _, s, _ in layer]),
                torch.cat([b for _, _, b in layer]))
               for layer in mlp2_layers]
    return packed, mlp2_bd


def cv_params_from_variables(fc) -> Tuple[tuple, tuple, tuple]:
    """A ``FeatureCorrelator`` as ``(dense, wn1, wn2)``:
    ``dense = (wd, b0, w1, b1, w2, b2)``, the offset block of the first
    layer and the two LeakyReLU layers; ``wn1``/``wn2 = (w0, b0, w1, b1,
    w2, b2)``, the WeightNets."""
    d_off = fc.w0.shape[0] - 3
    dense = (fc.w0[d_off:].contiguous(), fc.b0,
             _kernel(fc.mlp.dense_0), fc.mlp.dense_0.bias,
             _kernel(fc.mlp.dense_1), fc.mlp.dense_1.bias)

    def wn(q):
        return tuple(t for i in range(3)
                     for t in (_kernel(getattr(q, f"dense_{i}")),
                               getattr(q, f"dense_{i}").bias))

    return dense, wn(fc.weightnet1), wn(fc.weightnet2)


# ---------------------------------------------------------------------------
# weights for the tensor-core kernels (K4a, K5)
# ---------------------------------------------------------------------------

def tf32_split(x: Tensor) -> Tuple[Tensor, Tensor]:
    """``x = hi + lo`` to about 2^-22 of ``|x|``: ``hi`` is ``x`` rounded to
    TF32 (10 mantissa bits), to nearest with ties away from zero, as
    ``cvt.rna.tf32.f32`` rounds; ``lo`` is the rest, rounded the same way.
    Both are float32 with the 13 low mantissa bits zero.  (For finite ``x``:
    adding half a TF32 unit to the bits and clearing the low 13 carries into
    the exponent where it must.)"""

    def rna(v: Tensor) -> Tensor:
        bits = v.contiguous().view(torch.int32)
        return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)

    hi = rna(x)
    return hi, rna(x - hi)


def _tc_operand(w: Tensor, from_rows: bool) -> Tensor:
    """A dense kernel ``w [cin, cout]`` as the B operand of the wgmma
    kernels, ``[cin / 8, cout * 8]``: per k8 step one tile in the layout of
    ``csrc/tc_gemm.cuh`` (element ``(n, p)`` at
    ``((n // 8 * 2 + p // 4) * 8 + n % 8) * 4 + p % 4``).  The rows follow
    the kernels' K order: with ``from_rows``, step ``2q + e`` position ``p``
    is channel ``16q + 4*(p%4) + 2e + p//4`` (A made from a float4 of a
    gathered row); otherwise step ``s`` position ``p`` is channel
    ``8s + 2*(p%4) + p//4`` (A taken from a previous product's
    accumulator)."""
    cin, cout = w.shape
    if from_rows:  # (q, i, e, h, ng, r) -> (q, e, ng, h, r, i)
        v = w.reshape(cin // 16, 4, 2, 2, cout // 8, 8).permute(
            0, 2, 4, 3, 5, 1)
    else:  # (s, i, h, ng, r) -> (s, ng, h, r, i)
        v = w.reshape(cin // 8, 4, 2, cout // 8, 8).permute(0, 3, 2, 4, 1)
    return v.reshape(cin // 8, cout * 8)


def tc_weights(w1: Tensor, w2: Tensor) -> Tensor:
    """Two chained products as the one array that K5 (``csrc/plf.cu``, w1
    ``[512, 256]``, w2 ``[256, 64]``) and K4a (``csrc/cost_volume.cu``, both
    ``[512, 512]``) stream in order: the TF32 hi parts (:func:`tf32_split`)
    of ``w1``, whose A is made from gathered rows, and of ``w2``, whose A
    is the first product (:func:`_tc_operand`), then their lo parts in the
    same order."""
    hi, lo = tf32_split(torch.cat((_tc_operand(w1, True).flatten(),
                                   _tc_operand(w2, False).flatten())))
    return torch.cat((hi, lo))


def _tc_operand_bf16(w: Tensor, from_rows: bool = False) -> Tensor:
    """A bfloat16 dense kernel ``w [cin, cout]`` as the B operand of the
    bf16 wgmma kernels, ``[cin / 16, cout * 16]``: per k16 step ``s`` one
    tile in the layout of ``csrc/tc_gemm.cuh``, element ``(n, p)`` at
    ``((n // 8 * 2 + p // 8) * 8 + n % 8) * 8 + p % 8``.  Position ``p`` is
    channel ``16s + p`` (A from shared memory, or from a previous product's
    accumulator), or with ``from_rows`` channel ``16s + 4*(p%8//2) +
    2*(p//8) + p%2`` (A made in registers from four consecutive channels of
    a gathered row)."""
    cin, cout = w.shape
    if from_rows:  # (s, t, h, u, ng, r) -> (s, ng, h, r, t, u)
        v = w.reshape(cin // 16, 4, 2, 2, cout // 8, 8).permute(
            0, 4, 2, 5, 1, 3)
    else:  # (s, h, i, ng, r) -> (s, ng, h, r, i)
        v = w.reshape(cin // 16, 2, 8, cout // 8, 8).permute(0, 3, 1, 4, 2)
    return v.reshape(cin // 16, cout * 16)


def tc_weights_bf16(w1: Tensor, w2: Tensor, from_rows: bool = False
                    ) -> Tensor:
    """The bf16 arms' :func:`tc_weights`: two chained bfloat16 products as
    the one bf16 array that K5 (``from_rows``: its first product's A is made
    from gathered rows in registers) and K4a (A from shared memory) stream
    in order, ``w1`` then ``w2`` (in natural order: its A is the first
    product), one pass each (:func:`_tc_operand_bf16`)."""
    return torch.cat((_tc_operand_bf16(w1, from_rows).flatten(),
                      _tc_operand_bf16(w2).flatten()))


# K3's B fragments per scale (csrc/mse.cu): (k8 steps, n8 tiles) of its
# three products, and floats per scale of the packed image (a pair per
# fragment slot, then the six affines)
MSE_PRODUCTS = ((1, 4), (4, 4), (4, 8))
MSE_IMAGE = 2 * 32 * sum(s * t for s, t in MSE_PRODUCTS) + 2 * (
    MSE_WIDTHS[0] + MSE_WIDTHS[1] + MSE_WIDTHS[2])
_MSE_INDEX: Dict[tuple, Tuple[Tensor, Tensor]] = {}


def _mse_fragment_channels(product: int) -> np.ndarray:
    """``[steps, tiles, 32, 3]``: for each mma.sync B fragment slot of
    ``product`` (0, 1, 2) in K3, the input channels of its two values
    ``b0``, ``b1`` and their output column.  Lane ``(g, t)`` holds
    ``(k = t, n = g)`` and ``(k = t + 4, n = g)`` of each tile; position
    ``p`` of step ``j`` is input channel ``p`` in the first product (its
    input row gathered as it lies), and channel ``8j + 2(p%4) + p//4`` in the
    others, whose A is the previous product's accumulator."""
    steps, tiles = MSE_PRODUCTS[product]
    j, nt, lane = np.meshgrid(np.arange(steps), np.arange(tiles),
                              np.arange(32), indexing="ij")
    g, t = lane // 4, lane % 4
    if product == 0:
        k0, k1 = t, t + 4
    else:
        k0, k1 = 8 * j + 2 * t, 8 * j + 2 * t + 1
    return np.stack([k0, k1, 8 * nt + g], axis=-1)


def _mse_image_index(s_cnt: int, cf: int) -> np.ndarray:
    """``[S, MSE_IMAGE]`` positions in the flat concatenation of
    :func:`mse_tc_weights` (its last element is a zero)."""
    c1, c2, c3 = MSE_WIDTHS
    off_feat = 3 * c1 * s_cnt
    off_w1 = off_feat + cf * c1 * s_cnt
    off_w2 = off_w1 + s_cnt * c1 * c2
    off_aff = off_w2 + s_cnt * c2 * c3
    zero = off_aff + 2 * s_cnt * (c1 + c2 + c3)
    out = np.empty((s_cnt, MSE_IMAGE), np.int64)
    for s in range(s_cnt):
        slots = []
        ch = _mse_fragment_channels(0).reshape(-1, 3)
        k, col = ch[:, :2], ch[:, 2:]
        slots.append(np.where(
            k < 3, s * 3 * c1 + k * c1 + col,
            np.where(k < 3 + cf, off_feat + s * cf * c1 + (k - 3) * c1 + col,
                     zero)))
        for product, (off, cin, cout) in ((1, (off_w1, c1, c2)),
                                          (2, (off_w2, c2, c3))):
            ch = _mse_fragment_channels(product).reshape(-1, 3)
            slots.append(off + s * cin * cout + ch[:, :2] * cout + ch[:, 2:])
        aff = []
        at = off_aff
        for width in (c1, c1, c2, c2, c3, c3):  # s0, b0, s1, b1, s2, b2
            aff.append(at + s * width + np.arange(width))
            at += s_cnt * width
        out[s] = np.concatenate([x.reshape(-1) for x in slots] + aff)
    return out


def mse_tc_weights(packed: tuple) -> Tensor:
    """The weights of every scale of K3 (``csrc/mse.cu``) as one float32
    ``[S, MSE_IMAGE]`` image: per scale, the ``(b0, b1)`` pair of each
    mma.sync B fragment slot of its three products (first layer ``[w0r_s;
    w0f_s]`` zero-padded to 8 rows, then ``w1_s``, then ``w2_s``; slot order
    and channels by :func:`_mse_fragment_channels`), then ``s0, b0, s1, b1,
    s2, b2`` of the scale.  Two launches: one concatenation, one gather.
    The kernel splits the weights into TF32 hi and lo parts as it stages
    them."""
    w0rel, w0feat, s0, b0, w1, s1, b1, w2, s2, b2 = packed
    s_cnt, cf = len(w0rel), w0feat[0].shape[0]
    key = (s_cnt, cf, w1.device)
    if key not in _MSE_INDEX:
        _MSE_INDEX[key] = (
            torch.from_numpy(_mse_image_index(s_cnt, cf)).to(w1.device),
            torch.zeros(1, dtype=w1.dtype, device=w1.device))
    index, zero = _MSE_INDEX[key]
    flat = torch.cat([t.reshape(-1) for t in (*w0rel, *w0feat, w1, w2, s0,
                                              b0, s1, b1, s2, b2)] + [zero])
    return flat[index]


def center_xyz(xyz: Tensor) -> Tensor:
    """Subtract each cloud's mean over all N points, padding included.  The
    centre cancels exactly in ``gather(base) - off``; it keeps the folded
    terms at the scene's extent rather than at absolute coordinates."""
    return xyz - xyz.mean(dim=1, keepdim=True)


def make_plf_base(feat_tx: Tensor, xyz: Tensor, wrel: Tensor,
                  dtype: torch.dtype = torch.float32) -> Tensor:
    """``feat_tx + xyz @ wrel`` in float32 (``wrel`` as it comes, bf16
    values included), stored in ``dtype``: the bf16 arm's pre-rounded base,
    one rounding per point."""
    return (feat_tx.float() + xyz @ wrel.float()).to(dtype)


def make_mse_base(feats: Tensor, xyz: Tensor, w0rel_list: Sequence[Tensor],
                  w0feat_list: Sequence[Tensor],
                  dtype: torch.dtype = torch.float32) -> Tensor:
    """``[B, N, S*C1]``: channel block s holds scale s's folded first layer
    ``feats @ w0f_s + xyz @ w0r_s``, computed in float32 and stored in
    ``dtype`` (K3's bf16 arm forms each gathered row of it in the kernel,
    each product rounded where these float32 matmuls round theirs on the
    CPU: the first term's product, then a fused multiply-add per channel,
    then one add).  (The JAX package stacks the blocks along rows, ``[B, S*N,
    C1c]`` with zeros off the diagonal, for its one-hot gather; summing its
    row blocks gives this tensor.)"""
    return torch.cat([feats.float() @ wf + xyz @ wr
                      for wr, wf in zip(w0rel_list, w0feat_list)],
                     dim=-1).to(dtype)


# ---------------------------------------------------------------------------
# the arms: tuned kernels at the widths they are written for, the generic
# kernel (csrc/chain.cu) at every other
# ---------------------------------------------------------------------------

TUNED, GENERIC = "tuned", "generic"


def mse_arm(widths: Sequence[int], scales: int, cf: int) -> str:
    """K3's kernel for a narrow encoder of 3-layer ``widths`` (C1, C2, C3),
    ``scales`` scales and ``cf`` features: ``csrc/mse.cu`` (any K) where it
    is written for them, else the generic kernel, one launch a scale."""
    return (TUNED if tuple(widths) == MSE_WIDTHS and scales <= MSE_MAX_SCALES
            and cf <= MSE_MAX_FEATS else GENERIC)


def plf_arm(widths: Sequence[int]) -> str:
    """K5's kernel for a chain of ``widths`` (C1, then each Dense layer's
    output): ``csrc/plf.cu`` (any K) at ``PLF_WIDTHS``, else the generic
    kernel."""
    return TUNED if tuple(widths) == PLF_WIDTHS else GENERIC


def cv_p2p_arm(widths: Sequence[int]) -> str:
    """K4a's kernel for a dense chain of ``widths`` (C0, C1, C2):
    ``csrc/cost_volume.cu`` (any K) at C = ``CV_WIDTH`` throughout, else the
    generic kernel."""
    return TUNED if tuple(widths) == (CV_WIDTH,) * 3 else GENERIC


def cv_agg_arm(c: int) -> str:
    """K4b's kernel for a cost of width ``c``: ``csrc/cost_volume.cu``'s
    tuned instance at ``CV_WIDTH``, else its generic one (the same design in
    chunks of the row, :func:`cv_agg_plan`)."""
    return TUNED if c == CV_WIDTH else GENERIC


_CHAIN_KINDS = {"max": 0, "p2p": 1}

# The generic kernel's tensor-core kernel (csrc/chain.cu::chain_tc_kernel,
# kinds max and p2p with at least one layer): its constants, and the plan of
# a launch, a function of the shapes alone.
CHAIN_TC_ROWS = 64  # rows of a tile: one consumer warpgroup
CHAIN_TC_SUB = 64  # columns of one wgmma; every layer's width padded to it
CHAIN_TC_STAGE = 16384  # bytes of a weight stage
CHAIN_TC_STAGES = 3  # stages of the ring
CHAIN_TC_CLUSTER = 2  # blocks that share each weight stage (multicast)
CHAIN_TC_BLOCKS = 2  # blocks an SM its registers allow (its launch bound)
# its static shared memory, at most: the rows' query, neighbour, point and
# WeightNet hidden layer (64 x (4 + 8 + 12 + 32) bytes) and the ring's 6
# mbarriers (the build keeps only the arrays a kind uses: 1,664 bytes for
# max, 2,944 for p2p on the card); chip_smoke.py holds the card's count to it
CHAIN_TC_STATIC_SMEM = 3632
CHAIN_TC_PAD = 16  # elements a middle activation row is padded by (banks)
SMEM_BLOCK = 232448  # shared memory a block may take (opt-in)
SMEM_SM = 233472  # an SM's
SMEM_RESERVED = 1024  # the system's share of each block
H100_SMS = 132
# the plan's fields in the order cmflow_chain_tc reads them (PlanField)
CHAIN_TC_PLAN = ("n", "k", "total", "src_stride", "out_stride", "c0",
                 "c_last", "layers", "span", "qpt", "tiles", "works",
                 "iters", "period", "xw", "yw", "x_global", "y_global",
                 "x_off", "y_off", "red_off", "carry_off", "scratch_block",
                 "grid", "smem")


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def chain_tc_arm(bf16: bool) -> Tuple[int, int]:
    """(input channels of a weight stage, output columns of a block pass):
    two k8 steps of 128 columns in float32 (TF32 hi and lo), two k16 steps
    of 256 columns in bf16."""
    return (32, 256) if bf16 else (16, 128)


def chain_tc_widths(c0: int, widths: Sequence[int], bf16: bool
                    ) -> Tuple[List[int], List[int]]:
    """Each layer's padded input and output widths: outputs to a multiple of
    64 (a wgmma's columns), the first input to a multiple of a stage's
    channels; a later input is the padded output before it."""
    couts = [_round_up(w, CHAIN_TC_SUB) for w in widths]
    return [_round_up(c0, chain_tc_arm(bf16)[0])] + couts[:-1], couts


def chain_tc_plan(bf16: bool, c0: int, widths: Sequence[int], k: int,
                  total: int, sms: int = H100_SMS) -> Dict[str, int]:
    """The tensor-core kernel's launch at these shapes (``c0`` the first
    activation's width, ``widths`` each Dense layer's output, ``k``
    neighbours, ``total = B * N`` queries), from the shapes alone:

    * rows: a query takes ``span`` rows, the power of two at or above K, and
      a 64-row tile ``qpt = 64 / span`` queries; past K = 64 one query runs
      over ``tiles`` tiles, its max or sum carried;
    * the weight stages a tile streams (``period``) and the ring;
    * the two middle activation buffers (X takes the outputs of even
      layers, Y of odd ones; rows of ``xw``, ``yw`` elements), each in
      shared memory or in device scratch: in shared memory unless that
      leaves fewer than ``CHAIN_TC_BLOCKS`` blocks an SM (then the wider
      goes to scratch, then both), or does not fit at all;
    * the shared-memory layout and bytes, blocks an SM, and a persistent
      grid of whole clusters with ``iters`` work items a block."""
    chans, cols = chain_tc_arm(bf16)
    cins, couts = chain_tc_widths(c0, widths, bf16)
    period = sum(-(-co // cols) * (ci // chans) for ci, co in zip(cins, couts))
    middles = couts[:-1]
    xw, yw = (w + CHAIN_TC_PAD if w else 0
              for w in (max(middles[0::2], default=0),
                        max(middles[1::2], default=0)))
    elt = 2 if bf16 else 4
    if k <= CHAIN_TC_ROWS:
        span = 1 << (k - 1).bit_length()
        qpt, tiles = CHAIN_TC_ROWS // span, 1
        works = -(-total // qpt)
    else:
        span, qpt, works = CHAIN_TC_ROWS, 1, total
        tiles = -(-k // CHAIN_TC_ROWS)
    # a query over several warps sums their parts in shared memory
    red = 4 * cols * 4 if span >= 32 else 0
    carry = couts[-1] * 4 if tiles > 1 else 0

    def layout(x_global: bool, y_global: bool) -> Dict[str, int]:
        at = CHAIN_TC_STAGES * CHAIN_TC_STAGE
        out = dict(x_global=int(x_global), y_global=int(y_global), x_off=at)
        at += 0 if x_global else CHAIN_TC_ROWS * xw * elt
        out["y_off"] = at
        at += 0 if y_global else CHAIN_TC_ROWS * yw * elt
        out.update(red_off=at, carry_off=at + red, smem=at + red + carry)
        held = out["smem"] + CHAIN_TC_STATIC_SMEM
        out["blocks_per_sm"] = (0 if held > SMEM_BLOCK else min(
            CHAIN_TC_BLOCKS, SMEM_SM // (held + SMEM_RESERVED)))
        return out

    options = [layout(False, False)]
    if xw or yw:
        options.append(layout(xw >= yw, yw > xw))
        options.append(layout(bool(xw), bool(yw)))
    fits = [o for o in options if o["blocks_per_sm"] >= 1]
    if not fits:
        raise ValueError(f"the generic kernel does not fit C0={c0}, widths "
                         f"{list(widths)}, K={k} in shared memory")
    best = max(o["blocks_per_sm"] for o in fits)
    plan = next(o for o in fits if o["blocks_per_sm"] == best)
    grid = (_round_up(min(works, sms * plan["blocks_per_sm"]),
                      CHAIN_TC_CLUSTER) if works else 0)
    scratch_block = CHAIN_TC_ROWS * (xw * plan["x_global"]
                                     + yw * plan["y_global"])
    plan.update(total=total, c0=c0, c_last=widths[-1], layers=len(widths),
                span=span, qpt=qpt, tiles=tiles, works=works,
                iters=-(-works // grid) if grid else 0, period=period,
                xw=xw, yw=yw, scratch_block=scratch_block, grid=grid,
                scratch=grid * scratch_block)
    return plan


def chain_tc_table(kind: str, bf16: bool, c0: int, widths: Sequence[int]
                   ) -> Tuple[List[int], int]:
    """The layer table of ``csrc/chain.cu`` (a header ``[c0_p, wrel, s0, b0,
    ww2, wb2, wn, c_last_p]``, then ``[cin_p, cout_p, s, b]`` a layer: the
    padded widths and each parameter's offset in floats, -1 for none) and
    the floats of the parameter array :func:`chain_tc_params` lays out in
    that order: for ``max`` wrel ``[3, c0_p]``, s0, b0, then each layer's
    scale and bias; for ``p2p`` b0, each layer's bias, then the WeightNet's
    ww2 ``[8, c_last_p]``, wb2 and wn (wb0 [8], ww1 [8, 8], wb1 [8])."""
    cins, couts = chain_tc_widths(c0, widths, bf16)
    head = [cins[0], -1, -1, -1, -1, -1, -1, couts[-1]]
    at = 0

    def take(n: int) -> int:
        nonlocal at
        at += n
        return at - n

    if kind == "max":
        head[1], head[2], head[3] = take(3 * cins[0]), take(cins[0]), take(
            cins[0])
    else:
        head[3] = take(cins[0])
    rows = []
    for ci, co in zip(cins, couts):
        s_off = take(co) if kind == "max" else -1
        rows += [ci, co, s_off, take(co)]
    if kind == "p2p":
        h = WEIGHTNET_HIDDEN
        head[4], head[5] = take(h * couts[-1]), take(couts[-1])
        head[6] = take(2 * h + h * h)
    return head + rows, at


def chain_tc_params(kind: str, c0: int,
                    layers: Sequence[Tuple[Tensor, Optional[Tensor], Tensor]],
                    wrel: Tensor = None, s0: Tensor = None,
                    b0: Tensor = None, wn: Sequence[Tensor] = ()) -> Tensor:
    """The float32 parameter array of :func:`chain_tc_table`, every piece
    zero-padded to its padded width (so padded channels stay zero through
    each affine and activation)."""
    bf16 = layers[0][0].dtype == torch.bfloat16
    cins, couts = chain_tc_widths(c0, [w.shape[1] for w, _, _ in layers],
                                  bf16)
    pad = torch.nn.functional.pad

    def flat(x: Tensor, n: int) -> Tensor:
        x = x.float().reshape(-1)
        return pad(x, (0, n - x.numel()))

    if kind == "max":
        pieces = [pad(wrel.float(), (0, cins[0] - c0)).reshape(-1),
                  flat(s0, cins[0]), flat(b0, cins[0])]
    else:
        pieces = [flat(b0, cins[0])]
    for (_, s, b), co in zip(layers, couts):
        if kind == "max":
            pieces.append(flat(s, co))
        pieces.append(flat(b, co))
    if kind == "p2p":
        wb0, ww1, wb1, ww2, wb2 = wn
        pieces += [pad(ww2.float(), (0, couts[-1] - ww2.shape[1])).reshape(-1),
                   flat(wb2, couts[-1]), *[t.float().reshape(-1)
                                           for t in (wb0, ww1, wb1)]]
    return torch.cat(pieces)


def chain_tc_weights(ws: Sequence[Tensor], c0: int) -> Tensor:
    """A chain's Dense kernels ``w_l [cin, cout]`` as the one array of 16 KB
    weight stages the tensor-core kernel streams, in the order it takes
    them: per layer, per block of output columns (:func:`chain_tc_arm`),
    per two k steps.  Each layer is zero-padded to its padded widths
    (:func:`chain_tc_widths`) and its last column block to whole.  The K
    order of every product is ``from_rows``' (its A made from four
    consecutive channels of a row).
    * float32: a stage is the TF32 hi tiles (:func:`tf32_split`) of its two
      k8 steps of 128 columns (:func:`_tc_operand`, 4 KB each), then their
      lo tiles;
    * bf16: its two k16 steps of 256 columns (:func:`_tc_operand_bf16`,
      8 KB each)."""
    bf16 = ws[0].dtype == torch.bfloat16
    chans, cols = chain_tc_arm(bf16)
    cins, couts = chain_tc_widths(c0, [w.shape[1] for w in ws], bf16)
    parts = []
    for w, ci, co in zip(ws, cins, couts):
        blocks = -(-co // cols)
        wp = torch.nn.functional.pad(
            w, (0, blocks * cols - w.shape[1], 0, ci - w.shape[0]))
        if bf16:  # (stage, step, block, tile) -> (block, stage, step, tile)
            v = _tc_operand_bf16(wp, from_rows=True).reshape(
                ci // chans, 2, blocks, cols * 16)
            parts.append(v.permute(2, 0, 1, 3).reshape(-1))
        else:  # (part, stage, step, block, tile) -> (block, stage, part, ...)
            hi, lo = tf32_split(_tc_operand(wp, from_rows=True))
            v = torch.stack((hi, lo)).reshape(2, ci // chans, 2, blocks,
                                              cols * 8)
            parts.append(v.permute(3, 1, 0, 2, 4).reshape(-1))
    return torch.cat(parts)


# the layer tables on the device, by (kind, arm, c0, widths, device): made
# once a shape, so a launch copies nothing from the host
_CHAIN_TABLES: Dict[tuple, Tensor] = {}


def _chain_table(kind: str, bf16: bool, c0: int, widths: Sequence[int],
                 device: torch.device) -> Tensor:
    key = (kind, bf16, c0, tuple(widths), device)
    if key not in _CHAIN_TABLES:
        ints, _ = chain_tc_table(kind, bf16, c0, widths)
        _CHAIN_TABLES[key] = torch.tensor(ints, dtype=torch.int32).pin_memory(
        ).to(device, non_blocking=True)
    return _CHAIN_TABLES[key]


def chain_tc_occupancy(kind: str, bf16: bool, smem: int) -> int:
    """Blocks of the tensor-core kernel an SM of this card holds at ``smem``
    bytes of dynamic shared memory (the card's count)."""
    lib = build.load("chain", _SIGNATURES["chain"])
    return lib.cmflow_chain_tc_occupancy(_CHAIN_KINDS[kind], int(bf16), smem)


def chain_tc_static_smem(kind: str, bf16: bool) -> int:
    """The tensor-core kernel's static shared memory, as this card's build
    reports it."""
    lib = build.load("chain", _SIGNATURES["chain"])
    return lib.cmflow_chain_tc_static_smem(_CHAIN_KINDS[kind], int(bf16))


def _ptr(t) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _chain(wrapper, kind: str, idx: Tensor, src: Tensor, out: Tensor, *,
           layers: Sequence[Tuple[Tensor, Tensor, Tensor]] = (),
           f1c: Tensor = None, xyz: Tensor = None, wrel: Tensor = None,
           s0: Tensor = None, b0: Tensor = None, z1: Tensor = None,
           z2: Tensor = None, wn: Sequence[Tensor] = ()) -> None:
    """One launch of the generic kernel (``csrc/chain.cu``) on the card,
    counted in ``wrapper``'s ``launches`` and ``launches_generic``: a chain
    with layers on the tensor cores (``chain_tc_kernel``; its weights,
    parameters and plan made here), a max with none on ``chain_kernel``.

    ``src`` (the gathered rows: base or ``f2c``) and ``out`` are ``[B, N,
    C]`` views whose rows may be strided (a channel block of a wider
    tensor); ``f1c`` shares ``src``'s row stride.
    ``layers`` are ``(w [cin, cout], s or None, b)``, any number; the rest as
    ``csrc/chain.cu`` takes them."""
    b, n, c0 = src.shape
    k = idx.shape[2]
    if (src.stride(2) != 1 or out.stride(2) != 1
            or src.stride(0) != n * src.stride(1)
            or out.stride(0) != n * out.stride(1)
            or (f1c is not None and f1c.stride() != src.stride())):
        raise ValueError("the generic kernel takes rows of unit stride")
    lib = build.load("chain", _SIGNATURES["chain"])
    bf16 = src.dtype == torch.bfloat16
    if layers:
        widths = [w.shape[1] for w, _, _ in layers]
        plan = chain_tc_plan(bf16, c0, widths, k, b * n,
                             _sms(src.device))
        plan.update(n=n, k=k, src_stride=src.stride(1),
                    out_stride=out.stride(1))
        table = _chain_table(kind, bf16, c0, widths, src.device)
        prm = chain_tc_params(kind, c0, layers, wrel, s0, b0, wn)
        wimg = chain_tc_weights([w for w, _, _ in layers], c0)
        scratch = (torch.empty(plan["scratch"], dtype=src.dtype,
                               device=src.device) if plan["scratch"] else None)
        code = lib.cmflow_chain_tc(
            _CHAIN_KINDS[kind], int(bf16),
            (ctypes.c_longlong * len(CHAIN_TC_PLAN))(
                *[plan[f] for f in CHAIN_TC_PLAN]),
            idx.data_ptr(), src.data_ptr(), _ptr(f1c), _ptr(xyz), _ptr(z1),
            _ptr(z2), wimg.data_ptr(), prm.data_ptr(), table.data_ptr(),
            out.data_ptr(), _ptr(scratch), int(_whole_rows(src, f1c, c0)),
            _stream(src))
    else:
        if kind != "max":
            raise ValueError(f"the generic kernel's {kind} takes layers")
        code = lib.cmflow_chain(
            int(bf16), idx.data_ptr(), b, n, k, src.data_ptr(),
            src.stride(1), _ptr(xyz), _ptr(wrel), _ptr(s0), _ptr(b0), c0,
            out.data_ptr(), out.stride(1), _stream(src))
    build.check(lib, code, f"the generic kernel ({kind})")
    wrapper.launches += 1
    wrapper.launches_generic += 1


def _whole_rows(src: Tensor, f1c: Optional[Tensor], c0: int) -> bool:
    """Whether the kernel may read a gathered row's four consecutive
    channels (bf16) or two (float32) in one 8-byte load: rows 8-byte
    aligned, and C0 a multiple of 4 (so no such group straddles it)."""
    elt = src.element_size()
    return (c0 % 4 == 0 and (src.stride(1) * elt) % 8 == 0
            and all(t.data_ptr() % 8 == 0 for t in (src, f1c)
                    if t is not None))


_SMS: Dict[torch.device, int] = {}


def _sms(device: torch.device) -> int:
    """The card's SMs (the persistent grid's width)."""
    if device not in _SMS:
        _SMS[device] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return _SMS[device]


# ---------------------------------------------------------------------------
# K3: the narrow multi-scale encoder
# ---------------------------------------------------------------------------

# K3 past K = 32 (csrc/mse.cu::mse_long_kernel, mse_bf16_long_kernel): a
# scale's queries in quads of four, one a warp of a warpgroup, a step one
# 16-row unit of each (a 64-row wgmma tile); a block takes consecutive
# quads of one scale, its warpgroups every MSE_LONG_GROUPS-th.  The
# constants are the kernels' (kLongGroups, kLongBlocks, kLongBf16Groups,
# kLongBf16Blocks, kPointFloats, kPointWords, kBf16SpanPoints), by bf16.
MSE_TILE_MAX_K = 32  # the tile kernels' K; above it the long kernels
MSE_LONG_UNIT = 16  # rows of a query a warp takes a step
MSE_LONG_GROUPS = {False: 3, True: 4}  # warpgroups a block
MSE_LONG_BLOCKS = {False: 1, True: 1}  # blocks an SM (the launch bound)
MSE_SPAN_POINTS = 2048  # the most points a block's span holds
# bytes of a point in the span: float32 its coordinates and features (8
# floats), bf16 its base (16 words) and centred point
MSE_POINT_BYTES = {False: 4 * 8, True: 4 * (MSE_WIDTHS[0] // 2 + 3)}
# the long kernels' static shared memory, at most: the weight tiles (26 KB
# float32 with its 1 KB of affines, 6 KB bf16 with 2 KB of floats) and the
# warps' prefetch rings (1.5 KB a warp); chip_smoke.py holds the card's
# count to it
MSE_LONG_STATIC_SMEM = {False: 46080, True: 32768}


def mse_long_plan(ks: Sequence[int], total: int, n: int, bf16: bool,
                  sms: int = H100_SMS) -> Dict[str, object]:
    """The launch of K3's long kernel for scales of ``ks`` neighbours over
    ``total = B * N`` queries of clouds of ``n`` points, from the shapes
    alone: each scale past ``MSE_TILE_MAX_K`` gets a share of the card's
    resident blocks (``sms`` times ``MSE_LONG_BLOCKS``) by its steps
    (quads times 16-row units), and each of its blocks ``qpb`` consecutive
    quads (0 for the tile kernels' scales); ``grid`` the blocks of all.
    Each block copies (float32) or forms (bf16: the bases) its span, the
    points of the elements its queries lie in, whole, into shared memory
    where it holds at most ``MSE_SPAN_POINTS`` points and keeps
    ``MSE_LONG_BLOCKS`` blocks an SM: then ``span`` 1 and ``smem`` its
    bytes, else each row gathers its point from device memory (``span``
    0)."""
    quads = -(-total // 4)
    units = [-(-k // MSE_LONG_UNIT) if k > MSE_TILE_MAX_K else 0 for k in ks]
    steps = quads * sum(units)
    cap = sms * MSE_LONG_BLOCKS[bf16]
    qpb, blocks = [], []
    for u in units:
        if not u or not quads:
            qpb.append(0)
            blocks.append(0)
            continue
        share = max(1, cap * u * quads // steps)
        qpb.append(-(-quads // share))
        blocks.append(-(-quads // qpb[-1]))
    points = 0
    for q, nb in zip(qpb, blocks):
        if nb:
            first = 4 * q * np.arange(nb, dtype=np.int64)
            last = np.minimum(first + 4 * q, total) - 1
            points = max(points, int(((last // n - first // n + 1)
                                      * n).max()))
    smem = points * MSE_POINT_BYTES[bf16]
    held = MSE_LONG_STATIC_SMEM[bf16] + smem + SMEM_RESERVED
    span = bool(points and points <= MSE_SPAN_POINTS
                and MSE_LONG_BLOCKS[bf16] * held <= SMEM_SM)
    return dict(qpb=qpb, blocks=blocks, grid=sum(blocks), steps=steps,
                groups=MSE_LONG_GROUPS[bf16],
                blocks_per_sm=MSE_LONG_BLOCKS[bf16], span=int(span),
                span_points=points if span else 0, smem=smem if span else 0)


def mse_long_static_smem(bf16: bool, span: bool) -> int:
    """The long kernel's static shared memory, as this card's build
    reports it."""
    lib = build.load("mse", _SIGNATURES["mse"])
    return lib.cmflow_mse_long_static_smem(int(bf16), int(span))


def mse_long_occupancy(bf16: bool, span: bool, smem: int) -> int:
    """Blocks of the long kernel an SM of this card holds at ``smem`` bytes
    of dynamic shared memory (the card's count)."""
    lib = build.load("mse", _SIGNATURES["mse"])
    return lib.cmflow_mse_long_occupancy(int(bf16), int(span), smem)


def fused_multi_scale_encoder_plain(feats: Tensor, idx_list: Sequence[Tensor],
                                    xyz: Tensor, packed: tuple) -> Tensor:
    """Plain version of :func:`fused_multi_scale_encoder`."""
    w0rel, w0feat, s0, b0, w1, s1, b1, w2, s2, b2 = packed
    xyz_c = center_xyz(xyz)
    base = make_mse_base(feats, xyz_c, w0rel, w0feat, feats.dtype)
    c1, c2, c3 = w1.shape[1], w1.shape[2], w2.shape[2]
    outs = []
    for s, idx in enumerate(idx_list):
        r1, r2, r3 = (slice(s * c, (s + 1) * c) for c in (c1, c2, c3))
        x = (_group(base[..., r1], idx).float()
             - (xyz_c @ w0rel[s])[:, :, None, :])
        x = _relu_affine(x, s0[r1], b0[r1])
        x = _relu_affine(_mm(x, w1[s]), s1[r2], b1[r2])
        x = _relu_affine(_mm(x, w2[s]), s2[r3], b2[r3])
        outs.append(torch.amax(x, dim=2))
    return torch.cat(outs, dim=-1)


def fused_multi_scale_encoder(feats: Tensor, idx_list: Sequence[Tensor],
                              xyz: Tensor, packed: tuple) -> Tensor:
    """All scales of a narrow ``MultiScaleEncoder``, before mlp2: per scale
    s, gather ``feats @ w0f_s + xyz_c @ w0r_s`` at the ball indices, minus
    ``xyz_c @ w0r_s`` of the query, then three [affine -> ReLU -> Dense]
    layers and the max over that scale's ``K_s`` neighbours.  (At the
    tuned widths both arms' kernels form the first layer of each row
    themselves, from the gathered point and features; the bf16 arm rounds
    each gathered row's base to bf16 once, as the JAX package's base is
    rounded per point.  Such a call is two launches, the clouds' centroids
    and the kernel, or three where scales of K <= 32 and of K > 32 mix; see
    ``csrc/mse.cu``.  The scales past K = 32 take the long kernel, its grid
    planned from the shapes by :func:`mse_long_plan`; a call that launches
    it also counts in ``launches_long``.  At any other widths, more than 8 scales or more than
    5 features (:func:`mse_arm`) the generic kernel runs once a scale on the
    folded base, formed outside as the JAX package forms it.)

    Args:
      feats: ``[B, N, Cf]`` per-point features, any strides: float32, or
        bfloat16 for the bf16 arm (with ``w1``/``w2`` in bfloat16).
      idx_list: per scale, ``[B, N, K_s]`` int32 ball-query indices, any
        K_s >= 1.
      xyz: ``[B, N, 3]`` float32 coordinates.
      packed: from :func:`mse_narrow_params_from_variables`.
    Returns:
      ``[B, N, S*C3]`` float32, channel blocks in scale order.
    """
    w0rel, w0feat, s0, b0, w1, s1, b1, w2, s2, b2 = packed
    flat = [*w0rel, *w0feat, s0, b0, s1, b1, s2, b2]
    if not _on_card("fused_multi_scale_encoder", [xyz, *flat],
                    list(idx_list), [feats, w1, w2]):
        return fused_multi_scale_encoder_plain(feats, idx_list, xyz, packed)
    b, n, _ = xyz.shape
    s_cnt = len(idx_list)
    cf = feats.shape[2]
    c1, c2, c3 = widths = (w1.shape[1], w1.shape[2], w2.shape[2])
    ks = [i.shape[2] for i in idx_list]
    if (s_cnt < 1 or len(w0rel) != s_cnt or len(w0feat) != s_cnt
            or tuple(w1.shape) != (s_cnt, c1, c2)
            or tuple(w2.shape) != (s_cnt, c2, c3) or min(ks) < 1):
        raise ValueError(f"need w1 [S, C1, C2], w2 [S, C2, C3] and S scales "
                         f"of K >= 1, got K={ks}, w1 {tuple(w1.shape)}, w2 "
                         f"{tuple(w2.shape)} and {len(w0rel)} scales of "
                         f"weights")
    if tuple(feats.shape[:2]) != (b, n):
        raise ValueError(f"need feats [B, N, Cf], got {tuple(feats.shape)}")
    if any(tuple(i.shape[:2]) != (b, n) for i in idx_list):
        raise ValueError("every idx must be [B, N, K_s]")
    if (any(tuple(w.shape) != (3, c1) for w in w0rel)
            or any(tuple(w.shape) != (cf, c1) for w in w0feat)
            or any(a.numel() != s_cnt * w for a, w in zip(
                (s0, b0, s1, b1, s2, b2), (c1, c1, c2, c2, c3, c3)))):
        raise ValueError(f"need per scale w0rel [3, {c1}], w0feat [{cf}, "
                         f"{c1}] and the affines of every scale")
    if not all(i.is_contiguous() for i in idx_list):
        raise ValueError("fused_multi_scale_encoder: the CUDA kernel takes "
                         "contiguous indices")
    if mse_arm(widths, s_cnt, cf) == GENERIC:
        return _mse_generic(feats, idx_list, xyz, packed)
    out = torch.empty((b, n, s_cnt * c3), dtype=torch.float32,
                      device=xyz.device)
    idx_ptrs = (ctypes.c_void_p * s_cnt)(*[i.data_ptr() for i in idx_list])
    lib = build.load("mse", _SIGNATURES["mse"])
    bf16 = feats.dtype == torch.bfloat16
    plan = mse_long_plan(ks, b * n, n, bf16, _sms(xyz.device))
    qpb = (ctypes.c_int * s_cnt)(*plan["qpb"])
    # the kernels read xyz, ctr, the indices and the bf16 arm's weights by
    # scalar loads
    xyz = xyz.contiguous()
    ctr = xyz.mean(dim=1)
    if bf16:
        w0r, w0f = ([w.contiguous() for w in ws] for ws in (w0rel, w0feat))
        # the long kernel reads w1, w2 and s2 16 bytes at a time
        rest = [_aligned16(t.contiguous())
                for t in (w1, w2, s0, b0, s1, b1, s2, b2)]
        code = lib.cmflow_mse_bf16(
            xyz.data_ptr(), feats.data_ptr(), *feats.stride(), cf,
            ctr.data_ptr(), idx_ptrs, (ctypes.c_int * s_cnt)(*ks), s_cnt,
            qpb, plan["smem"],
            (ctypes.c_void_p * s_cnt)(*[w.data_ptr() for w in w0r]),
            (ctypes.c_void_p * s_cnt)(*[w.data_ptr() for w in w0f]),
            *[t.data_ptr() for t in rest], out.data_ptr(), b, n,
            _stream(xyz))
    else:
        # the image is fresh, so aligned for its float2 loads
        image = mse_tc_weights(packed)
        code = lib.cmflow_mse(
            xyz.data_ptr(), feats.data_ptr(), *feats.stride(), cf,
            ctr.data_ptr(), idx_ptrs, (ctypes.c_int * s_cnt)(*ks), s_cnt,
            qpb, plan["smem"], image.data_ptr(), out.data_ptr(), b, n,
            _stream(xyz))
    build.check(lib, code, "fused_multi_scale_encoder")
    fused_multi_scale_encoder.launches += 1
    if plan["grid"]:
        fused_multi_scale_encoder.launches_long += 1
    return out


def _aligned16(t: Tensor) -> Tensor:
    """``t``, or a copy of it where its data is not 16-byte aligned."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _mse_generic(feats: Tensor, idx_list: Sequence[Tensor], xyz: Tensor,
                 packed: tuple) -> Tensor:
    """K3 on the generic kernel, whatever its shapes (the wrapper's
    generic arm; the checks are the wrapper's): every scale's folded first
    layer as one base outside (:func:`make_mse_base`, as the JAX package
    forms it, in ``feats``' dtype), then one launch a scale into its channel
    block of the output."""
    w0rel, w0feat, s0, b0, w1, s1, b1, w2, s2, b2 = packed
    c1, c2, c3 = w1.shape[1], w1.shape[2], w2.shape[2]
    b, n, _ = xyz.shape
    xyz_c = center_xyz(xyz).contiguous()
    base = make_mse_base(feats, xyz_c, w0rel, w0feat, feats.dtype)
    out = torch.empty((b, n, len(idx_list) * c3), dtype=torch.float32,
                      device=xyz.device)
    for s, idx in enumerate(idx_list):
        r1, r2, r3 = (slice(s * c, (s + 1) * c) for c in (c1, c2, c3))
        _chain(fused_multi_scale_encoder, "max", idx, base[..., r1],
               out[..., r3], layers=[(w1[s].contiguous(), s1[r2], b1[r2]),
                                     (w2[s].contiguous(), s2[r3], b2[r3])],
               xyz=xyz_c, wrel=w0rel[s].float().contiguous(), s0=s0[r1],
               b0=b0[r1])
    return out


# every launch, and those of the generic arm (counted in :func:`_chain`)
fused_multi_scale_encoder.launches = 0
fused_multi_scale_encoder.launches_generic = 0
# the calls that launched the long kernel (scales past K = 32), of launches
fused_multi_scale_encoder.launches_long = 0


# ---------------------------------------------------------------------------
# the full tiles of K4a and K5: a block takes a run of whole queries, their
# rows in full tiles across query boundaries
# ---------------------------------------------------------------------------

def full_tile_plan(total: int, k: int, rows: int, sms: int = H100_SMS,
                   cluster: int = 1) -> Dict[str, float]:
    """A full-tile arm's launch for ``total = B * N`` queries of ``k``
    neighbours in tiles of ``rows`` rows on a card that runs ``sms`` blocks
    at once (one an SM), in clusters of ``cluster``, from the shapes alone:
    each block takes ``qpb`` consecutive whole queries, the fewest with
    which the card's whole clusters take them all at once, their ``qpb *
    k`` rows one after the other in full tiles across query boundaries.
    ``tiles``: the most any block's rows fill; ``blocks``: those that hold
    queries; ``grid``: those padded to whole clusters; ``fill``: the share
    of the rows run that hold a (query, neighbour) where each block runs
    the tiles its rows fill."""
    if total <= 0:
        return dict(qpb=0, tiles=0, blocks=0, grid=0, fill=0.0)
    cluster = max(1, cluster)
    qpb = -(-total // max(cluster, sms // cluster * cluster))
    tiles = -(-qpb * k // rows)
    blocks = -(-total // qpb)
    last = -(-(total - (blocks - 1) * qpb) * k // rows)
    return dict(qpb=qpb, tiles=tiles, blocks=blocks,
                grid=-(-blocks // cluster) * cluster,
                fill=total * k / (((blocks - 1) * tiles + last) * rows))


# ---------------------------------------------------------------------------
# K5: one propagation-encoder scale
# ---------------------------------------------------------------------------

# K5 (csrc/plf.cu): tiles of PLF_ROWS (query, neighbour) rows (the kernel's
# kRows); bf16 (plf_bf16_kernel, in clusters of PLF_BF16_CLUSTER, the
# kernel's kBf16Cluster) in full tiles across query boundaries at every K
PLF_ROWS = 128
PLF_BF16_CLUSTER = 1


def plf_plan(total: int, k: int, sms: int = H100_SMS) -> Dict[str, float]:
    """bf16 K5's launch (``plf_bf16_kernel``, every block running
    ``tiles``) at any ``k``: :func:`full_tile_plan` at ``PLF_ROWS`` on
    ``sms`` blocks in clusters of ``PLF_BF16_CLUSTER``.  (Timed at K =
    4-200 against tiles of whole queries, full tiles were faster at every
    K, those that fill their tiles too: one block an SM sets up once;
    PERF.md §6, PR 23.)"""
    return full_tile_plan(total, k, PLF_ROWS, sms, PLF_BF16_CLUSTER)


def fused_point_local_feature_plain(feat_tx: Tensor, idx: Tensor, xyz: Tensor,
                                    params: Sequence[Tensor]) -> Tensor:
    """Plain version of :func:`fused_point_local_feature`."""
    wrel = params[0]
    xyz_c = center_xyz(xyz)
    base = make_plf_base(feat_tx, xyz_c, wrel, feat_tx.dtype)
    x = _group(base, idx).float() - (xyz_c @ wrel.float())[:, :, None, :]
    x = _relu_affine(x, params[1], params[2])
    for i in range(3, len(params), 3):
        w, s, b = params[i:i + 3]
        x = _relu_affine(_mm(x, w), s, b)
    return torch.amax(x, dim=2)


def fused_point_local_feature(feat_tx: Tensor, idx: Tensor, xyz: Tensor,
                              params: Sequence[Tensor]) -> Tensor:
    """Grouped mlp and max-pool over ball-query neighbourhoods, before mlp2:
    ``csrc/plf.cu`` at ``PLF_WIDTHS``, the generic kernel at any other chain
    (any depth; :func:`plf_arm`).

    Args:
      feat_tx: ``[B, N, C1]`` per-point features after the factored first
        layer's feature transform (``features @ w0[3:]``): float32, or
        bfloat16 for the bf16 arm, whose base ``feat_tx + xyz_c @ wrel`` is
        rounded to bf16 once per point.
      idx: ``[B, N, K]`` int32 ball-query indices, any K >= 1.
      xyz: ``[B, N, 3]`` float32 coordinates.
      params: ``(wrel, s0, b0, w1, s1, b1, ...)`` from
        :func:`plf_params_from_variables`; ``wrel`` and the Dense kernels in
        ``feat_tx``'s dtype, the affines float32.
    Returns:
      ``[B, N, C_last]`` float32.
    """
    params = list(params)
    if not _on_card("fused_point_local_feature",
                    [xyz, *params[1::3], *params[2::3]], [idx],
                    [feat_tx, params[0], *params[3::3]]):
        return fused_point_local_feature_plain(feat_tx, idx, xyz, params)
    b, n, c1 = feat_tx.shape
    k = idx.shape[2]
    widths = (c1,) + tuple(w.shape[1] for w in params[3::3])
    if (len(params) % 3 or tuple(params[0].shape) != (3, c1)
            or any(w.shape[0] != c for w, c in zip(params[3::3], widths))):
        raise ValueError(f"need a chain (wrel [3, C1], s0, b0, w1, s1, b1, "
                         f"...) of chained widths, got widths {widths}")
    if tuple(idx.shape[:2]) != (b, n) or k < 1:
        raise ValueError(f"idx must be [B, N, K] with K >= 1, got "
                         f"{tuple(idx.shape)}")
    if plf_arm(widths) == GENERIC:
        return _plf_generic(feat_tx, idx, xyz, params)
    bf16 = feat_tx.dtype == torch.bfloat16
    xyz_c = center_xyz(xyz).contiguous()
    base = make_plf_base(feat_tx, xyz_c, params[0], feat_tx.dtype).contiguous()
    wrel = params[0].float().contiguous()  # the offset stays float32
    out = torch.empty((b, n, widths[-1]), dtype=torch.float32,
                      device=xyz.device)
    _, s0, b0, w1, s1, b1, w2, s2, b2 = params
    wpack = (tc_weights_bf16(w1, w2, from_rows=True) if bf16
             else tc_weights(w1, w2))
    _check_kernel_args("fused_point_local_feature",
                       [base, idx, xyz_c, wrel, s0, b0, wpack, s1, b1, s2,
                        b2])
    lib = build.load("plf", _SIGNATURES["plf"])
    args = (base.data_ptr(), idx.data_ptr(), xyz_c.data_ptr(),
            wrel.data_ptr(), s0.data_ptr(), b0.data_ptr(), wpack.data_ptr(),
            s1.data_ptr(), b1.data_ptr(), s2.data_ptr(), b2.data_ptr(),
            out.data_ptr(), b, n, k, c1)
    if bf16:
        plan = plf_plan(b * n, k, _sms(xyz.device))
        code = lib.cmflow_plf_bf16(*args, plan["qpb"], plan["tiles"],
                                   _stream(xyz))
    else:
        code = lib.cmflow_plf(*args, _stream(xyz))
    build.check(lib, code, "fused_point_local_feature")
    fused_point_local_feature.launches += 1
    fused_point_local_feature.launches_full += int(bf16)
    return out


def _plf_generic(feat_tx: Tensor, idx: Tensor, xyz: Tensor,
                 params: Sequence[Tensor]) -> Tensor:
    """K5 on the generic kernel, whatever its widths (the wrapper's generic
    arm; the checks are the wrapper's): the base folded outside as the
    tuned arm's, then one launch."""
    b, n, _ = feat_tx.shape
    xyz_c = center_xyz(xyz).contiguous()
    base = make_plf_base(feat_tx, xyz_c, params[0], feat_tx.dtype).contiguous()
    c_last = params[-3].shape[1] if len(params) > 3 else feat_tx.shape[2]
    out = torch.empty((b, n, c_last), dtype=torch.float32, device=xyz.device)
    _chain(fused_point_local_feature, "max", idx.contiguous(), base, out,
           layers=[(w.contiguous(), sc, bi) for w, sc, bi in zip(
               params[3::3], params[4::3], params[5::3])],
           xyz=xyz_c, wrel=params[0].float().contiguous(), s0=params[1],
           b0=params[2])
    return out


# every launch, those of the generic arm (counted in :func:`_chain`) and
# those in full tiles (the bf16 arm's)
fused_point_local_feature.launches = 0
fused_point_local_feature.launches_generic = 0
fused_point_local_feature.launches_full = 0


# ---------------------------------------------------------------------------
# K4a + K4b: the cost volume
# ---------------------------------------------------------------------------

# K4a (csrc/cost_volume.cu): tiles of CV_P2P_ROWS (query, neighbour) rows
# (the kernel's kP2pRows); full tiles across query boundaries in float32 at
# the K of cv_p2p_full (cv_p2p_full_kernel), in bf16 at every K
# (cv_p2p_bf16_kernel, in clusters of CV_P2P_BF16_CLUSTER blocks, the
# kernel's kBf16Cluster: timed at k = 5-130 against tiles of whole queries,
# full tiles were faster or within 3% at every k, the divisors of 64 too,
# since one block an SM sets up once; PERF.md §6, PR 23)
CV_P2P_ROWS = 64
CV_P2P_BF16_CLUSTER = 2
# the share of a tile of whole queries below which float32 K4a takes its
# full-tile arm at a k < 64: on the card a full tile costs ~1.13x a tile of
# whole queries, whose empty rows gather nothing (PERF.md §6)
CV_P2P_FULL_BELOW = 7 / 8


def cv_p2p_full(k: int) -> bool:
    """Whether float32 K4a at ``k`` neighbours takes the full-tile arm:
    past ``CV_P2P_ROWS`` every ``k`` (a query's rows over tiles would leave
    the last one part empty), below it every ``k`` whose tile of whole
    queries (``CV_P2P_ROWS // k`` of them) is less than
    ``CV_P2P_FULL_BELOW`` full; the ``k`` that divide ``CV_P2P_ROWS`` fill
    their tiles and never do."""
    if k > CV_P2P_ROWS:
        return True
    return CV_P2P_ROWS // k * k < CV_P2P_FULL_BELOW * CV_P2P_ROWS


def cv_p2p_plan(total: int, k: int, sms: int = H100_SMS,
                cluster: int = 1) -> Dict[str, float]:
    """K4a's full-tile launch (:func:`full_tile_plan` at ``CV_P2P_ROWS``):
    float32 in clusters of one, each block running the tiles its rows fill;
    bf16 in clusters of ``CV_P2P_BF16_CLUSTER``, every block running
    ``tiles`` (both blocks of a cluster take part in every weight stage)."""
    return full_tile_plan(total, k, CV_P2P_ROWS, sms, cluster)


# K4b (csrc/cost_volume.cu::cv_agg_kernel and, at any C, cv_agg_any_kernel):
# blocks of CV_AGG_THREADS threads, each on a cell of four channels of a
# row for up to CV_AGG_PER queries, the neighbours in chunks of CV_AGG_KC,
# at most CV_AGG_MAX_PAIRS (query, neighbour) pairs a chunk, CV_AGG_BLOCKS
# blocks an SM (the launch bound); the kernel's kAggThreads, kAggPer,
# kAggKc and kAggMaxPairs
CV_AGG_THREADS = 256
CV_AGG_PER = 8
CV_AGG_KC = 8
CV_AGG_MAX_PAIRS = 512
CV_AGG_BLOCKS = 2


@functools.lru_cache(maxsize=None)
def cv_agg_plan(c: int, b: int, n: int, sms: int = H100_SMS
                ) -> Dict[str, int]:
    """K4b's launch at any C (``cv_agg_any_kernel``) for B clouds of N
    points, from the shapes alone: a block takes one chunk of ``cells``
    cells of four channels (``chunks`` chunks cover the row's ``row_cells``)
    for ``queries = CV_AGG_THREADS // cells * per`` queries of one cloud,
    ``per`` a thread; ``tiles`` blocks a cloud, ``blocks`` in all.  Of every
    (cells, per) it takes the one whose waves (``blocks`` over the
    ``CV_AGG_BLOCKS * sms`` the card runs at once) times a block's work
    (``per`` queries a thread, and one for the block's fixed cost: the
    hidden layer, the barriers, the ring's first query) is least; ties go
    to more queries a thread, then to wider chunks."""
    row = -(-c // 4)
    slots_card = CV_AGG_BLOCKS * max(1, sms)
    best = None
    # a chunk of fewer than four cells would give a block more queries
    # than a chunk's pairs hold
    least = CV_AGG_THREADS * CV_AGG_KC // CV_AGG_MAX_PAIRS
    for cells in sorted({max(least, -(-row // ch))
                         for ch in range(1, row + 1)}):
        if cells > CV_AGG_THREADS:
            continue
        slots = CV_AGG_THREADS // cells
        chunks = -(-row // cells)
        for per in range(1, CV_AGG_PER + 1):
            queries = slots * per
            if queries * CV_AGG_KC > CV_AGG_MAX_PAIRS:
                break
            tiles = -(-n // queries)
            blocks = b * tiles * chunks
            cost = -(-blocks // slots_card) * (per + 1)
            key = (cost, -per, -cells)
            if best is None or key < best[0]:
                best = (key, dict(row_cells=row, cells=cells, chunks=chunks,
                                  per=per, queries=queries, tiles=tiles,
                                  blocks=blocks))
    return best[1]


def _weightnet_tail(z: Tensor, wn: Sequence[Tensor]) -> Tensor:
    """WeightNet after its first product: ``z = d @ w0``, then
    ReLU(z + b0) -> Dense -> ReLU -> Dense -> ReLU."""
    b0, w1, b1, w2, b2 = wn
    h = torch.relu(z + b0)
    h = torch.relu(h @ w1 + b1)
    return torch.relu(h @ w2 + b2)


def cost_volume_p2p_plain(f1c: Tensor, f2c: Tensor, idx: Tensor, z1: Tensor,
                          z2: Tensor, dense: Sequence[Tensor],
                          wn: Sequence[Tensor]) -> Tensor:
    """Plain version of :func:`cost_volume_p2p`."""
    b0, w1, b1, w2, b2 = dense
    x = _leaky((f1c.float()[:, :, None, :] + _group(f2c, idx).float()) + b0)
    x = _leaky(_mm(x, w1) + b1)
    x = _leaky(_mm(x, w2) + b2)
    w = _weightnet_tail(_group(z2, idx) - z1[:, :, None, :], wn)
    return torch.sum(w * x, dim=2).to(f1c.dtype)


def cost_volume_p2p(f1c: Tensor, f2c: Tensor, idx: Tensor, z1: Tensor,
                    z2: Tensor, dense: Sequence[Tensor],
                    wn: Sequence[Tensor]) -> Tensor:
    """Point-to-patch cost (the first half of ``FeatureCorrelator``), with
    the offsets folded: for each frame-2 neighbour ``j = idx[i, k]``,
    ``x = LeakyReLU(f1c[i] + f2c[j] + b0)`` through two LeakyReLU(0.1)
    Dense layers, weighted by the WeightNet of ``z2[j] - z1[i]`` and summed
    over k.

    Args:
      f1c / f2c: ``[B, N, C]`` folded frame-1 / frame-2 features, float32,
        or bfloat16 for the bf16 arm (with ``w1``/``w2`` in bfloat16).
      idx: ``[B, N, K]`` int32 frame-2 kNN indices, any K >= 1.
      z1 / z2: ``[B, N, H]`` float32, the WeightNet's first product of the
        centred frame-1 / frame-2 coordinates.
      dense: ``(b0, w1, b1, w2, b2)``, the biases float32; ``w1 [C, C1]``,
        ``w2 [C1, C2]``: ``csrc/cost_volume.cu`` at C = C1 = C2 =
        ``CV_WIDTH``, the generic kernel at any other (:func:`cv_p2p_arm`).
      wn: the WeightNet after its first product, ``(b0, w1, b1, w2, b2)``,
        float32.
    Returns:
      ``[B, N, C2]`` in ``f1c``'s dtype: the bf16 arm stores the sum of its
      float32 terms rounded to bf16.
    """
    dense, wn = list(dense), list(wn)
    b0, w1, b1, w2, b2 = dense
    if not _on_card("cost_volume_p2p", [z1, z2, b0, b1, b2, *wn], [idx],
                    [f1c, f2c, w1, w2]):
        return cost_volume_p2p_plain(f1c, f2c, idx, z1, z2, dense, wn)
    b, n, c = f1c.shape
    k = idx.shape[2]
    bf16 = f1c.dtype == torch.bfloat16
    widths = (c, w1.shape[1], w2.shape[1])
    _check_cv(b, n, widths[-1], k, idx, z1, wn)
    if (f2c.shape != f1c.shape or z2.shape != z1.shape
            or tuple(w1.shape) != widths[:2] or w2.shape[0] != widths[1]
            or b0.numel() != c):
        raise ValueError("frame 2 must have frame 1's shapes, and the dense "
                         "chain chained widths")
    if cv_p2p_arm(widths) == GENERIC:
        return _cv_p2p_generic(f1c, f2c, idx, z1, z2, dense, wn)
    wpack = tc_weights_bf16(w1, w2) if bf16 else tc_weights(w1, w2)
    _check_kernel_args("cost_volume_p2p",
                       [f1c, f2c, idx, z1, z2, b0, wpack, b1, b2, *wn])
    out = torch.empty((b, n, c), dtype=f1c.dtype, device=f1c.device)
    lib = build.load("cost_volume", _SIGNATURES["cost_volume"])
    args = (f1c.data_ptr(), f2c.data_ptr(), idx.data_ptr(), z1.data_ptr(),
            z2.data_ptr(), b0.data_ptr(), wpack.data_ptr(), b1.data_ptr(),
            b2.data_ptr(), *[t.data_ptr() for t in wn], out.data_ptr(), b, n,
            k, c)
    full = bf16 or cv_p2p_full(k)
    if bf16:
        plan = cv_p2p_plan(b * n, k, _cv_p2p_bf16_slots(lib, f1c.device),
                           CV_P2P_BF16_CLUSTER)
        code = lib.cmflow_cv_p2p_bf16(*args, plan["qpb"], plan["tiles"],
                                      _stream(f1c))
    elif full:
        plan = cv_p2p_plan(b * n, k, _sms(f1c.device))
        code = lib.cmflow_cv_p2p_full(*args, plan["qpb"], _stream(f1c))
    else:
        code = lib.cmflow_cv_p2p(*args, _stream(f1c))
    build.check(lib, code, "cost_volume_p2p")
    cost_volume_p2p.launches += 1
    cost_volume_p2p.launches_full += int(full)
    cost_volume_p2p.launches_full_bf16 += int(full and bf16)
    return out


_CV_P2P_BF16_SLOTS: Dict[torch.device, int] = {}


def _cv_p2p_bf16_slots(lib, device: torch.device) -> int:
    """The blocks of K4a's bf16 arm the card runs at once (its whole
    clusters): its plan's width."""
    if device not in _CV_P2P_BF16_SLOTS:
        with torch.cuda.device(device):
            slots = lib.cmflow_cv_p2p_bf16_slots()
        if slots <= 0:
            build.check(lib, -slots, "cost_volume_p2p (clusters a card)")
            raise RuntimeError("cost_volume_p2p: the card runs no cluster "
                               "of the bf16 arm")
        _CV_P2P_BF16_SLOTS[device] = slots
    return _CV_P2P_BF16_SLOTS[device]


def _cv_p2p_generic(f1c: Tensor, f2c: Tensor, idx: Tensor, z1: Tensor,
                    z2: Tensor, dense: Sequence[Tensor],
                    wn: Sequence[Tensor]) -> Tensor:
    """K4a on the generic kernel, whatever its widths (the wrapper's generic
    arm; the checks are the wrapper's): one launch."""
    b0, w1, b1, w2, b2 = dense
    b, n, _ = f1c.shape
    out = torch.empty((b, n, w2.shape[1]), dtype=f1c.dtype, device=f1c.device)
    _chain(cost_volume_p2p, "p2p", idx.contiguous(), f2c.contiguous(), out,
           f1c=f1c.contiguous(), b0=b0,
           layers=[(w1.contiguous(), None, b1), (w2.contiguous(), None, b2)],
           z1=z1.contiguous(), z2=z2.contiguous(), wn=wn)
    return out


# every launch, those of the generic arm (counted in :func:`_chain`), those
# in full tiles and those of them in bf16
cost_volume_p2p.launches = 0
cost_volume_p2p.launches_generic = 0
cost_volume_p2p.launches_full = 0
cost_volume_p2p.launches_full_bf16 = 0


def cost_volume_agg_plain(p2p: Tensor, idx: Tensor, zq: Tensor,
                          wn: Sequence[Tensor]) -> Tensor:
    """Plain version of :func:`cost_volume_agg`."""
    w = _weightnet_tail(_group(zq, idx) - zq[:, :, None, :], wn)
    return torch.sum(w * _group(p2p, idx).float(), dim=2)


def cost_volume_agg(p2p: Tensor, idx: Tensor, zq: Tensor,
                    wn: Sequence[Tensor]) -> Tensor:
    """Patch-to-patch aggregation (the second half of
    ``FeatureCorrelator``): ``out[i] = sum_k WeightNet(zq[j] - zq[i]) *
    p2p[j]`` over the frame-1 neighbours ``j = idx[i, k]``.

    Args:
      p2p: ``[B, N, C]`` point-to-patch cost, float32 or bfloat16 (the bf16
        arm, which reads it in bf16 and sums in float32).
      idx: ``[B, N, K]`` int32 frame-1 kNN indices, any K >= 1.
      zq: ``[B, N, H]`` float32, the WeightNet's first product of the
        centred frame-1 coordinates.
      wn: the WeightNet after its first product, ``(b0, w1, b1, w2, b2)``.
    Returns:
      ``[B, N, C]`` float32.
    """
    wn = list(wn)
    if not _on_card("cost_volume_agg", [zq, *wn], [idx], [p2p]):
        return cost_volume_agg_plain(p2p, idx, zq, wn)
    b, n, c = p2p.shape
    k = idx.shape[2]
    _check_cv(b, n, c, k, idx, zq, wn)
    if cv_agg_arm(c) == GENERIC:
        return _cv_agg_generic(p2p, idx, zq, wn)
    out = torch.empty((b, n, c), dtype=torch.float32, device=p2p.device)
    _check_kernel_args("cost_volume_agg", [p2p, idx, zq, *wn])
    lib = build.load("cost_volume", _SIGNATURES["cost_volume"])
    bf16 = p2p.dtype == torch.bfloat16
    code = (lib.cmflow_cv_agg_bf16 if bf16 else lib.cmflow_cv_agg)(
        p2p.data_ptr(), idx.data_ptr(), zq.data_ptr(),
        *[t.data_ptr() for t in wn], out.data_ptr(), b, n, k, c,
        _stream(p2p))
    build.check(lib, code, "cost_volume_agg")
    cost_volume_agg.launches += 1
    return out


def _cv_agg_generic(p2p: Tensor, idx: Tensor, zq: Tensor,
                    wn: Sequence[Tensor]) -> Tensor:
    """K4b at any width (the wrapper's generic arm; the checks are the
    wrapper's): one launch of ``cv_agg_any_kernel`` in chunks of the row
    (:func:`cv_agg_plan`), counted in ``launches`` and
    ``launches_generic``.  p2p may start anywhere (the kernel copies its
    rows in pieces their starts allow); the small tensors it reads as
    float4s are copied where they are not 16-byte aligned."""
    b, n, c = p2p.shape
    p2p, idx = p2p.contiguous(), idx.contiguous()
    zq = _aligned(zq)
    wn = [_aligned(t) if i < 3 or c % 4 == 0 else t.contiguous()
          for i, t in enumerate(wn)]
    plan = cv_agg_plan(c, b, n, _sms(p2p.device))
    out = torch.empty((b, n, c), dtype=torch.float32, device=p2p.device)
    lib = build.load("cost_volume", _SIGNATURES["cost_volume"])
    code = lib.cmflow_cv_agg_any(
        int(p2p.dtype == torch.bfloat16), p2p.data_ptr(), idx.data_ptr(),
        zq.data_ptr(), *[t.data_ptr() for t in wn], out.data_ptr(), b, n,
        idx.shape[2], c, plan["cells"], plan["per"], _stream(p2p))
    build.check(lib, code, "cost_volume_agg (any C)")
    cost_volume_agg.launches += 1
    cost_volume_agg.launches_generic += 1
    return out


# every launch, and those of the generic arm (any C but CV_WIDTH)
cost_volume_agg.launches = 0
cost_volume_agg.launches_generic = 0


def _check_cv(b: int, n: int, c: int, k: int, idx: Tensor, z: Tensor,
              wn: Sequence[Tensor]) -> None:
    """The shapes K4a and K4b take, any C and any K >= 1: a WeightNet
    8 -> 8 -> C (its hidden width is fixed, as in the JAX package)."""
    h = WEIGHTNET_HIDDEN
    if tuple(z.shape) != (b, n, h) or tuple(wn[3].shape) != (h, c):
        raise ValueError(f"the CUDA kernels take a WeightNet {h}->{h}->C, "
                         f"got C={c}, z {tuple(z.shape)}, w2 "
                         f"{tuple(wn[3].shape)}")
    if tuple(idx.shape[:2]) != (b, n) or k < 1:
        raise ValueError(f"idx must be [B, N, K] with K >= 1, got "
                         f"{tuple(idx.shape)}")


def fused_cost_volume(f1t: Tensor, f2t: Tensor, idx2: Tensor, xyz1: Tensor,
                      idx1: Tensor, xyz2: Tensor, *,
                      dense: Sequence[Tensor], wn1: Sequence[Tensor],
                      wn2: Sequence[Tensor]) -> Tensor:
    """``FeatureCorrelator`` eval forward: point-to-patch
    (:func:`cost_volume_p2p`), then patch-to-patch
    (:func:`cost_volume_agg`); the ``[B, N, C]`` point-to-patch cost goes
    through device memory between the two.

    Args:
      f1t / f2t: ``[B, N, C]`` transformed features (``f @ w0[:d1]`` /
        ``f @ w0[d1:d1+d2]``), float32 or bfloat16 (the bf16 arms, with
        ``wd``, ``w1`` and ``w2`` of ``dense`` in bfloat16).
      idx2: frame-2 kNN indices ``[B, N, K]``; idx1: frame-1 (self) kNN.
      xyz1 / xyz2: ``[B, N, 3]`` float32 coordinates.
      dense / wn1 / wn2: from :func:`cv_params_from_variables`.
    Returns:
      ``[B, N, C]`` float32 aggregated cost volume.
    """
    f1c, f2c, z1, z2, zq = cost_volume_folds(f1t, f2t, xyz1, xyz2,
                                             dense[0], wn1[0], wn2[0],
                                             f1t.dtype)
    p2p = cost_volume_p2p(f1c, f2c, idx2, z1, z2, dense[1:], wn1[1:])
    return cost_volume_agg(p2p, idx1, zq, wn2[1:])


def cost_volume_folds(f1t: Tensor, f2t: Tensor, xyz1: Tensor, xyz2: Tensor,
                      wd: Tensor, wn1_w0: Tensor, wn2_w0: Tensor,
                      dtype: torch.dtype = torch.float32
                      ) -> Tuple[Tensor, ...]:
    """The kernels' folded inputs ``(f1c, f2c, z1, z2, zq)``:
    ``f1c = f1t - x1c @ wd``, ``f2c = f2t + x2c @ wd`` (in float32 from
    ``wd`` as it comes, bf16 values included, then stored in ``dtype``),
    ``z1 = x1c @ wn1_w0``, ``z2 = x2c @ wn1_w0``, ``zq = x1c @ wn2_w0``
    (float32), with both clouds centred on the mean of frame 1 over all N
    (padding included).  The direction ``xyz2[j] - xyz1[i]`` is unchanged
    by any shared shift, so the folds are exact."""
    ctr = xyz1.mean(dim=1, keepdim=True)
    x1c, x2c = xyz1 - ctr, xyz2 - ctr
    wd = wd.float()
    return ((f1t.float() - x1c @ wd).to(dtype),
            (f2t.float() + x2c @ wd).to(dtype), x1c @ wn1_w0, x2c @ wn1_w0,
            x1c @ wn2_w0)
