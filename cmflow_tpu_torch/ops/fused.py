"""Row gather behind ``group_points``, with its plain PyTorch version.

Counterpart of ``cmflow_tpu/ops/fused.py::mxu_gather_rows`` /
``mxu_group_points`` (forward only).  A CUDA tensor goes to the kernel in
``csrc/gather.cu``; a CPU tensor goes to :func:`gather_rows_plain`.  An index
outside ``[0, N)`` gives a zero row, as the JAX package's one-hot gather does.
"""

from __future__ import annotations

import ctypes

import torch

from cmflow_tpu_torch.native import build

Tensor = torch.Tensor

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "cmflow_gather_rows": (_P, _P, _P, _I, _I, _I, _I, _I, _P),
}


def gather_rows_plain(points: Tensor, idx: Tensor) -> Tensor:
    """Plain version of :func:`gather_rows`."""
    b, n, c = points.shape
    m = idx.shape[1]
    inside = (idx >= 0) & (idx < n)
    safe = torch.where(inside, idx, 0).long()
    rows = torch.gather(points, 1, safe[..., None].expand(b, m, c))
    return torch.where(inside[..., None], rows, 0.0)


def gather_rows(points: Tensor, idx: Tensor) -> Tensor:
    """``out[b, m] = points[b, idx[b, m]]``.

    Args:
      points: ``[B, N, C]`` float32.
      idx: ``[B, M]`` int32; an index outside ``[0, N)`` gives a zero row.
    Returns:
      ``[B, M, C]`` float32.
    """
    if points.dim() != 3 or idx.dim() != 2 or idx.shape[0] != points.shape[0]:
        raise ValueError(f"need points [B, N, C] and idx [B, M], got "
                         f"{tuple(points.shape)} and {tuple(idx.shape)}")
    if points.dtype != torch.float32 or idx.dtype != torch.int32:
        raise TypeError(f"need float32 points and int32 idx, got "
                        f"{points.dtype} and {idx.dtype}")
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
    vec4 = (c % 4 == 0 and points.data_ptr() % 16 == 0
            and out.data_ptr() % 16 == 0)
    lib = build.load("gather", _SIGNATURES)
    code = lib.cmflow_gather_rows(
        points.data_ptr(), idx.data_ptr(), out.data_ptr(), b, n, m, c,
        int(vec4), torch.cuda.current_stream(points.device).cuda_stream)
    build.check(lib, code, "gather_rows")
    gather_rows.launches += 1
    return out


gather_rows.launches = 0
