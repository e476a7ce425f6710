"""Farthest-point sampling: the wrapper of ``csrc/sampling.cu`` and its plain
PyTorch version.

Counterpart of ``cmflow_tpu/ops/pointops.py::farthest_point_sample``, which
the JAX package runs as one ``lax.fori_loop`` on the device.  A CUDA tensor
goes to the kernel; a CPU tensor to the plain version, a Python loop over
the samples.  Both compute each squared distance as ``((dx*dx + dy*dy) +
dz*dz)``, each operation rounded on its own, and take the argmax with ties
to the lowest index, so their indices are bit-identical to each other and
to the JAX package's.
"""

from __future__ import annotations

import ctypes

import torch

from cmflow_tpu_torch.native import build

Tensor = torch.Tensor

# the running distance every point starts at (pointops.py's dist0)
INIT_DIST = 1e10

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "cmflow_fps": (_P, _I, _I, _I, _I, _P, _P, _P),
    "cmflow_fps_warps": (_I,),
    "cmflow_fps_register_points": (_I,),
}


def farthest_point_sample_plain(xyz: Tensor, npoint: int) -> Tensor:
    """Plain version of :func:`farthest_point_sample`: ``npoint`` steps,
    each a distance update and an argmax over the cloud."""
    b, n, _ = xyz.shape
    out = torch.empty((b, npoint), dtype=torch.int32, device=xyz.device)
    dist = torch.full((b, n), INIT_DIST, dtype=torch.float32,
                      device=xyz.device)
    far = torch.zeros(b, dtype=torch.long, device=xyz.device)
    rows = torch.arange(b, device=xyz.device)
    for i in range(npoint):
        out[:, i] = far
        diff = xyz - xyz[rows, far][:, None, :]
        dx, dy, dz = diff.unbind(-1)
        dist = torch.minimum(dist, (dx * dx + dy * dy) + dz * dz)
        far = torch.argmax(dist, dim=-1)
    return out


def farthest_point_sample(xyz: Tensor, npoint: int) -> Tensor:
    """Iterative farthest-point sampling seeded at index 0: ``[B, npoint]``
    int32 indices into ``xyz`` ``[B, N, 3]`` float32.  Each sample is the
    point farthest from all earlier ones (ties to the lowest index); past N
    samples the rest repeat index 0, as in the JAX package.  The kernel's
    warps a cloud are picked by N (``cmflow_fps_warps``)."""
    if xyz.dim() != 3 or xyz.shape[-1] != 3:
        raise ValueError(f"xyz must be [B, N, 3], got {tuple(xyz.shape)}")
    if xyz.dtype != torch.float32:
        raise TypeError("xyz must be float32")
    b, n, _ = xyz.shape
    if n < 1 or npoint < 1:
        raise ValueError(f"need N >= 1 and npoint >= 1, got N={n}, "
                         f"npoint={npoint}")
    if xyz.device.type == "cpu":
        return farthest_point_sample_plain(xyz, npoint)
    if xyz.device.type != "cuda":
        raise ValueError(f"unsupported device {xyz.device}")
    if not xyz.is_contiguous():
        raise ValueError("the CUDA kernel takes a contiguous xyz")
    lib = build.load("sampling", _SIGNATURES)
    warps = lib.cmflow_fps_warps(n)
    scratch = None
    if n > lib.cmflow_fps_register_points(warps):
        scratch = torch.empty((b, n), dtype=torch.float32, device=xyz.device)
    out = torch.empty((b, npoint), dtype=torch.int32, device=xyz.device)
    code = lib.cmflow_fps(
        xyz.data_ptr(), b, n, npoint, warps,
        None if scratch is None else scratch.data_ptr(), out.data_ptr(),
        torch.cuda.current_stream(xyz.device).cuda_stream)
    build.check(lib, code, "farthest_point_sample")
    farthest_point_sample.launches += 1
    return out


farthest_point_sample.launches = 0
