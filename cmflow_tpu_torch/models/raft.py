"""RAFT-small optical flow (inference) in PyTorch, NCHW.

The counterpart of ``cmflow_tpu/models/raft.py``: the public RAFT-small
(Teed & Deng, ECCV'20) that the preprocessing runs for the camera modality.

* feature net: 1/8-resolution 128-d features, instance norm;
* context net: 160-d (96 hidden + 64 context), no norm;
* 4-level all-pairs correlation pyramid, lookup radius 3;
* ConvGRU update block, 12 iterations, bilinear 8x upsampling.

The submodules carry the official torch RAFT names (``fnet.layer1.0.conv1``,
``update_block.gru.convz``, ...), so the public ``raft-small.pth`` loads
with ``load_state_dict(strict=True)`` once its ``module.`` prefix is
stripped (``models/convert.py::load_raft_small``).  The all-pairs product
is one batched matrix product on cuBLAS and the convolutions run on cuDNN:
RAFT has no Pallas kernel in the JAX package, so it has no hand-written
kernel here.
"""

from __future__ import annotations

import math
from typing import List

import torch
import torch.nn.functional as F
from torch import Tensor, nn


def instance_norm(x: Tensor, eps: float = 1e-5) -> Tensor:
    """Non-affine instance norm over the spatial dims, biased variance
    (``nn.InstanceNorm2d(affine=False)``)."""
    mean = x.mean(dim=(2, 3), keepdim=True)
    var = x.var(dim=(2, 3), unbiased=False, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps)


class BottleneckBlock(nn.Module):
    def __init__(self, in_planes: int, planes: int, stride: int = 1,
                 norm: str = "instance"):
        super().__init__()
        q = planes // 4
        self.norm = norm
        self.conv1 = nn.Conv2d(in_planes, q, 1)
        # torch pads the strided 3x3 symmetrically, (1, 1)
        self.conv2 = nn.Conv2d(q, q, 3, stride=stride, padding=1)
        self.conv3 = nn.Conv2d(q, planes, 1)
        if stride != 1 or in_planes != planes:
            self.downsample = nn.Sequential(
                nn.Conv2d(in_planes, planes, 1, stride=stride))
        else:
            self.downsample = None

    def _norm(self, x: Tensor) -> Tensor:
        return instance_norm(x) if self.norm == "instance" else x

    def forward(self, x: Tensor) -> Tensor:
        y = F.relu(self._norm(self.conv1(x)))
        y = F.relu(self._norm(self.conv2(y)))
        y = F.relu(self._norm(self.conv3(y)))
        if self.downsample is not None:
            x = self._norm(self.downsample(x))
        return F.relu(x + y)


class SmallEncoder(nn.Module):
    def __init__(self, output_dim: int = 128, norm: str = "instance"):
        super().__init__()
        self.norm = norm
        self.conv1 = nn.Conv2d(3, 32, 7, stride=2, padding=3)
        self.layer1 = self._layer(32, 32, 1)
        self.layer2 = self._layer(32, 64, 2)
        self.layer3 = self._layer(64, 96, 2)
        self.conv2 = nn.Conv2d(96, output_dim, 1)

    def _layer(self, in_planes: int, planes: int, stride: int):
        return nn.Sequential(
            BottleneckBlock(in_planes, planes, stride, self.norm),
            BottleneckBlock(planes, planes, 1, self.norm))

    def forward(self, x: Tensor) -> Tensor:
        x = self.conv1(x)
        if self.norm == "instance":
            x = instance_norm(x)
        x = F.relu(x)
        x = self.layer3(self.layer2(self.layer1(x)))
        return self.conv2(x)


class SmallMotionEncoder(nn.Module):
    def __init__(self, corr_channels: int = 4 * (2 * 3 + 1) ** 2):
        super().__init__()
        self.convc1 = nn.Conv2d(corr_channels, 96, 1)
        self.convf1 = nn.Conv2d(2, 64, 7, padding=3)
        self.convf2 = nn.Conv2d(64, 32, 3, padding=1)
        self.conv = nn.Conv2d(128, 80, 3, padding=1)

    def forward(self, flow: Tensor, corr: Tensor) -> Tensor:
        c = F.relu(self.convc1(corr))
        v = F.relu(self.convf2(F.relu(self.convf1(flow))))
        out = F.relu(self.conv(torch.cat([c, v], dim=1)))
        return torch.cat([out, flow], dim=1)  # [B, 82, H, W]


class ConvGRU(nn.Module):
    def __init__(self, hidden: int = 96, input_dim: int = 82 + 64):
        super().__init__()
        self.convz = nn.Conv2d(hidden + input_dim, hidden, 3, padding=1)
        self.convr = nn.Conv2d(hidden + input_dim, hidden, 3, padding=1)
        self.convq = nn.Conv2d(hidden + input_dim, hidden, 3, padding=1)

    def forward(self, h: Tensor, x: Tensor) -> Tensor:
        hx = torch.cat([h, x], dim=1)
        z = torch.sigmoid(self.convz(hx))
        r = torch.sigmoid(self.convr(hx))
        q = torch.tanh(self.convq(torch.cat([r * h, x], dim=1)))
        return (1 - z) * h + z * q


class FlowHead(nn.Module):
    def __init__(self, input_dim: int = 96, hidden: int = 128):
        super().__init__()
        self.conv1 = nn.Conv2d(input_dim, hidden, 3, padding=1)
        self.conv2 = nn.Conv2d(hidden, 2, 3, padding=1)

    def forward(self, h: Tensor) -> Tensor:
        return self.conv2(F.relu(self.conv1(h)))


class SmallUpdateBlock(nn.Module):
    def __init__(self, hidden: int = 96):
        super().__init__()
        self.encoder = SmallMotionEncoder()
        self.gru = ConvGRU(hidden, 82 + 64)
        self.flow_head = FlowHead(hidden, 128)

    def forward(self, net, inp, corr, flow):
        motion = self.encoder(flow, corr)
        net = self.gru(net, torch.cat([inp, motion], dim=1))
        return net, self.flow_head(net)


def bilinear_sample(img: Tensor, coords: Tensor) -> Tensor:
    """Zero-padded bilinear sampling at pixel coordinates, exact on the
    grid: four clipped, masked gathers (not ``F.grid_sample``, which
    normalises by ``W - 1`` and turns a 1x1 level into NaN), the four
    corners taken by one ``torch.gather``.

    Args:
      img: ``[B, C, H, W]``.
      coords: ``[B, N, 2]`` (x, y) float pixel coordinates.
    Returns:
      ``[B, C, N]``.
    """
    b, c, h, w = img.shape
    n = coords.shape[1]
    x, y = coords[..., 0], coords[..., 1]
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    wx = (x - x0)[:, None]
    wy = (y - y0)[:, None]
    # corners (x0, y0), (x0 + 1, y0), (x0, y0 + 1), (x0 + 1, y0 + 1)
    x1, y1 = x0 + 1, y0 + 1
    xs = torch.stack([x0, x1, x0, x1], dim=1)  # [B, 4, N]
    ys = torch.stack([y0, y0, y1, y1], dim=1)
    inb = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
    idx = (torch.clamp(ys, 0, h - 1).long() * w
           + torch.clamp(xs, 0, w - 1).long())
    vals = torch.gather(img.reshape(b, c, h * w), 2,
                        idx.reshape(b, 1, 4 * n).expand(b, c, 4 * n))
    vals = vals.reshape(b, c, 4, n) * inb[:, None]
    v00, v01, v10, v11 = vals.unbind(2)
    top = v00 * (1 - wx) + v01 * wx
    bot = v10 * (1 - wx) + v11 * wx
    return top * (1 - wy) + bot * wy


def corr_pyramid(fmap1: Tensor, fmap2: Tensor,
                 num_levels: int = 4) -> List[Tensor]:
    """All-pairs correlation over ``sqrt(D)`` and its average-pool pyramid.

    Args:
      fmap1, fmap2: ``[B, D, H, W]``.
    Returns:
      ``num_levels`` volumes ``[B*H*W, 1, H/2^i, W/2^i]`` (floor sizes).
    """
    b, d, h1, w1 = fmap1.shape
    _, _, h2, w2 = fmap2.shape
    corr = torch.matmul(fmap1.reshape(b, d, h1 * w1).transpose(1, 2),
                        fmap2.reshape(b, d, h2 * w2))
    # in place (the volume is the largest tensor), by a tensor: a CPU
    # scalar divisor becomes a product with its reciprocal on the card
    corr.div_(torch.tensor(math.sqrt(d), dtype=corr.dtype,
                           device=corr.device))
    corr = corr.reshape(b * h1 * w1, 1, h2, w2)
    pyramid = [corr]
    for _ in range(num_levels - 1):
        corr = F.avg_pool2d(corr, 2, stride=2)
        pyramid.append(corr)
    return pyramid


def corr_lookup(pyramid: List[Tensor], coords: Tensor,
                radius: int = 3) -> Tensor:
    """Sample the pyramid in a ``(2r+1)^2`` window around ``coords``.

    The channel order is torch RAFT's: channel ``k = i*(2r+1) + j`` of a
    level takes x offset ``v_i`` and y offset ``v_j`` (``meshgrid``'s
    ``ij`` indexing of the two offset ranges); the transposed window runs
    and gives wrong flow under converted ``raft-small.pth`` weights.

    Args:
      coords: ``[B, 2, H1, W1]`` (x, y) at 1/8 resolution.
    Returns:
      ``[B, num_levels*(2r+1)^2, H1, W1]``.
    """
    b, _, h1, w1 = coords.shape
    d = torch.arange(-radius, radius + 1, dtype=coords.dtype,
                     device=coords.device)
    delta = torch.stack(torch.meshgrid(d, d, indexing="ij"), dim=-1)
    delta = delta.reshape(1, -1, 2)  # [1, (2r+1)^2, (x, y)]
    flat = coords.permute(0, 2, 3, 1).reshape(b * h1 * w1, 1, 2)
    outs = [bilinear_sample(corr, flat / (2.0 ** i) + delta)[:, 0]
            for i, corr in enumerate(pyramid)]
    out = torch.cat(outs, dim=-1)  # [B*H1*W1, levels*(2r+1)^2]
    return out.reshape(b, h1, w1, -1).permute(0, 3, 1, 2).contiguous()


def upflow8(flow: Tensor) -> Tensor:
    """8x bilinear upsampling with ``align_corners=True``, the flow scaled
    by 8 (RAFT's ``upflow8``)."""
    _, _, h, w = flow.shape
    return 8.0 * F.interpolate(flow, size=(8 * h, 8 * w), mode="bilinear",
                               align_corners=True)


class RaftSmall(nn.Module):
    """Inference RAFT-small: ``forward(image1, image2, iters)`` -> flow
    ``[B, 2, H, W]`` at full resolution.

    Images: ``[B, 3, H, W]`` uint8 or float RGB in [0, 255], H and W
    multiples of 8.  The model computes in its parameters' dtype.
    """

    def __init__(self, hidden_dim: int = 96, context_dim: int = 64,
                 corr_levels: int = 4, corr_radius: int = 3):
        super().__init__()
        self.hidden_dim = hidden_dim
        self.context_dim = context_dim
        self.corr_levels = corr_levels
        self.corr_radius = corr_radius
        self.fnet = SmallEncoder(128, "instance")
        self.cnet = SmallEncoder(hidden_dim + context_dim, "none")
        self.update_block = SmallUpdateBlock(hidden_dim)

    def forward(self, image1: Tensor, image2: Tensor,
                iters: int = 12) -> Tensor:
        # cuDNN autotuned: its heuristics take FFT convolutions for the
        # GRU's 3x3s at VoD's size in float32, 6x slower (PERF.md).
        # PyTorch keeps the first plan it finds for a shape, autotuned or
        # not
        benchmark = torch.backends.cudnn.benchmark
        torch.backends.cudnn.benchmark = True
        try:
            return self._forward(image1, image2, iters)
        finally:
            torch.backends.cudnn.benchmark = benchmark

    def _forward(self, image1: Tensor, image2: Tensor, iters: int) -> Tensor:
        dtype = self.fnet.conv1.weight.dtype
        img1 = 2.0 * (image1.to(dtype) / 255.0) - 1.0
        img2 = 2.0 * (image2.to(dtype) / 255.0) - 1.0

        fmap1 = self.fnet(img1)
        fmap2 = self.fnet(img2)
        cmap = self.cnet(img1)
        net = torch.tanh(cmap[:, :self.hidden_dim])
        inp = F.relu(cmap[:, self.hidden_dim:])

        pyramid = corr_pyramid(fmap1, fmap2, self.corr_levels)

        b, _, h, w = fmap1.shape
        ys, xs = torch.meshgrid(
            torch.arange(h, dtype=dtype, device=fmap1.device),
            torch.arange(w, dtype=dtype, device=fmap1.device),
            indexing="ij")
        coords0 = torch.stack([xs, ys])[None].expand(b, 2, h, w)

        coords1 = coords0
        for _ in range(iters):
            corr = corr_lookup(pyramid, coords1, self.corr_radius)
            net, delta = self.update_block(net, inp, corr,
                                           coords1 - coords0)
            coords1 = coords1 + delta
        return upflow8(coords1 - coords0)


def init_raft_small(model: RaftSmall, generator: torch.Generator) -> None:
    """Draw every weight of ``model`` from ``generator`` as torch RAFT
    initialises it: the encoders' convolution weights Kaiming-normal
    (``fan_out``, ReLU), every other weight and every bias with PyTorch's
    default Conv2d recipe, ``U(-1/sqrt(fan_in), +)``.  Modules are visited
    in registration order, so the draw is reproducible."""
    encoders = {id(m) for enc in (model.fnet, model.cnet)
                for m in enc.modules()}
    with torch.no_grad():
        for m in model.modules():
            if not isinstance(m, nn.Conv2d):
                continue
            fan_in = m.in_channels * m.kernel_size[0] * m.kernel_size[1]
            bound = 1.0 / math.sqrt(fan_in)
            if id(m) in encoders:
                fan_out = (m.out_channels * m.kernel_size[0]
                           * m.kernel_size[1])
                m.weight.normal_(0.0, math.sqrt(2.0 / fan_out),
                                 generator=generator)
            else:
                m.weight.uniform_(-bound, bound, generator=generator)
            m.bias.uniform_(-bound, bound, generator=generator)
