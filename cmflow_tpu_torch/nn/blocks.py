"""Neural building blocks, channels-last.

Counterpart of ``cmflow_tpu/nn/blocks.py``.  Every 1x1 convolution of the
reference is a ``Linear`` over the trailing channel axis.  Submodules carry
the flax names (``dense_0``, ``bn_0``, ``w0``, ...), so that
:mod:`cmflow_tpu_torch.models.convert` maps a flax variable tree onto them
path by path.

Every forward takes ``train``: :class:`BatchNorm` then normalises with the
batch statistics and updates its running statistics, as flax's
``BatchNorm(use_running_average=False, momentum=0.9)`` does.

The factored first layers of :class:`PointLocalFeature` and
:class:`FeatureCorrelator` keep the JAX package's algebra: the first layer is
linear in ``concat(rel_xyz, feat[idx])``, so it is applied per point and the
result gathered, with the xyz term folded into the gathered base
(``gather(f + xyz@W) - xyz@W``).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn

from cmflow_tpu_torch.ops import pointops

Tensor = torch.Tensor

def init_uniform_(t: Tensor, fan_in: int, generator: torch.Generator) -> None:
    """PyTorch's default Conv2d/Linear init, ``U(-1/sqrt(fan_in), +)`` for
    weights and biases alike (kaiming-uniform with a=sqrt(5))."""
    bound = 1.0 / math.sqrt(fan_in)
    with torch.no_grad():
        t.uniform_(-bound, bound, generator=generator)


class BatchNorm(nn.Module):
    """Channels-last BatchNorm with running statistics, in the flax order:
    ``(x - mean) * (rsqrt(var + eps) * scale) + bias``.

    Eval mode takes the running statistics.  Train mode takes the statistics
    of the batch over every axis but the last (the ``B*N*K`` rows of a
    grouped chain), the variance biased and computed as flax 0.12 does
    (``use_fast_variance``): ``max(E[x^2] - E[x]^2, 0)``; the gradient flows
    through both.  It then updates ``running = momentum * running +
    (1 - momentum) * batch`` with the same biased variance (flax momentum
    0.9; ``F.batch_norm`` would feed the unbiased variance in)."""

    MOMENTUM = 0.9

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: Tensor, train: bool) -> Tensor:
        if not train:
            mean, var = self.running_mean, self.running_var
        else:
            axes = tuple(range(x.dim() - 1))
            mean = x.mean(dim=axes)
            var = torch.clamp_min((x * x).mean(dim=axes) - mean * mean, 0.0)
            with torch.no_grad():
                m = self.MOMENTUM
                self.running_mean.copy_(m * self.running_mean
                                        + (1 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1 - m) * var)
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean) * mul + self.bias


class PointwiseMLP(nn.Module):
    """Stack of [Linear -> (BatchNorm) -> ReLU or LeakyReLU] over the channel
    axis.  ``use_bn=True, use_bias=False`` is the reference's
    ``Conv2d(bias=False) + BatchNorm2d + ReLU``; ``use_bn=False`` keeps the
    conv bias."""

    def __init__(self, in_ch: int, features: Sequence[int], use_bn: bool = True,
                 use_bias: bool = False, negative_slope: float = 0.0):
        super().__init__()
        self.depth = len(features)
        self.use_bn = use_bn
        self.negative_slope = negative_slope
        for i, width in enumerate(features):
            self.add_module(f"dense_{i}", nn.Linear(in_ch, width, bias=use_bias))
            if use_bn:
                self.add_module(f"bn_{i}", BatchNorm(width))
            in_ch = width

    def forward(self, x: Tensor, train: bool) -> Tensor:
        for i in range(self.depth):
            x = getattr(self, f"dense_{i}")(x)
            if self.use_bn:
                x = getattr(self, f"bn_{i}")(x, train)
            if self.negative_slope > 0:
                x = nn.functional.leaky_relu(x, self.negative_slope)
            else:
                x = torch.relu(x)
        return x


class PointLocalFeature(nn.Module):
    """Ball-query local feature abstraction: grouped first layer -> BN ->
    ReLU -> mlp -> max over neighbours -> mlp2 (radarflow_util.py:121-162)."""

    def __init__(self, radius: float, nsample: int, in_ch: int,
                 mlp: Sequence[int], mlp2: Sequence[int]):
        super().__init__()
        self.radius = radius
        self.nsample = nsample
        c1 = mlp[0]
        # kept [in, out]: the first three rows act on xyz, the rest on the
        # features
        self.w0 = nn.Parameter(torch.empty(in_ch + 3, c1))
        self.bn0 = BatchNorm(c1)
        self.mlp = PointwiseMLP(c1, mlp[1:]) if len(mlp) > 1 else None
        self.mlp2 = PointwiseMLP(mlp[-1], mlp2)

    def forward(self, xyz: Tensor, features: Tensor, train: bool,
                valid: Optional[Tensor] = None) -> Tensor:
        idx = pointops.ball_query(self.radius, self.nsample, xyz, xyz, valid)
        # centred by the mean over ALL N points, padding included, as in
        # the JAX package; the centre cancels exactly in the algebra
        xyz_c = xyz - xyz.mean(dim=1, keepdim=True)
        off = xyz_c @ self.w0[:3]
        base = features @ self.w0[3:] + off
        pre = pointops.group_points(base, idx) - off[:, :, None, :]
        h = torch.relu(self.bn0(pre, train))
        if self.mlp is not None:
            h = self.mlp(h, train)
        h = torch.amax(h, dim=2)  # max over neighbours
        return self.mlp2(h, train)  # [B, N, mlp2[-1]]


class MultiScaleEncoder(nn.Module):
    """Concatenation of per-radius :class:`PointLocalFeature` branches
    (radarflow_util.py:101-118)."""

    def __init__(self, radii: Sequence[float], nsamples: Sequence[int],
                 in_ch: int, mlp: Sequence[int], mlp2: Sequence[int]):
        super().__init__()
        self.scales = len(radii)
        for i, (r, k) in enumerate(zip(radii, nsamples)):
            self.add_module(f"scale_{i}",
                            PointLocalFeature(r, k, in_ch, mlp, mlp2))

    def forward(self, xyz: Tensor, features: Tensor, train: bool,
                valid: Optional[Tensor] = None) -> Tensor:
        outs = [getattr(self, f"scale_{i}")(xyz, features, train, valid)
                for i in range(self.scales)]
        return torch.cat(outs, dim=-1)


class WeightNet(nn.Module):
    """Small MLP from 3-D offsets to per-neighbour weights, ReLU after every
    layer including the last (radarflow_util.py:287-318)."""

    def __init__(self, out_channel: int, hidden: Sequence[int] = (8, 8)):
        super().__init__()
        widths = list(hidden) + [out_channel]
        self.depth = len(widths)
        in_ch = 3
        for i, width in enumerate(widths):
            self.add_module(f"dense_{i}", nn.Linear(in_ch, width))
            in_ch = width

    def forward(self, offsets: Tensor) -> Tensor:
        x = offsets
        for i in range(self.depth):
            x = torch.relu(getattr(self, f"dense_{i}")(x))
        return x


class FeatureCorrelator(nn.Module):
    """Point-to-patch plus patch-to-patch cost volume
    (radarflow_util.py:164-237; no BN, LeakyReLU(0.1), conv bias on).

    ``w0`` is the single ``[D1+D2+3, C]`` first-layer kernel, sliced by rows
    into the frame-1, frame-2 and direction blocks; ``b0`` its bias."""

    def __init__(self, nsample: int, d1: int, d2: int, mlp: Sequence[int]):
        super().__init__()
        self.nsample = nsample
        self.d1, self.d2 = d1, d2
        c1 = mlp[0]
        self.w0 = nn.Parameter(torch.empty(d1 + d2 + 3, c1))
        self.b0 = nn.Parameter(torch.empty(c1))
        self.mlp = (PointwiseMLP(c1, mlp[1:], use_bn=False, use_bias=True,
                                 negative_slope=0.1)
                    if len(mlp) > 1 else None)
        self.weightnet1 = WeightNet(mlp[-1])
        self.weightnet2 = WeightNet(mlp[-1])

    def forward(self, xyz1: Tensor, xyz2: Tensor, points1: Tensor,
                points2: Tensor, train: bool,
                valid1: Optional[Tensor] = None,
                valid2: Optional[Tensor] = None) -> Tensor:
        k, d1, d2 = self.nsample, self.d1, self.d2

        # point-to-patch volume over frame-2 neighbourhoods
        knn_idx = pointops.knn(k, xyz1, xyz2, valid2)  # [B, N1, K]
        direction = (pointops.group_points(xyz2, knn_idx)
                     - xyz1[:, :, None, :])
        f1_tx = points1 @ self.w0[:d1]
        f2_tx = points2 @ self.w0[d1:d1 + d2]
        # direction @ wd folded into the frame-2 gather around one shared
        # centre, the mean of frame 1 (padding included)
        center = xyz1.mean(dim=1, keepdim=True)
        wd = self.w0[d1 + d2:]
        base2 = f2_tx + (xyz2 - center) @ wd
        point_term = f1_tx - (xyz1 - center) @ wd + self.b0
        pre = point_term[:, :, None, :] + pointops.group_points(base2, knn_idx)
        new_points = nn.functional.leaky_relu(pre, 0.1)
        if self.mlp is not None:
            new_points = self.mlp(new_points, train)
        weights = self.weightnet1(direction)
        point_to_patch = torch.sum(weights * new_points, dim=2)  # [B, N1, C]

        # patch-to-patch aggregation over frame-1 neighbourhoods
        knn_idx = pointops.knn(k, xyz1, xyz1, valid1)
        direction = (pointops.group_points(xyz1, knn_idx)
                     - xyz1[:, :, None, :])
        weights = self.weightnet2(direction)
        grouped_cost = pointops.group_points(point_to_patch, knn_idx)
        return torch.sum(weights * grouped_cost, dim=2)  # [B, N1, C]


class FlowHead(nn.Module):
    """Scene-flow regression head (radarflow_util.py:240-261)."""

    def __init__(self, in_ch: int, mlp: Sequence[int]):
        super().__init__()
        self.mlp = PointwiseMLP(in_ch, mlp)
        self.out = nn.Linear(mlp[-1], 3, bias=False)

    def forward(self, feat: Tensor, train: bool) -> Tensor:
        return self.out(self.mlp(feat, train))


class MotionHead(nn.Module):
    """Static/moving classification head (radarflow_util.py:263-285):
    probabilities in (0, 1), ``[B, N]``."""

    def __init__(self, in_ch: int, mlp: Sequence[int]):
        super().__init__()
        self.mlp = PointwiseMLP(in_ch, mlp)
        self.out = nn.Linear(mlp[-1], 1, bias=False)

    def forward(self, feat: Tensor, train: bool) -> Tensor:
        return torch.sigmoid(self.out(self.mlp(feat, train)))[..., 0]


class GRUCell(nn.Module):
    """flax's ``nn.GRUCell`` (the JAX package's CMFlow_T GRU): gate order r,
    z, n; input Denses ``ir``, ``iz``, ``in`` with biases; hidden Denses
    ``hr``, ``hz`` without bias and ``hn`` with its own bias, applied inside
    ``r * (h @ W_hn + b_hn)``.  ``torch.nn.GRUCell`` keeps a hidden bias on
    every gate, so it is not this function's parametrisation.

    ``forward(h, x) -> h_new``, both ``[B, features]``."""

    def __init__(self, features: int):
        super().__init__()
        self.features = features
        for name in ("ir", "iz", "in"):  # "in" is a keyword: add_module
            self.add_module(name, nn.Linear(features, features))
        self.hr = nn.Linear(features, features, bias=False)
        self.hz = nn.Linear(features, features, bias=False)
        self.hn = nn.Linear(features, features)

    def init_(self, generator: torch.Generator) -> None:
        """flax's initialisers: lecun-normal input kernels (a normal
        truncated at two deviations, rescaled to variance ``1 / fan_in``),
        orthogonal recurrent kernels, zero biases."""
        std = math.sqrt(1.0 / self.features) / 0.87962566103423978
        with torch.no_grad():
            for name in ("ir", "iz", "in"):
                lin = getattr(self, name)
                nn.init.trunc_normal_(lin.weight, std=std, a=-2.0 * std,
                                      b=2.0 * std, generator=generator)
                lin.bias.zero_()
            for lin in (self.hr, self.hz, self.hn):
                nn.init.orthogonal_(lin.weight, generator=generator)
            self.hn.bias.zero_()

    def forward(self, h: Tensor, x: Tensor) -> Tensor:
        r = torch.sigmoid(self.ir(x) + self.hr(h))
        z = torch.sigmoid(self.iz(x) + self.hz(h))
        n = torch.tanh(getattr(self, "in")(x) + r * self.hn(h))
        return (1.0 - z) * n + z * h


def masked_global_max(features: Tensor, valid: Optional[Tensor]) -> Tensor:
    """Max over points ``[B, N, C] -> [B, C]``, padded points excluded."""
    if valid is not None:
        features = torch.where(valid[..., None], features, -math.inf)
    return torch.amax(features, dim=1)


def init_parameters(module: nn.Module, generator: torch.Generator) -> None:
    """Draw every weight of ``module`` from ``generator`` with PyTorch's
    default Conv2d/Linear recipe (the reference never applies its own
    ``weights_init``); BatchNorm starts at scale 1, bias 0, mean 0, var 1.
    Modules are visited in registration order, so the draw is reproducible.
    A :class:`GRUCell` takes flax's initialisers (:meth:`GRUCell.init_`)."""
    gru_parts = set()
    for m in module.modules():
        if id(m) in gru_parts:
            continue
        if isinstance(m, GRUCell):
            m.init_(generator)
            gru_parts.update(id(c) for c in m.modules())
        elif isinstance(m, nn.Linear):
            init_uniform_(m.weight, m.in_features, generator)
            if m.bias is not None:
                init_uniform_(m.bias, m.in_features, generator)
        elif isinstance(m, PointLocalFeature):
            init_uniform_(m.w0, m.w0.shape[0], generator)
        elif isinstance(m, FeatureCorrelator):
            init_uniform_(m.w0, m.w0.shape[0], generator)
            init_uniform_(m.b0, m.w0.shape[0], generator)
        elif isinstance(m, BatchNorm):
            with torch.no_grad():
                m.weight.fill_(1.0)
                m.bias.zero_()
                m.running_mean.zero_()
                m.running_var.fill_(1.0)
