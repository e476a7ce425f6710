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

Compute dtype.  Each block takes ``dtype``: ``None`` computes in float32;
``torch.bfloat16`` is the JAX package's ``compute_dtype: bfloat16``, its
"auto" bf16 chain (``cmflow_tpu/nn/blocks.py``).  Parameters and BatchNorm
statistics stay float32 in both.  In bf16:

* a Dense (:func:`dense`) is flax's ``nn.Dense(dtype=bfloat16)``: input
  and kernel rounded to bf16, the products summed in float32 and rounded
  to a bf16 result, then the bf16 bias added in bf16;
* the factored first layers keep a float32 result of bf16 operands
  (``preferred_element_type=float32``), :func:`dot32`;
* BatchNorm computes in float32 and emits float32;
* each BN'd (or bias'd) activation is rounded back to bf16, except the last
  BN'd layer of a chain in train mode, the tensor that feeds a max-pool
  (:func:`round_boundary`);
* the gathered bases and the cost volume's point-to-patch cost are rounded
  to bf16 before their gathers, so K6 and K7 run their bf16 arms;
* the WeightNets and the heads end in float32.

Every product of bf16 operands, forward and backward, sums in float32
(:class:`_Dot32`): on the card cuBLAS with a float32 output, never a bf16
reduction.

Recomputation (``remat``, the JAX package's ``remat_wrap``): each
:class:`PointLocalFeature` of a :class:`MultiScaleEncoder` and the trunk's
:class:`FeatureCorrelator` run under :func:`remat_call`, which recomputes
them in the backward instead of keeping what their backward reads.
"""

from __future__ import annotations

import contextlib
import functools
import math
import threading
from typing import Callable, Optional, Sequence

import torch
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from cmflow_tpu_torch.ops import pointops
from cmflow_tpu_torch.parallel import mesh
from cmflow_tpu_torch.parallel.mesh import Group
from cmflow_tpu_torch.utils.config import check_remat

Tensor = torch.Tensor
DType = Optional[torch.dtype]


def mm32(a: Tensor, b: Tensor) -> Tensor:
    """``a @ b`` of 2-D operands holding bf16 or float32 values, as a
    float32 result summed in float32.  Two bf16 operands on the card go to
    cuBLAS with a float32 output (``out_dtype``), so no sum is reduced in
    bf16 (``out_dtype`` has no CPU kernel); otherwise both are widened
    (exactly) and multiplied in float32."""
    if a.is_cuda and a.dtype == b.dtype == torch.bfloat16:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


class _Dot32(torch.autograd.Function):
    """``x @ w`` (``x [..., K]``, ``w [K, M]``) summed in float32 and
    rounded to ``out_dtype``: JAX's ``dot_general`` on these operands with
    that result type.  The backward is JAX's transpose: each cotangent
    product summed in float32 too and rounded to its operand's dtype."""

    @staticmethod
    def forward(ctx, x: Tensor, w: Tensor, out_dtype: torch.dtype) -> Tensor:
        ctx.save_for_backward(x, w)
        out = mm32(x.reshape(-1, x.shape[-1]), w).to(out_dtype)
        return out.reshape(*x.shape[:-1], w.shape[1])

    @staticmethod
    def backward(ctx, g: Tensor):
        x, w = ctx.saved_tensors
        g2 = g.reshape(-1, g.shape[-1])
        gx = gw = None
        if ctx.needs_input_grad[0]:
            gx = mm32(g2, w.t()).to(x.dtype).reshape(x.shape)
        if ctx.needs_input_grad[1]:
            gw = mm32(x.reshape(-1, x.shape[-1]).t(), g2).to(w.dtype)
        return gx, gw, None


def dot32(x: Tensor, w: Tensor, dtype: DType) -> Tensor:
    """``x @ w`` with a float32 result: in float32 for ``dtype`` None, else
    both operands rounded to ``dtype`` and summed in float32 (the JAX
    package's ``einsum(..., preferred_element_type=float32)``)."""
    if dtype is None:
        return x @ w
    return _Dot32.apply(x.to(dtype), w.to(dtype), torch.float32)


def dense(lin: nn.Linear, x: Tensor, dtype: DType) -> Tensor:
    """``lin(x)`` as flax's ``nn.Dense(dtype=dtype)`` computes it: for
    ``dtype`` None in float32; else a ``dtype`` product of the rounded
    input and kernel (summed in float32) plus the rounded bias, added in
    ``dtype``."""
    if dtype is None:
        return lin(x)
    y = _Dot32.apply(x.to(dtype), lin.weight.t().to(dtype), dtype)
    return y if lin.bias is None else y + lin.bias.to(dtype)


def round_boundary(dtype: DType, train: bool, prepool: bool) -> bool:
    """Whether an activation is rounded back to ``dtype``: the JAX
    package's "auto" bf16 chain, every BN'd activation but, in train mode,
    the last BN'd layer of a chain (``prepool``, the tensor a max-pool
    takes), which stays float32: rounding it stalls bf16 training on the
    TPU (``docs/PERF.md``, "bf16 train-path convergence")."""
    return dtype is not None and not (train and prepool)


def leaky_relu(x: Tensor, slope: float) -> Tensor:
    """flax's ``leaky_relu``, ``where(x >= 0, x, slope * x)``: on a bf16
    ``x`` the slope is a bf16 constant and the product rounds to bf16, as
    JAX computes it."""
    if x.dtype == torch.float32:
        return nn.functional.leaky_relu(x, slope)
    return torch.where(x >= 0, x, x * torch.tensor(slope, dtype=x.dtype))


# ---------------------------------------------------------------------------
# remat modes.  ``True`` recomputes the whole wrapped module in the backward;
# ``"dots"`` keeps exactly the neighbour indices, every gather's output and
# every pre-BN product (the JAX package's REMAT_SAVED_NAMES: nbr_idx,
# grouped_dot, mlp_dot) and recomputes only the BatchNorm and activation
# chains between them, so no neighbour search, gather or product runs twice.
# ---------------------------------------------------------------------------

# "dots" saves the outputs of these ops: the neighbour searches and the
# gather (custom ops, ops/pointops.py) and every matrix product
_DOTS_SAVED_OPS = (torch.ops.cmflow.ball_query.default,
                   torch.ops.cmflow.knn.default,
                   torch.ops.cmflow.gather_rows.default)
_DOTS_SAVED_PRODUCTS = (torch.ops.aten.mm, torch.ops.aten.addmm,
                        torch.ops.aten.bmm)

# set while a wrapped module is recomputed in the backward (on the thread
# that recomputes it): the BatchNorms leave their running statistics alone
_remat_state = threading.local()


def recomputing() -> bool:
    """Whether a wrapped module is being recomputed in the backward."""
    return getattr(_remat_state, "active", False)


def _dots_policy(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    if op in _DOTS_SAVED_OPS or op.overloadpacket in _DOTS_SAVED_PRODUCTS:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def remat_call(remat, fn: Callable, *args):
    """``fn(*args)``, recomputed in the backward as ``remat`` says.

    Without a gradient recorded (``torch.is_grad_enabled()`` False) or with
    ``remat`` False it is a plain call.  Otherwise it runs under
    ``torch.utils.checkpoint.checkpoint(use_reentrant=False)``, for
    ``"dots"`` with a selective policy that saves the outputs of the ops
    above, the point ops dispatched as custom ops
    (:func:`cmflow_tpu_torch.ops.pointops.custom_ops`).  The recomputation
    gives the first run's bits, and the BatchNorms update their running
    statistics in the first run only (:func:`recomputing`).  Under data
    parallelism it issues the BatchNorms' ``all_reduce`` again; every
    rank's backward recomputes the same modules in the same order."""
    if not remat or not torch.is_grad_enabled():
        return fn(*args)
    runs = [0]
    # "dots" must see the neighbour searches and gathers as ops
    ops = (pointops.custom_ops if remat == "dots"
           else contextlib.nullcontext)

    def run(*a):
        runs[0] += 1
        if runs[0] == 1:
            with ops():
                return fn(*a)
        before = recomputing()
        _remat_state.active = True
        try:
            with ops():
                return fn(*a)
        finally:
            _remat_state.active = before

    extra = {}
    if remat == "dots":
        extra["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _dots_policy)
    return checkpoint(run, *args, use_reentrant=False,
                      preserve_rng_state=False, **extra)


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
    0.9; ``F.batch_norm`` would feed the unbiased variance in).

    A bf16 input is widened first: the statistics, the normalisation and
    the output are float32, as flax's ``BatchNorm`` (no ``dtype``) gives
    them for a bf16 input.

    ``group``: flax's ``axis_name``.  In train mode the batch mean and the
    mean of squares are then the mean over the ranks of the local ones (one
    ``all_reduce`` of both, ``[2C]``, a layer, with a gradient), so the
    running statistics update identically on every rank.  Every rank must
    hold as many rows.  Eval mode takes no collective."""

    MOMENTUM = 0.9

    def __init__(self, num_features: int, eps: float = 1e-5,
                 group: Group = None):
        super().__init__()
        self.eps = eps
        self.group = group
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: Tensor, train: bool) -> Tensor:
        x = x.float()
        if not train:
            mean, var = self.running_mean, self.running_var
        else:
            axes = tuple(range(x.dim() - 1))
            mean = x.mean(dim=axes)
            mean2 = (x * x).mean(dim=axes)
            if self.group is not None:
                stats = mesh.all_reduce_sum(torch.cat([mean, mean2]),
                                            self.group) / mesh.size(self.group)
                mean, mean2 = stats.split(mean.shape[0])
            var = torch.clamp_min(mean2 - mean * mean, 0.0)
            if not recomputing():  # a recomputation must not update twice
                with torch.no_grad():
                    m = self.MOMENTUM
                    self.running_mean.copy_(m * self.running_mean
                                            + (1 - m) * mean)
                    self.running_var.copy_(m * self.running_var
                                           + (1 - m) * var)
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean) * mul + self.bias


class PointwiseMLP(nn.Module):
    """Stack of [Linear -> (BatchNorm) -> ReLU or LeakyReLU] over the channel
    axis.  ``use_bn=True, use_bias=False`` is the reference's
    ``Conv2d(bias=False) + BatchNorm2d + ReLU``; ``use_bn=False`` keeps the
    conv bias.  ``dtype``: the compute dtype (module docstring); ``group``:
    the BatchNorms' (:class:`BatchNorm`)."""

    def __init__(self, in_ch: int, features: Sequence[int], use_bn: bool = True,
                 use_bias: bool = False, negative_slope: float = 0.0,
                 dtype: DType = None, group: Group = None):
        super().__init__()
        self.depth = len(features)
        self.use_bn = use_bn
        self.negative_slope = negative_slope
        self.dtype = dtype
        for i, width in enumerate(features):
            self.add_module(f"dense_{i}", nn.Linear(in_ch, width, bias=use_bias))
            if use_bn:
                self.add_module(f"bn_{i}", BatchNorm(width, group=group))
            in_ch = width

    def forward(self, x: Tensor, train: bool) -> Tensor:
        for i in range(self.depth):
            x = dense(getattr(self, f"dense_{i}"), x, self.dtype)
            if self.use_bn:
                x = getattr(self, f"bn_{i}")(x, train)
            if self.negative_slope > 0:
                x = leaky_relu(x, self.negative_slope)
            else:
                x = torch.relu(x)
            if round_boundary(self.dtype, train,
                              self.use_bn and i == self.depth - 1):
                x = x.to(self.dtype)
        return x


class PointLocalFeature(nn.Module):
    """Ball-query local feature abstraction: grouped first layer -> BN ->
    ReLU -> mlp -> max over neighbours -> mlp2 (radarflow_util.py:121-162)."""

    def __init__(self, radius: float, nsample: int, in_ch: int,
                 mlp: Sequence[int], mlp2: Sequence[int], dtype: DType = None,
                 group: Group = None):
        super().__init__()
        self.radius = radius
        self.nsample = nsample
        self.dtype = dtype
        c1 = mlp[0]
        # kept [in, out]: the first three rows act on xyz, the rest on the
        # features
        self.w0 = nn.Parameter(torch.empty(in_ch + 3, c1))
        self.bn0 = BatchNorm(c1, group=group)
        self.mlp = (PointwiseMLP(c1, mlp[1:], dtype=dtype, group=group)
                    if len(mlp) > 1 else None)
        self.mlp2 = PointwiseMLP(mlp[-1], mlp2, dtype=dtype, group=group)

    def forward(self, xyz: Tensor, features: Tensor, train: bool,
                valid: Optional[Tensor] = None) -> Tensor:
        idx = pointops.ball_query(self.radius, self.nsample, xyz, xyz, valid)
        # centred by the mean over ALL N points, padding included, as in
        # the JAX package; the centre cancels exactly in the algebra
        xyz_c = xyz - xyz.mean(dim=1, keepdim=True)
        off = dot32(xyz_c, self.w0[:3], self.dtype)
        base = dot32(features, self.w0[3:], self.dtype) + off
        if self.dtype is not None:
            # the gathered base and the offset in bf16: K6 and K7 take
            # their bf16 arms
            base, off = base.to(self.dtype), off.to(self.dtype)
        pre = pointops.group_points(base, idx) - off[:, :, None, :]
        h = torch.relu(self.bn0(pre, train))
        if round_boundary(self.dtype, train, self.mlp is None):
            h = h.to(self.dtype)
        if self.mlp is not None:
            h = self.mlp(h, train)
        h = torch.amax(h, dim=2)  # max over neighbours
        return self.mlp2(h, train)  # [B, N, mlp2[-1]]


class MultiScaleEncoder(nn.Module):
    """Concatenation of per-radius :class:`PointLocalFeature` branches
    (radarflow_util.py:101-118).  ``remat``: each branch runs under
    :func:`remat_call`."""

    def __init__(self, radii: Sequence[float], nsamples: Sequence[int],
                 in_ch: int, mlp: Sequence[int], mlp2: Sequence[int],
                 dtype: DType = None, group: Group = None, remat=False):
        super().__init__()
        check_remat(remat)
        self.scales = len(radii)
        self.remat = remat
        for i, (r, k) in enumerate(zip(radii, nsamples)):
            self.add_module(f"scale_{i}", PointLocalFeature(
                r, k, in_ch, mlp, mlp2, dtype=dtype, group=group))

    def forward(self, xyz: Tensor, features: Tensor, train: bool,
                valid: Optional[Tensor] = None) -> Tensor:
        outs = [remat_call(self.remat, getattr(self, f"scale_{i}"), xyz,
                           features, train, valid)
                for i in range(self.scales)]
        return torch.cat(outs, dim=-1)


class WeightNet(nn.Module):
    """Small MLP from 3-D offsets to per-neighbour weights, ReLU after every
    layer including the last (radarflow_util.py:287-318).  Its Denses take
    the compute dtype; the weights come out float32."""

    def __init__(self, out_channel: int, hidden: Sequence[int] = (8, 8),
                 dtype: DType = None):
        super().__init__()
        widths = list(hidden) + [out_channel]
        self.depth = len(widths)
        self.dtype = dtype
        in_ch = 3
        for i, width in enumerate(widths):
            self.add_module(f"dense_{i}", nn.Linear(in_ch, width))
            in_ch = width

    def forward(self, offsets: Tensor) -> Tensor:
        x = offsets
        for i in range(self.depth):
            x = torch.relu(dense(getattr(self, f"dense_{i}"), x, self.dtype))
        return x.float()


class FeatureCorrelator(nn.Module):
    """Point-to-patch plus patch-to-patch cost volume
    (radarflow_util.py:164-237; no BN, LeakyReLU(0.1), conv bias on).

    ``w0`` is the single ``[D1+D2+3, C]`` first-layer kernel, sliced by rows
    into the frame-1, frame-2 and direction blocks; ``b0`` its bias."""

    def __init__(self, nsample: int, d1: int, d2: int, mlp: Sequence[int],
                 dtype: DType = None):
        super().__init__()
        self.nsample = nsample
        self.d1, self.d2 = d1, d2
        self.dtype = dtype
        c1 = mlp[0]
        self.w0 = nn.Parameter(torch.empty(d1 + d2 + 3, c1))
        self.b0 = nn.Parameter(torch.empty(c1))
        self.mlp = (PointwiseMLP(c1, mlp[1:], use_bn=False, use_bias=True,
                                 negative_slope=0.1, dtype=dtype)
                    if len(mlp) > 1 else None)
        self.weightnet1 = WeightNet(mlp[-1], dtype=dtype)
        self.weightnet2 = WeightNet(mlp[-1], dtype=dtype)

    def forward(self, xyz1: Tensor, xyz2: Tensor, points1: Tensor,
                points2: Tensor, train: bool,
                valid1: Optional[Tensor] = None,
                valid2: Optional[Tensor] = None) -> Tensor:
        k, d1, d2, cdt = self.nsample, self.d1, self.d2, self.dtype

        # point-to-patch volume over frame-2 neighbourhoods
        knn_idx = pointops.knn(k, xyz1, xyz2, valid2)  # [B, N1, K]
        direction = (pointops.group_points(xyz2, knn_idx)
                     - xyz1[:, :, None, :])
        f1_tx = dot32(points1, self.w0[:d1], cdt)
        f2_tx = dot32(points2, self.w0[d1:d1 + d2], cdt)
        # direction @ wd folded into the frame-2 gather around one shared
        # centre, the mean of frame 1 (padding included)
        center = xyz1.mean(dim=1, keepdim=True)
        wd = self.w0[d1 + d2:]
        base2 = f2_tx + dot32(xyz2 - center, wd, cdt)
        point_term = f1_tx - dot32(xyz1 - center, wd, cdt) + self.b0
        if cdt is not None:  # the gathered base and its partner in bf16
            base2, point_term = base2.to(cdt), point_term.to(cdt)
        pre = point_term[:, :, None, :] + pointops.group_points(base2, knn_idx)
        new_points = leaky_relu(pre, 0.1)
        if self.mlp is not None:
            new_points = self.mlp(new_points, train)
        weights = self.weightnet1(direction)
        point_to_patch = torch.sum(weights * new_points, dim=2)  # [B, N1, C]

        # patch-to-patch aggregation over frame-1 neighbourhoods
        knn_idx = pointops.knn(k, xyz1, xyz1, valid1)
        direction = (pointops.group_points(xyz1, knn_idx)
                     - xyz1[:, :, None, :])
        weights = self.weightnet2(direction)
        p2p = point_to_patch if cdt is None else point_to_patch.to(cdt)
        grouped_cost = pointops.group_points(p2p, knn_idx)
        return torch.sum(weights * grouped_cost, dim=2)  # [B, N1, C]


class FlowHead(nn.Module):
    """Scene-flow regression head (radarflow_util.py:240-261); the flow is
    float32 in either compute dtype."""

    def __init__(self, in_ch: int, mlp: Sequence[int], dtype: DType = None,
                 group: Group = None):
        super().__init__()
        self.dtype = dtype
        self.mlp = PointwiseMLP(in_ch, mlp, dtype=dtype, group=group)
        self.out = nn.Linear(mlp[-1], 3, bias=False)

    def forward(self, feat: Tensor, train: bool) -> Tensor:
        return dense(self.out, self.mlp(feat, train), self.dtype).float()


class MotionHead(nn.Module):
    """Static/moving classification head (radarflow_util.py:263-285):
    probabilities in (0, 1), ``[B, N]``, float32 in either compute dtype."""

    def __init__(self, in_ch: int, mlp: Sequence[int], dtype: DType = None,
                 group: Group = None):
        super().__init__()
        self.dtype = dtype
        self.mlp = PointwiseMLP(in_ch, mlp, dtype=dtype, group=group)
        self.out = nn.Linear(mlp[-1], 1, bias=False)

    def forward(self, feat: Tensor, train: bool) -> Tensor:
        logit = dense(self.out, self.mlp(feat, train), self.dtype).float()
        return torch.sigmoid(logit)[..., 0]


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
