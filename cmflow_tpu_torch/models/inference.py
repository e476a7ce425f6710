"""The fused serving engines of the three families.

Counterpart of ``cmflow_tpu/models/inference.py`` (``cmflow_infer``,
``raflow_infer``, ``cmflow_t_infer`` and their macro-batch and sequence
forms): an eval forward computed from the port's module, with the same
outputs as its ``forward(..., train=False)`` up to float32 reassociation,
but with every encoder scale and the cost volume run
by the fused kernels of :mod:`cmflow_tpu_torch.ops.fused`, so the
``[B, N, K, C]`` neighbourhood tensors of the module route never reach
device memory.  One forward launches: the ball query twice (all four radii
per cloud; pc1's result serves both encoders), kNN twice, the sa encoder
(K3) twice, the cost volume (K4a, K4b) once each and the propagation
encoder (K5) once per scale.

BatchNorm running statistics fold into per-channel affines, which is exact
in eval mode.  The packing reads the module's current weights on every
call.  The per-point tails (mlp2, the heads) and the Kabsch stay plain
PyTorch: their tensors are ``[B, N, C]``.

``compute_dtype`` is float32 or bfloat16, as in the JAX engines.  In
bfloat16 every product rounds both operands to bf16 and sums in float32:
the products outside the kernels through :func:`_dot32`, those inside
through the kernels' bf16 arms, which take bf16 bases, ``f1c``/``f2c`` and
weights (``ops/fused.py``).  ``feat_tx``, ``f1t`` and ``f2t`` are stored in
bf16; the affines, the ball query and kNN, the WeightNets, the GRU cell,
the Kabsch and the sigmoid stay float32, and every output is float32.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from cmflow_tpu_torch.geometry import se3
from cmflow_tpu_torch.models.cmflow_t import temporal_ego_motion
from cmflow_tpu_torch.models.raflow import static_flow_refinement
from cmflow_tpu_torch.nn.blocks import masked_global_max, mm32
from cmflow_tpu_torch.ops import neighbors, pointops
from cmflow_tpu_torch.ops.fused import (
    cv_params_from_variables,
    fold_bn_affine,
    fused_cost_volume,
    fused_multi_scale_encoder,
    fused_point_local_feature,
    mse_narrow_params_from_variables,
    plf_params_from_variables,
)

Tensor = torch.Tensor
Parts = Sequence[Tensor]


_DTYPES = (torch.float32, torch.bfloat16)


def _kernel(linear) -> Tensor:
    return linear.weight.t()


def _cast_chain(chain: Sequence[Tensor], dtype: torch.dtype) -> list:
    """A :func:`plf_params_from_variables` chain with its ``wrel`` and Dense
    kernels in ``dtype``; the affines stay float32."""
    return [t.to(dtype) if i % 3 == 0 else t for i, t in enumerate(chain)]


def _dot32(x: Tensor, w: Tensor, dtype: torch.dtype) -> Tensor:
    """``x @ w`` with both operands rounded to ``dtype`` and a float32
    result, the JAX engine's ``_dot32``: each bf16 product is exact and the
    sum is float32 (:func:`cmflow_tpu_torch.nn.blocks.mm32`)."""
    if dtype == torch.float32:
        return x @ w
    a, b = x.reshape(-1, x.shape[-1]).to(dtype), w.to(dtype)
    return mm32(a, b).reshape(*x.shape[:-1], w.shape[-1])


def _fanin_dot(parts: Parts, w: Tensor,
               dtype: torch.dtype = torch.float32) -> Tensor:
    """``concat(parts, -1) @ w`` without building the concatenation, each
    part's product by :func:`_dot32` in ``dtype``.

    ``parts`` are ``[B, N, Ci]`` tensors or ``[B, Ci]`` terms broadcast over
    the points (global features), whose product is O(B) work; ``w``'s rows
    are sliced per part.  Equal to the concatenated product up to float32
    reassociation across the row blocks."""
    out = None
    row = 0
    for p in parts:
        c = p.shape[-1]
        term = _dot32(p, w[row:row + c], dtype)
        row += c
        if p.dim() == 2:
            term = term[:, None, :]
        out = term if out is None else out + term
    if row != w.shape[0]:
        raise ValueError(f"parts are {row} wide, the weight has "
                         f"{w.shape[0]} rows")
    return out


def _parts_width(parts: Parts) -> int:
    return sum(p.shape[-1] for p in parts)


def _ball_query_all(radii: Sequence[float], nsamples: Sequence[int],
                    xyz: Tensor, valid: Optional[Tensor]) -> List[Tensor]:
    """Every scale's ball query in one launch."""
    return list(neighbors.ball_query_multi(tuple(radii), tuple(nsamples),
                                           xyz, xyz, valid))


def _scales(mse) -> list:
    return [getattr(mse, f"scale_{i}") for i in range(mse.scales)]


def _mse_fused(mse, xyz: Tensor, feats, valid: Optional[Tensor],
               idx_list: Optional[List[Tensor]] = None,
               dtype: torch.dtype = torch.float32) -> Tensor:
    """A ``MultiScaleEncoder`` through the fused kernels' ``dtype`` arm,
    then its plain mlp2 tail.

    A narrow encoder (first layer under 128 wide: the sa encoder) runs all
    scales in one K3 launch and the mlp2 tails as one block-diagonal chain;
    a wide one (the propagation encoder) runs K5 once per scale.  ``feats``
    is one tensor or a tuple of fan-in parts (see :func:`_fanin_dot`);
    ``idx_list`` shares ball queries already made on ``xyz``."""
    scales = _scales(mse)
    if idx_list is None:
        idx_list = _ball_query_all([s.radius for s in scales],
                                   [s.nsample for s in scales], xyz, valid)
    parts = tuple(feats) if isinstance(feats, (tuple, list)) else (feats,)
    if scales[0].w0.shape[1] < 128:
        if len(parts) != 1:
            raise ValueError("the narrow encoder takes one feature tensor")
        packed, mlp2_bd = mse_narrow_params_from_variables(mse, dtype)
        h = fused_multi_scale_encoder(parts[0].to(dtype), idx_list, xyz,
                                      packed)
        for w, s, b in mlp2_bd:
            h = torch.relu(_dot32(h, w, dtype) * s + b)
        return h
    outs = []
    for scale, idx in zip(scales, idx_list):
        chain, feat_w, mlp2 = plf_params_from_variables(scale)
        feat_tx = _fanin_dot(parts, feat_w, dtype).to(dtype)
        h = fused_point_local_feature(feat_tx, idx, xyz,
                                      _cast_chain(chain, dtype))
        for w, s, b in mlp2:
            h = torch.relu(_dot32(h, w, dtype) * s + b)
        outs.append(h)
    return torch.cat(outs, dim=-1)


def _cost_volume(fc, xyz1: Tensor, xyz2: Tensor, f1_parts: Parts,
                 f2_parts: Parts, valid1: Optional[Tensor],
                 valid2: Optional[Tensor],
                 dtype: torch.dtype = torch.float32) -> Tensor:
    """``FeatureCorrelator`` eval forward through K4a and K4b; the features
    come as fan-in parts (local, global broadcast).  In ``dtype``: ``f1t``,
    ``f2t`` and the dense chain's ``wd``, ``w1``, ``w2``; the biases and
    the WeightNets stay float32."""
    d1, d2 = _parts_width(f1_parts), _parts_width(f2_parts)
    knn2 = pointops.knn(fc.nsample, xyz1, xyz2, valid2)
    knn1 = pointops.knn(fc.nsample, xyz1, xyz1, valid1)
    f1t = _fanin_dot(f1_parts, fc.w0[:d1], dtype).to(dtype)
    f2t = _fanin_dot(f2_parts, fc.w0[d1:d1 + d2], dtype).to(dtype)
    dense, wn1, wn2 = cv_params_from_variables(fc)
    dense = tuple(t.to(dtype) if i % 2 == 0 else t
                  for i, t in enumerate(dense))
    return fused_cost_volume(f1t, f2t, knn2, xyz1, knn1, xyz2,
                             dense=dense, wn1=wn1, wn2=wn2)


def _head(head, x_parts: Parts,
          dtype: torch.dtype = torch.float32) -> Tensor:
    """A ``FlowHead`` / ``MotionHead`` chain with folded BatchNorm, before
    any sigmoid; the input comes as fan-in parts."""
    x = None
    for i in range(head.mlp.depth):
        sc, bi = fold_bn_affine(getattr(head.mlp, f"bn_{i}"))
        w = _kernel(getattr(head.mlp, f"dense_{i}"))
        h = (_fanin_dot(x_parts, w, dtype) if x is None
             else _dot32(x, w, dtype))
        x = torch.relu(h * sc + bi)
    return _dot32(x, _kernel(head.out), dtype)


def _heads_joint(fp, mp, x_parts: Parts,
                 dtype: torch.dtype = torch.float32
                 ) -> Tuple[Tensor, Tensor]:
    """The flow and motion heads as one chain: first-layer kernels stacked
    by columns, the rest block-diagonal (the channel blocks stay apart
    through the affines and ReLUs).  Returns ``(flow [B,N,3],
    logit [B,N,1])``."""
    x = None
    for i in range(fp.mlp.depth):
        wa = _kernel(getattr(fp.mlp, f"dense_{i}"))
        wb = _kernel(getattr(mp.mlp, f"dense_{i}"))
        w = torch.cat([wa, wb], dim=1) if i == 0 else torch.block_diag(wa, wb)
        sa, ba = fold_bn_affine(getattr(fp.mlp, f"bn_{i}"))
        sb, bb = fold_bn_affine(getattr(mp.mlp, f"bn_{i}"))
        h = (_fanin_dot(x_parts, w, dtype) if x is None
             else _dot32(x, w, dtype))
        x = torch.relu(h * torch.cat([sa, sb]) + torch.cat([ba, bb]))
    out = _dot32(x, torch.block_diag(_kernel(fp.out), _kernel(mp.out)),
                 dtype)
    c_fp = fp.out.out_features
    return out[..., :c_fp], out[..., c_fp:]


def _trunk(trunk, pc1: Tensor, pc2: Tensor, ft1: Tensor, ft2: Tensor,
           valid1: Optional[Tensor], valid2: Optional[Tensor],
           dtype: torch.dtype = torch.float32) -> Tensor:
    cfg = trunk.cfg
    # the sa and propagation encoders query the same cloud with the same
    # radii: one ball query serves both
    idx1 = _ball_query_all(cfg.sa_radii, cfg.sa_nsamples, pc1, valid1)
    f1 = _mse_fused(trunk.mse_layer, pc1, ft1, valid1, idx1, dtype)
    f2 = _mse_fused(trunk.mse_layer, pc2, ft2, valid2, dtype=dtype)
    g1 = masked_global_max(f1, valid1)
    g2 = masked_global_max(f2, valid2)
    cor = _cost_volume(trunk.fc_layer, pc1, pc2, (f1, g1), (f2, g2),
                       valid1, valid2, dtype)
    # the module route's embedding concat([ft1, f1, g1, cor]) enters the
    # propagation encoder as fan-in parts
    return _mse_fused(trunk.mse_layer2, pc1, (ft1, f1, g1, cor), valid1,
                      idx1, dtype)


def check_compute_dtype(compute_dtype: torch.dtype) -> None:
    """The engines serve float32 and bfloat16, as the JAX engines do."""
    if compute_dtype not in _DTYPES:
        raise ValueError(f"compute_dtype must be torch.float32 or "
                         f"torch.bfloat16, got {compute_dtype}")


@torch.no_grad()
def cmflow_infer(model, pc1: Tensor, pc2: Tensor, ft1: Tensor, ft2: Tensor,
                 valid1: Optional[Tensor] = None,
                 valid2: Optional[Tensor] = None,
                 compute_dtype: torch.dtype = torch.float32
                 ) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Fused CMFlow eval forward of ``model`` (a port ``CMFlow``): the
    outputs of ``model(pc1, pc2, ft1, ft2, None, False, valid1, valid2)``,
    ``(sf_agg [B,N,3], stat_cls [B,N], pre_trans [B,4,4], mask [B,N])``.
    The Kabsch takes the polar solver, as the JAX engine does."""
    check_compute_dtype(compute_dtype)
    prop = _trunk(model.trunk, pc1, pc2, ft1, ft2, valid1, valid2,
                  compute_dtype)
    g = masked_global_max(prop, valid1)
    output, logit = _heads_joint(model.fp, model.mp, (prop, g),
                                 compute_dtype)
    stat_cls = torch.sigmoid(logit)[..., 0]

    mask = stat_cls > model.stat_thres
    if valid1 is not None:
        mask = mask & valid1

    w = stat_cls + 1e-4
    if valid1 is not None:
        w = w * valid1
    w = w / w.sum(dim=1, keepdim=True)
    pre_trans = se3.weighted_kabsch(pc1, pc1 + output, w, centroid="sum",
                                    reflect="row", solver="polar")

    sf_rg = se3.rigid_to_flow(pc1, pre_trans)
    sf_agg = torch.where(mask[..., None], sf_rg, output)
    return sf_agg, stat_cls, pre_trans, mask


def _infer_many(infer, model, per_batch: Sequence[Tensor],
                valid1: Optional[Tensor], valid2: Optional[Tensor],
                compute_dtype: torch.dtype) -> Tuple[Tensor, ...]:
    """``infer`` over a macro-batch: each of ``per_batch`` and the masks
    stacked ``[S, B, ...]``, the outputs stacked the same way."""
    outs = []
    for i in range(per_batch[0].shape[0]):
        outs.append(infer(model, *(x[i] for x in per_batch),
                          None if valid1 is None else valid1[i],
                          None if valid2 is None else valid2[i],
                          compute_dtype))
    return tuple(torch.stack(o) for o in zip(*outs))


def cmflow_infer_many(model, pc1: Tensor, pc2: Tensor, ft1: Tensor,
                      ft2: Tensor, valid1: Optional[Tensor] = None,
                      valid2: Optional[Tensor] = None,
                      compute_dtype: torch.dtype = torch.float32
                      ) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """:func:`cmflow_infer` over a macro-batch: inputs stacked
    ``[S, B, N, ...]``, outputs stacked the same way."""
    check_compute_dtype(compute_dtype)
    return _infer_many(cmflow_infer, model, (pc1, pc2, ft1, ft2), valid1,
                       valid2, compute_dtype)


@torch.no_grad()
def raflow_infer(model, pc1: Tensor, pc2: Tensor, ft1: Tensor, ft2: Tensor,
                 interval: Tensor, valid1: Optional[Tensor] = None,
                 valid2: Optional[Tensor] = None,
                 compute_dtype: torch.dtype = torch.float32
                 ) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Fused RaFlow eval forward of ``model`` (a port ``RaFlow``): the
    outputs of ``model(pc1, pc2, ft1, ft2, interval, False, valid1,
    valid2)``, ``(coarse_flow [B,N,3], sf_agg [B,N,3], pre_trans [B,4,4],
    mask_s [B,N])``.  Both Kabsch fits take the polar solver, as the JAX
    engine's do."""
    check_compute_dtype(compute_dtype)
    prop = _trunk(model.trunk, pc1, pc2, ft1, ft2, valid1, valid2,
                  compute_dtype)
    output = _head(model.fp, (prop, masked_global_max(prop, valid1)),
                   compute_dtype)
    sf_agg, pre_trans, mask_s = static_flow_refinement(
        pc1, output, ft1[..., 0], interval, valid1, model.rigid_thres,
        model.rigid_pcs, solver="polar")
    return output, sf_agg, pre_trans, mask_s


def raflow_infer_many(model, pc1: Tensor, pc2: Tensor, ft1: Tensor,
                      ft2: Tensor, interval: Tensor,
                      valid1: Optional[Tensor] = None,
                      valid2: Optional[Tensor] = None,
                      compute_dtype: torch.dtype = torch.float32
                      ) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """:func:`raflow_infer` over a macro-batch: inputs stacked
    ``[S, B, ...]``, outputs stacked the same way."""
    check_compute_dtype(compute_dtype)
    return _infer_many(raflow_infer, model, (pc1, pc2, ft1, ft2, interval),
                       valid1, valid2, compute_dtype)


def _gru_cell(gru, h: Tensor, x: Tensor) -> Tensor:
    """The flax GRU cell of a ``GRUCell`` module, its six gate products as
    two ``[B,C]@[C,3C]`` products (gate kernels stacked by columns; the
    gates stay apart), as the JAX engine computes it."""
    c = h.shape[-1]
    gin = getattr(gru, "in")
    wi = torch.cat([_kernel(gru.ir), _kernel(gru.iz), _kernel(gin)], dim=1)
    bi = torch.cat([gru.ir.bias, gru.iz.bias, gin.bias])
    wh = torch.cat([_kernel(gru.hr), _kernel(gru.hz), _kernel(gru.hn)],
                   dim=1)
    xi = x @ wi + bi
    hh = h @ wh
    r = torch.sigmoid(xi[:, :c] + hh[:, :c])
    z = torch.sigmoid(xi[:, c:2 * c] + hh[:, c:2 * c])
    n = torch.tanh(xi[:, 2 * c:] + r * (hh[:, 2 * c:] + gru.hn.bias))
    return (1.0 - z) * n + z * h


@torch.no_grad()
def cmflow_t_infer(model, pc1: Tensor, pc2: Tensor, ft1: Tensor,
                   ft2: Tensor, gfeat: Tensor,
                   valid1: Optional[Tensor] = None,
                   valid2: Optional[Tensor] = None,
                   compute_dtype: torch.dtype = torch.float32
                   ) -> Tuple[Tensor, Tensor, Tensor, Tensor, Tensor]:
    """Fused CMFlow_T eval forward of ``model`` (a port ``CMFlowT``): the
    outputs of ``model(pc1, pc2, ft1, ft2, None, False, gfeat, valid1,
    valid2)``, ``(sf_agg, stat_cls, pre_trans, mask, gfeat_new [B,C])``,
    the Kabsch on the polar solver."""
    check_compute_dtype(compute_dtype)
    prop = _trunk(model.trunk, pc1, pc2, ft1, ft2, valid1, valid2,
                  compute_dtype)
    gfeat_new = _gru_cell(model.gru, gfeat, masked_global_max(prop, valid1))
    output, logit = _heads_joint(model.fp, model.mp, (prop, gfeat_new),
                                 compute_dtype)
    stat_cls = torch.sigmoid(logit)[..., 0]
    sf_agg, pre_trans, mask = temporal_ego_motion(
        pc1, output, stat_cls, valid1, model.stat_thres, solver="polar")
    return sf_agg, stat_cls, pre_trans, mask, gfeat_new


def cmflow_t_infer_seq(model, pc1: Tensor, pc2: Tensor, ft1: Tensor,
                       ft2: Tensor, gfeat0: Tensor, reset: Tensor,
                       valid1: Optional[Tensor] = None,
                       valid2: Optional[Tensor] = None,
                       compute_dtype: torch.dtype = torch.float32
                       ) -> Tuple[Tuple[Tensor, ...], Tensor]:
    """:func:`cmflow_t_infer` over a frame sequence: inputs stacked
    ``[T, B, ...]``; ``reset [T, B]`` zeroes a lane's GRU carry before frame
    t where it is set (a clip start, or every ``update_len`` frames,
    reference clip_util.py:226-233).  Each batch lane carries its own state.
    Returns ``((sf, cls, trans, mask) stacked [T, ...], the final gfeat)``."""
    check_compute_dtype(compute_dtype)
    gfeat = gfeat0
    outs = []
    for t in range(pc1.shape[0]):
        gfeat = torch.where(reset[t][:, None] > 0, 0.0, gfeat)
        *out, gfeat = cmflow_t_infer(
            model, pc1[t], pc2[t], ft1[t], ft2[t], gfeat,
            None if valid1 is None else valid1[t],
            None if valid2 is None else valid2[t], compute_dtype)
        outs.append(out)
    return tuple(torch.stack(o) for o in zip(*outs)), gfeat
