"""Carry flax weights across to the port's modules.

:func:`load_flax_variables` takes the JAX package's variable tree
``{"params": ..., "batch_stats": ...}`` as nested dicts of numpy arrays and
fills a model whose submodules carry the flax names:

* Dense ``kernel [in, out]`` -> ``Linear.weight [out, in]``, ``bias`` -> bias;
* the raw first-layer ``w0`` (and ``b0``) of ``PointLocalFeature`` and
  ``FeatureCorrelator`` -> a parameter kept ``[in, out]``, which the forward
  slices by rows;
* BatchNorm ``scale``/``bias`` -> weight/bias, batch stats ``mean``/``var``
  -> ``running_mean``/``running_var``.

A key with no counterpart, a shape that differs, or a parameter or buffer
left unfilled is an error.  :func:`export_flax_variables` is the inverse:
it gives the same tree for the port's values, or for their gradients.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Set, Tuple

import numpy as np
import torch
from torch import nn

from cmflow_tpu_torch.nn.blocks import (
    BatchNorm,
    FeatureCorrelator,
    PointLocalFeature,
)

# (module type, collection, flax leaf) -> (torch name, transpose?)
_RULES: Dict[Tuple[type, str, str], Tuple[str, bool]] = {
    (nn.Linear, "params", "kernel"): ("weight", True),
    (nn.Linear, "params", "bias"): ("bias", False),
    (BatchNorm, "params", "scale"): ("weight", False),
    (BatchNorm, "params", "bias"): ("bias", False),
    (BatchNorm, "batch_stats", "mean"): ("running_mean", False),
    (BatchNorm, "batch_stats", "var"): ("running_var", False),
    (PointLocalFeature, "params", "w0"): ("w0", False),
    (FeatureCorrelator, "params", "w0"): ("w0", False),
    (FeatureCorrelator, "params", "b0"): ("b0", False),
}


def _leaves(tree: Mapping[str, Any], prefix: Tuple[str, ...] = ()):
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _leaves(value, prefix + (key,))
        else:
            yield prefix + (key,), value


def load_flax_variables(model: nn.Module,
                        variables: Mapping[str, Mapping[str, Any]]) -> None:
    """Fill ``model`` in place from a flax ``{"params", "batch_stats"}``
    tree of numpy arrays."""
    state = model.state_dict()
    filled: Set[str] = set()
    for collection in ("params", "batch_stats"):
        for path, value in _leaves(variables.get(collection, {})):
            where = ".".join(path)
            module_path, leaf = ".".join(path[:-1]), path[-1]
            try:
                module = model.get_submodule(module_path)
            except AttributeError:
                raise KeyError(f"{collection}/{where}: no module "
                               f"{module_path!r} in the model") from None
            rule = _RULES.get((type(module), collection, leaf))
            if rule is None:
                raise KeyError(f"{collection}/{where}: no counterpart in "
                               f"{type(module).__name__}")
            name, transpose = rule
            key = f"{module_path}.{name}" if module_path else name
            array = np.asarray(value, np.float32)
            if transpose:
                array = array.T
            target = state[key]
            if tuple(target.shape) != array.shape:
                raise ValueError(f"{collection}/{where}: shape {array.shape} "
                                 f"does not fit {key} {tuple(target.shape)}")
            with torch.no_grad():
                target.copy_(torch.tensor(array))
            filled.add(key)
    missing = sorted(set(state) - filled)
    if missing:
        raise KeyError(f"left unfilled by the flax variables: {missing}")


def export_flax_variables(model: nn.Module, grads: bool = False
                          ) -> Dict[str, Dict[str, Any]]:
    """The inverse of :func:`load_flax_variables`: ``model``'s parameters
    and BatchNorm statistics as a flax ``{"params", "batch_stats"}`` tree of
    float32 numpy arrays.  With ``grads=True``, the ``params`` tree holds
    each parameter's ``.grad`` (zeros where it has none) and there is no
    ``batch_stats``."""
    inverse = {(mtype, name): (collection, leaf, transpose)
               for (mtype, collection, leaf), (name, transpose)
               in _RULES.items()}
    tree: Dict[str, Dict[str, Any]] = {"params": {}}
    if not grads:
        tree["batch_stats"] = {}
    named = dict(model.named_parameters())
    if not grads:
        named.update(model.named_buffers())
    for key, tensor in named.items():
        module_path, _, name = key.rpartition(".")
        module = model.get_submodule(module_path)
        rule = inverse.get((type(module), name))
        if rule is None:
            raise KeyError(f"{key}: no flax counterpart")
        collection, leaf, transpose = rule
        if grads:
            tensor = (tensor.grad if tensor.grad is not None
                      else torch.zeros_like(tensor))
        array = tensor.detach().to("cpu", torch.float32).numpy().copy()
        if transpose:
            array = array.T.copy()
        node = tree[collection]
        for part in module_path.split(".") if module_path else ():
            node = node.setdefault(part, {})
        node[leaf] = array
    return tree
