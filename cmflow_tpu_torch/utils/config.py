"""Config system: dataclass, flat YAML and CLI overrides.

Counterpart of ``cmflow_tpu/utils/config.py``: the same fields with the same
defaults, so the shared ``configs/*.yaml`` recipes load unchanged.  PyYAML is
not a dependency of the port.  The recipes are flat ``key: scalar`` files,
and :func:`parse_flat_yaml` reads that subset and nothing else: ints, floats,
``true``/``false``, quoted and bare strings, and ``#`` comments, each scalar
resolved as PyYAML's ``safe_load`` resolves it.  Anything outside the subset
raises, so a recipe is never read differently from the JAX package.

Fields that take a fixed set of values raise ``ValueError`` on any other
when the config is made: ``remat`` (False, True or ``"dots"``, as the JAX
package's ``remat_wrap`` checks it), ``platform``, ``fused_inference``,
``eval_wire`` and the compute dtypes.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Dict, Optional

import torch

from cmflow_tpu_torch.utils.device import resolve_device


def check_remat(remat) -> None:
    """Raise ``ValueError`` unless ``remat`` is False (or falsy), True or
    ``"dots"``, as the JAX package's ``remat_wrap`` does: a typo such as
    ``"dot"`` or ``"on"`` must not select full recomputation."""
    if remat and remat is not True and remat != "dots":
        raise ValueError(
            f"remat must be False, True, or 'dots'; got {remat!r}")


@dataclasses.dataclass
class Config:
    exp_name: str = "cmflow_tpu"
    model: str = "cmflow"

    # training
    num_points: int = 256
    batch_size: int = 16
    val_batch_size: int = 8
    epochs: int = 60
    lr: float = 1e-3
    weight_decay: float = 1e-4
    decay_epochs: int = 1
    decay_rate: float = 0.9

    # runtime
    seed: int = 1234
    num_workers: int = 8
    data_parallel: bool = True  # one process per card (parallel/mesh.py)
    platform: str = "auto"  # auto: the GPU; cpu: the CPU
    compute_dtype: str = "float32"
    # recompute the encoder branches and the cost volume in the backward:
    # False | True (all of them) | "dots" (keep the neighbour indices, the
    # gathers and the products; recompute the BatchNorm/activation chains)
    remat: object = False
    fused_inference: str = "auto"  # fused serving engine: auto|on|off
    # eval host->device wire: int16 quantizes each float32 field with >= 32
    # values per frame to a per-frame scale (max|x| / 32767); float32 is
    # lossless.  The same numbers as the JAX package's wire.
    eval_wire: str = "int16"
    # check every step's inputs, loss items, gradients and predictions for
    # NaN (FloatingPointError), with autograd's anomaly mode on for the run
    nan_check: bool = False
    profile_dir: Optional[str] = None  # torch.profiler trace of the run

    # dataset
    eval: bool = False
    eval_split: str = "test"
    dataset: str = "vodDataset"
    train_set: str = "train"
    dataset_path: str = ""
    vis: bool = False  # eval: BEV flow and segmentation PNGs (matplotlib)
    save_res: bool = False
    eval_pad_multiple: int = 128  # bucket granularity without pinned buckets
    # pinned eval shape set: every eval batch pads to one of these N, and a
    # frame above the top bucket fails loudly (num_points is the floor)
    eval_buckets: tuple = (256, 384, 512)
    eval_batch_size: int = 64  # frames per batch in frame-pair evaluation
    eval_compute_dtype: str = "float32"

    # method parameters
    rigid_thres: float = 0.15
    vr_thres: float = 0.3
    stat_thres: float = 0.5

    # GRU / temporal
    mini_clip_len: int = 5
    update_len: int = 5

    # checkpointing
    load_checkpoint: bool = False
    model_path: str = ""
    checkpoints_dir: str = "checkpoints"

    def __post_init__(self):
        check_remat(self.remat)
        for name, allowed in _CHOICES.items():
            if getattr(self, name) not in allowed:
                raise ValueError(f"config {name} must be one of {allowed}, "
                                 f"got {getattr(self, name)!r}")

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


_DEFAULTS = {f.name: f.default for f in dataclasses.fields(Config)}
_CHOICES = {"platform": ("auto", "cpu"),
            "fused_inference": ("auto", "on", "off"),
            "eval_wire": ("float32", "int16"),
            "compute_dtype": ("float32", "bfloat16"),
            "eval_compute_dtype": ("float32", "bfloat16")}


def config_device(cfg: Config) -> torch.device:
    """The device ``cfg`` runs on: ``platform: auto`` is the GPU (raising
    without one; the current card, which a data-parallel rank sets to its
    own), ``cpu`` the CPU."""
    if cfg.platform == "cpu":
        return resolve_device("cpu")
    return resolve_device(None)


# ---------------------------------------------------------------------------
# the flat YAML subset

_KEY = re.compile(r"[A-Za-z_][A-Za-z0-9_]*")
_INT = re.compile(r"[-+]?(?:0|[1-9][0-9]*)")
_FLOAT = re.compile(r"[-+]?[0-9]+\.[0-9]*(?:[eE][-+][0-9]+)?"
                    r"|\.[0-9]+(?:[eE][-+][0-9]+)?")
_BOOL = {"true": True, "True": True, "TRUE": True,
         "false": False, "False": False, "FALSE": False}
# what PyYAML resolves to something else than a string, or YAML 1.2 to a
# number, outside the subset above: null, the other booleans, numbers with
# underscores, octal, hex, binary, sexagesimal, inf, nan and '1e-3'
_OUTSIDE = re.compile(
    r"~|null|Null|NULL|yes|Yes|YES|no|No|NO|on|On|ON|off|Off|OFF"
    r"|[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN)"
    r"|[-+]?[0-9][0-9_:.]*(?:[eE][-+]?[0-9]+)?"
    r"|[-+]?0[bxo][0-9a-fA-F_]+")
_INDICATORS = tuple("[]{}&*!|>%@`?,") + ("- ", "-\t")


def _scalar(text: str, where: str) -> Any:
    """One scalar of the subset: the value text after ``key:``, with any
    comment still on it."""
    if text[:1] in ("'", '"'):
        quote = text[0]
        end, out = 1, []
        while True:
            j = text.find(quote, end)
            if j < 0:
                raise ValueError(f"{where}: unterminated quoted string")
            out.append(text[end:j])
            if quote == "'" and text[j + 1:j + 2] == "'":
                out.append("'")
                end = j + 2
                continue
            break
        value = "".join(out)
        if quote == '"' and "\\" in value:
            raise ValueError(f"{where}: escapes in double-quoted strings are "
                             "outside the flat YAML subset")
        rest = text[j + 1:].strip()
        if rest and not rest.startswith("#"):
            raise ValueError(f"{where}: text after the quoted string")
        return value
    cut = re.search(r"\s#", text)
    if cut:
        text = text[:cut.start()]
    text = text.strip()
    if not text:
        raise ValueError(f"{where}: an empty value is null, which the flat "
                         "YAML subset does not take")
    if (text.startswith(_INDICATORS) or text in ("-", "---", "...")
            or ": " in text or text.endswith(":")):
        raise ValueError(f"{where}: {text!r} is outside the flat YAML subset "
                         "(key: scalar)")
    if text in _BOOL:
        return _BOOL[text]
    if _INT.fullmatch(text):
        return int(text)
    if _FLOAT.fullmatch(text):
        return float(text)
    if _OUTSIDE.fullmatch(text):
        raise ValueError(f"{where}: {text!r} is outside the flat YAML subset "
                         "(write ints, floats with a '.', true/false, or "
                         "quote a string)")
    return text


def parse_flat_yaml(source: str, name: str = "<yaml>") -> Dict[str, Any]:
    """Parse a flat ``key: scalar`` YAML document (see the module
    docstring); raises ``ValueError`` on anything outside that subset."""
    data: Dict[str, Any] = {}
    for lineno, line in enumerate(source.splitlines(), 1):
        where = f"{name}:{lineno}"
        stripped = line.strip()
        if not stripped or stripped.startswith("#"):
            continue
        if line[0].isspace():
            raise ValueError(f"{where}: indented lines (nested values) are "
                             "outside the flat YAML subset")
        key, colon, rest = line.partition(":")
        if not colon or not _KEY.fullmatch(key):
            raise ValueError(f"{where}: expected 'key: value', got {line!r}")
        if rest and not rest[0].isspace():
            raise ValueError(f"{where}: expected a space after '{key}:'")
        if key in data:
            raise ValueError(f"{where}: duplicate key {key!r}")
        data[key] = _scalar(rest.strip(), where)
    return data


def load_config(yaml_path: Optional[str] = None,
                overrides: Optional[Dict[str, Any]] = None) -> Config:
    """Load a Config from a flat YAML file (all keys optional) and apply the
    overrides that are not None; unknown keys raise ``KeyError``."""
    data: Dict[str, Any] = {}
    if yaml_path:
        with open(yaml_path, "r") as f:
            data.update(parse_flat_yaml(f.read(), yaml_path))
    if overrides:
        data.update({k: v for k, v in overrides.items() if v is not None})
    unknown = set(data) - set(_DEFAULTS)
    if unknown:
        raise KeyError(f"unknown config keys: {sorted(unknown)}")
    return Config(**data)
