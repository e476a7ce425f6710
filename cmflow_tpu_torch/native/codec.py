"""The C++ sample codec, built with ``g++`` and loaded with ``ctypes``.

``sample_codec.cpp`` is a JSON decoder specialised to the scene-flow sample
schema: it parses the numeric fields straight into float32 buffers, as the
JAX package's reader does (``cmflow_tpu/native``).  It builds at first use
into ``build/native/libsamplecodec-<hash>.so`` under the repository root,
the hash covering the source and the compiler flags, as ``build.py`` names
the kernels.  A failed build raises with the compiler's message: there is no
quiet fallback to Python's ``json``, whose float64 values would change what
the readers return.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional

import numpy as np

SOURCE = Path(__file__).resolve().parent / "sample_codec.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


class _CmfMat(ctypes.Structure):
    _fields_ = [
        ("data", ctypes.POINTER(ctypes.c_float)),
        ("rows", ctypes.c_int64),
        ("cols", ctypes.c_int64),
    ]


class _CmfSample(ctypes.Structure):
    _fields_ = [
        ("pc1", _CmfMat), ("pc2", _CmfMat), ("trans", _CmfMat),
        ("gt_labels", _CmfMat), ("pse_labels", _CmfMat),
        ("opt_flow", _CmfMat), ("gt_mask", _CmfMat), ("pse_mask", _CmfMat),
        ("radar_u", _CmfMat), ("radar_v", _CmfMat),
        ("ok", ctypes.c_int32),
    ]


def library_path() -> Path:
    """Where the library of the current source and flags lives."""
    digest = hashlib.sha256(SOURCE.read_bytes())
    digest.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libsamplecodec-{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the codec unless its library exists; return its path."""
    path = library_path()
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", *CXX_FLAGS, str(SOURCE), "-o", str(tmp)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300)
    except FileNotFoundError as e:
        raise RuntimeError(f"g++ not found; the sample codec is built from "
                           f"{SOURCE} at first use") from e
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed to build the sample codec:\n"
                           f"{' '.join(cmd)}\n{proc.stderr}")
    os.replace(tmp, path)  # atomic: readers never see a partial file
    return path


def get_lib() -> ctypes.CDLL:
    """The loaded codec library, built first if needed."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.cmflow_parse_sample.argtypes = [
                ctypes.c_char_p, ctypes.c_int64, ctypes.POINTER(_CmfSample)]
            lib.cmflow_parse_sample.restype = ctypes.c_int
            lib.cmflow_free_sample.argtypes = [ctypes.POINTER(_CmfSample)]
            lib.cmflow_free_sample.restype = None
            _lib = lib
    return _lib


def _mat_to_numpy(m: _CmfMat) -> np.ndarray:
    if not m.data or m.rows == 0:
        shape = (0,) if m.cols == 0 else (0, int(m.cols))
        return np.zeros(shape, np.float32)
    count = int(m.rows) * max(int(m.cols), 1)
    arr = np.ctypeslib.as_array(m.data, shape=(count,)).copy()
    if m.cols > 0:
        return arr.reshape(int(m.rows), int(m.cols))
    return arr


def parse_sample_bytes(buf: bytes) -> Optional[Dict]:
    """Decode one raw sample JSON: the schema's keys, numeric fields as
    float32 arrays (``opt_info`` a dict of three), or ``None`` when the
    codec rejects the buffer."""
    lib = get_lib()
    out = _CmfSample()
    if not lib.cmflow_parse_sample(buf, len(buf), ctypes.byref(out)):
        return None
    try:
        return {
            "pc1": _mat_to_numpy(out.pc1),
            "pc2": _mat_to_numpy(out.pc2),
            "trans": _mat_to_numpy(out.trans),
            "gt_labels": _mat_to_numpy(out.gt_labels),
            "pse_labels": _mat_to_numpy(out.pse_labels),
            "gt_mask": _mat_to_numpy(out.gt_mask),
            "pse_mask": _mat_to_numpy(out.pse_mask),
            "opt_info": {
                "radar_u": _mat_to_numpy(out.radar_u),
                "radar_v": _mat_to_numpy(out.radar_v),
                "opt_flow": _mat_to_numpy(out.opt_flow),
            },
        }
    finally:
        lib.cmflow_free_sample(ctypes.byref(out))


def parse_sample_file(path: str) -> Optional[Dict]:
    with open(path, "rb") as f:
        return parse_sample_bytes(f.read())
