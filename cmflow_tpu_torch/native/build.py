"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each ``cmflow_tpu_torch/csrc/<name>.cu`` compiles on its own into a shared
library with a plain C interface, ``build/kernels/<name>-<hash>.so`` under the
repository root.  The hash covers the source, every shared header
(``csrc/*.cuh``) and the compiler flags, so a library is rebuilt whenever
what it is compiled from changes.  Sources build at first use; :func:`build`
compiles several at once, one ``nvcc`` process each.

Every exported entry point takes device pointers, sizes and the CUDA stream
and returns a ``cudaError_t`` from ``cudaGetLastError()`` right after its
launch; :func:`check` turns a non-zero code into an exception.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

# name -> loaded library with its argtypes set
_loaded: Dict[str, ctypes.CDLL] = {}


def sources() -> List[str]:
    """Names of every kernel source in ``csrc/``."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None:
        cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        path = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found on PATH or under CUDA_HOME; the CUDA kernels "
            "are built from source at first use")
    return path


def library_path(name: str) -> Path:
    """Where the library of ``csrc/<name>.cu`` lives for its current source."""
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, Path]:
    """Compile every named source (all of ``csrc/`` by default) whose library
    is missing, one ``nvcc`` per source, all started together.  Returns the
    library path of each name.  The compiler's report (registers, shared
    memory, spills) is kept beside each library as ``.log``."""
    names = sources() if names is None else list(names)
    paths = {name: library_path(name) for name in names}
    todo = [name for name in names if not paths[name].exists()]
    if not todo:
        return paths
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for name in todo:
        tmp = paths[name].with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    failed = []
    for name, tmp, proc in procs:
        log, _ = proc.communicate()
        paths[name].with_suffix(".log").write_bytes(log)
        if proc.returncode != 0:
            failed.append(f"{name}.cu:\n{log.decode(errors='replace')}")
            continue
        os.replace(tmp, paths[name])  # atomic: readers never see a partial file
    if failed:
        raise RuntimeError("nvcc failed\n" + "\n".join(failed))
    return paths


def load(name: str, signatures: Dict[str, Sequence]) -> ctypes.CDLL:
    """Build if needed and load ``csrc/<name>.cu``; set ``argtypes`` of each
    function in ``signatures`` and ``restype`` to ``int`` (a cudaError_t)."""
    lib = _loaded.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build([name])[name]))
        for fn, argtypes in signatures.items():
            getattr(lib, fn).argtypes = list(argtypes)
            getattr(lib, fn).restype = ctypes.c_int
        lib.cmflow_error_string.argtypes = [ctypes.c_int]
        lib.cmflow_error_string.restype = ctypes.c_char_p
        _loaded[name] = lib
    return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if code != 0:
        msg = lib.cmflow_error_string(code).decode()
        raise RuntimeError(f"{what} failed to launch: {msg} (cudaError {code})")
