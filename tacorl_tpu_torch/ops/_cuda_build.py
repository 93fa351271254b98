"""Builds the port's CUDA C++ kernels and loads them with ctypes.

Each ``tacorl_tpu_torch/csrc/<name>.cu`` has a plain C interface
(``extern "C"`` launchers that take raw device pointers, sizes and a
``cudaStream_t``, and return ``cudaGetLastError()``). ``load_library``
compiles it on first use with

    nvcc -O3 -arch=sm_90a -std=c++17 -shared -Xcompiler -fPIC -Xptxas -v

into ``build/cuda/lib<name>-<hash>.so`` of this checkout, where the hash
covers the source, every shared header ``csrc/*.cuh`` and the flags, so an
edit to any of them rebuilds it; it never runs at import. ptxas's report
(registers, shared memory and spills of each kernel) is kept beside the
library as ``lib<name>-<hash>.log`` (``build_log``). The compiler is
``$TACORL_NVCC``, else ``nvcc`` on the PATH, else
``/usr/local/cuda/bin/nvcc``. A missing compiler or a failed build raises:
there is no fallback to a kernel's plain version.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict

__all__ = ["load_library", "library_path", "build_log", "nvcc_path", "CSRC_DIR", "BUILD_DIR", "NVCC_FLAGS"]

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "cuda"
NVCC_FLAGS = (
    "-O3", "-arch=sm_90a", "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LOADED: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """The CUDA compiler to build with; raises when there is none."""
    explicit = os.environ.get("TACORL_NVCC")
    candidates = [explicit] if explicit else [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for path in candidates:
        if path and os.path.isfile(path) and os.access(path, os.X_OK):
            return path
    raise RuntimeError(
        f"nvcc not found (looked for {[c for c in candidates if c]}); the CUDA "
        "kernels are built from tacorl_tpu_torch/csrc on a machine with the CUDA toolkit"
    )


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to: its name carries a digest of the
    source, of every shared header ``csrc/*.cuh`` and of the flags."""
    source = CSRC_DIR / f"{name}.cu"
    h = hashlib.sha256(source.read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_log(name: str) -> str:
    """ptxas's report from the build of ``csrc/<name>.cu`` ("" when this
    library was built before the report was kept)."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.is_file() else ""


def load_library(name: str) -> ctypes.CDLL:
    """Build ``csrc/<name>.cu`` if this source has not been built yet, and
    load it once per process."""
    if name in _LOADED:
        return _LOADED[name]
    source = CSRC_DIR / f"{name}.cu"
    target = library_path(name)
    if not target.is_file():
        nvcc = nvcc_path()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        partial = target.with_name(f"{target.name}.{os.getpid()}.tmp")
        proc = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-o", str(partial), str(source)],
            capture_output=True, text=True,
        )
        if proc.returncode != 0:
            partial.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed to build {source}:\n{proc.stderr}")
        target.with_suffix(".log").write_text(proc.stdout + proc.stderr)
        os.replace(partial, target)  # atomic: a concurrent build never sees half a file
    _LOADED[name] = ctypes.CDLL(str(target))
    return _LOADED[name]
