"""Builds the port's CUDA C++ kernels and loads them with ctypes.

Each ``tacorl_tpu_torch/csrc/<name>.cu`` has a plain C interface
(``extern "C"`` launchers that take raw device pointers, sizes and a
``cudaStream_t``, and return ``cudaGetLastError()``). ``load_library``
compiles it on first use with

    nvcc -O3 -arch=sm_90a -std=c++17 -shared -Xcompiler -fPIC

into ``build/cuda/lib<name>-<hash>.so`` of this checkout, where the hash
covers the source and the flags, so an edit rebuilds it; it never runs at
import. The compiler is ``$TACORL_NVCC``, else ``nvcc`` on the PATH, else
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

__all__ = ["load_library", "nvcc_path", "CSRC_DIR", "BUILD_DIR", "NVCC_FLAGS"]

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "cuda"
NVCC_FLAGS = ("-O3", "-arch=sm_90a", "-std=c++17", "-shared", "-Xcompiler", "-fPIC")

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


def load_library(name: str) -> ctypes.CDLL:
    """Build ``csrc/<name>.cu`` if this source has not been built yet, and
    load it once per process."""
    if name in _LOADED:
        return _LOADED[name]
    source = CSRC_DIR / f"{name}.cu"
    digest = hashlib.sha256(source.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    target = BUILD_DIR / f"lib{name}-{digest}.so"
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
        os.replace(partial, target)  # atomic: a concurrent build never sees half a file
    _LOADED[name] = ctypes.CDLL(str(target))
    return _LOADED[name]
