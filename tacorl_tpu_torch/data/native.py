"""ctypes binding and on-demand build of the native episode loader (port of
tacorl_tpu/data/native.py), ``tacorl_tpu_torch/csrc/episode_loader.cpp``.

The library is built with ``g++ -O3 -march=native`` at first use into
``build/lib<name>-<hash>.so`` of this checkout (the hash covers the source
and the flags, so an edit rebuilds it) and loaded once per process. A
missing compiler or a failed build raises: unlike the JAX package, the port
has no numpy fallback for packed storage (a frame-dir dataset never reaches
this module).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

__all__ = ["get_native_lib", "gather_windows", "gather_rows", "library_path"]

SRC = Path(__file__).resolve().parents[1] / "csrc" / "episode_loader.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
CXX = "g++"
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-shared", "-pthread", "-std=c++17")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def library_path() -> Path:
    h = hashlib.sha256(SRC.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libepisode_loader-{h.hexdigest()[:16]}.so"


def _build(target: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    partial = target.with_name(f"{target.name}.{os.getpid()}.tmp")
    try:
        proc = subprocess.run(
            [CXX, *CXX_FLAGS, str(SRC), "-o", str(partial)],
            capture_output=True, text=True, timeout=300,
        )
    except (OSError, subprocess.SubprocessError) as err:
        raise RuntimeError(f"{CXX} could not build {SRC}: {err}") from err
    if proc.returncode != 0:
        partial.unlink(missing_ok=True)
        raise RuntimeError(f"{CXX} failed to build {SRC}:\n{proc.stderr}")
    os.replace(partial, target)  # atomic: a concurrent build never sees half a file


def get_native_lib() -> ctypes.CDLL:
    """The loader library, built on first use; raises when it cannot be."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        target = library_path()
        if not target.is_file():
            _build(target)
        lib = ctypes.CDLL(str(target))
        i64 = ctypes.c_int64
        p_u8 = ctypes.c_void_p
        p_i64 = ctypes.POINTER(ctypes.c_int64)
        lib.gather_windows.argtypes = [p_u8, i64, p_i64, i64, i64, i64, p_u8]
        lib.gather_windows.restype = None
        lib.gather_rows.argtypes = [p_u8, i64, p_i64, i64, p_u8]
        lib.gather_rows.restype = None
        _lib = lib
        return _lib


def _rows(array: np.ndarray, rows: Sequence[int], span: int) -> np.ndarray:
    """``rows`` as contiguous int64, checked so that ``span`` rows from each
    lie inside ``array``."""
    if not array.flags.c_contiguous:
        raise ValueError("the native gather needs a C-contiguous array")
    rows = np.ascontiguousarray(rows, dtype=np.int64)
    if len(rows) and (rows.min() < 0 or rows.max() + span > len(array)):
        raise IndexError(f"rows outside [0, {len(array) - span}]")
    return rows


def _row_bytes(array: np.ndarray) -> int:
    return int(np.prod(array.shape[1:], dtype=np.int64)) * array.itemsize


def gather_windows(
    array: np.ndarray,
    start_rows: Sequence[int],
    window_rows: int,
    pad_rows: int = 0,
) -> np.ndarray:
    """(B windows) x (window + pad rows) gather from a (n_steps, ...) array;
    padding repeats each window's last row."""
    rows = _rows(array, start_rows, window_rows)
    out = np.empty((len(rows), window_rows + pad_rows) + array.shape[1:], dtype=array.dtype)
    get_native_lib().gather_windows(
        array.ctypes.data_as(ctypes.c_void_p), _row_bytes(array),
        rows.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), len(rows),
        window_rows, pad_rows, out.ctypes.data_as(ctypes.c_void_p),
    )
    return out


def gather_rows(array: np.ndarray, rows: Sequence[int]) -> np.ndarray:
    rows = _rows(array, rows, 1)
    out = np.empty((len(rows),) + array.shape[1:], dtype=array.dtype)
    get_native_lib().gather_rows(
        array.ctypes.data_as(ctypes.c_void_p), _row_bytes(array),
        rows.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), len(rows),
        out.ctypes.data_as(ctypes.c_void_p),
    )
    return out
