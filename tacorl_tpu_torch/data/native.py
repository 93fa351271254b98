"""ctypes binding and on-demand build of the native episode loader (port of
tacorl_tpu/data/native.py), ``tacorl_tpu_torch/csrc/episode_loader.cpp``.

The library is built with ``g++ -O3 -march=native`` at first use into
``build/lib<name>-<hash>.so`` of this checkout (the hash covers the source
and the flags, so an edit rebuilds it) and loaded once per process. A
missing compiler or a failed build raises: unlike the JAX package, the port
has no numpy fallback for packed storage (a frame-dir dataset never reaches
this module).

Each gather writes into a new numpy array, or into a caller's ``out``: a
C-contiguous numpy array or CPU tensor of the gather's shape and dtype (the
loader's page-locked tensors on a card), checked here before the native
code gets its address. ``pad_windows`` completes a window batch's rows past
each window's real length in place.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import TYPE_CHECKING, Optional, Sequence, Tuple, Union

import numpy as np

if TYPE_CHECKING:
    import torch

__all__ = ["get_native_lib", "gather_windows", "gather_rows", "pad_windows", "library_path"]

SRC = Path(__file__).resolve().parents[1] / "csrc" / "episode_loader.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
CXX = "g++"
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-shared", "-pthread", "-std=c++17")

# a destination the native code writes: a numpy array or a CPU tensor
Buffer = Union[np.ndarray, "torch.Tensor"]

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
        lib.gather_windows.argtypes = [p_u8, i64, p_i64, p_i64, i64, i64, p_u8]
        lib.gather_windows.restype = None
        lib.pad_windows.argtypes = [p_u8, i64, p_i64, i64, i64, i64]
        lib.pad_windows.restype = None
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


def _lengths(lengths: Sequence[int], n: int, most: int) -> np.ndarray:
    """``lengths`` as contiguous int64, checked to be ``n`` counts in [1, most]."""
    lengths = np.ascontiguousarray(lengths, dtype=np.int64)
    if lengths.shape != (n,):
        raise ValueError(f"lengths of shape {lengths.shape}, not ({n},)")
    if n and (lengths.min() < 1 or lengths.max() > most):
        raise ValueError(f"lengths outside [1, {most}]")
    return lengths


def _row_bytes(array: np.ndarray) -> int:
    return int(np.prod(array.shape[1:], dtype=np.int64)) * array.itemsize


def _view(buf: Buffer) -> np.ndarray:
    """``buf`` as numpy sees it (a CPU tensor's memory, not a copy),
    checked C-contiguous and writable: the native code writes it."""
    view = buf if isinstance(buf, np.ndarray) else buf.numpy()
    if not (view.flags.c_contiguous and view.flags.writeable):
        raise ValueError("the native loader writes only a C-contiguous, writable buffer")
    return view


def _out(out: Optional[Buffer], shape: Tuple[int, ...], dtype: np.dtype) -> Tuple[Buffer, int]:
    """``out`` checked to hold ``shape`` of ``dtype`` (a new array when
    None), and its address."""
    if out is None:
        out = np.empty(shape, dtype=dtype)
    view = _view(out)
    if view.shape != shape or view.dtype != dtype:
        raise ValueError(f"out is {view.dtype} {view.shape}, the gather writes {np.dtype(dtype)} {shape}")
    return out, view.ctypes.data


def _p_i64(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def gather_windows(
    array: np.ndarray,
    start_rows: Sequence[int],
    window_rows: int,
    pad_rows: int = 0,
    out: Optional[Buffer] = None,
    lengths: Optional[Sequence[int]] = None,
) -> Buffer:
    """(B windows) x (window + pad rows) gather from a (n_steps, ...) array
    into ``out`` (a new array when None; else a C-contiguous numpy array or
    CPU tensor of that shape and dtype, returned). Window w's first
    ``lengths[w]`` rows (all ``window_rows`` by default) are copied; with
    ``pad_rows`` the rows after them repeat the last copied row, without
    they are left for ``pad_windows``."""
    rows = _rows(array, start_rows, window_rows)
    if lengths is None:
        lengths = np.full(len(rows), window_rows, dtype=np.int64)
    lengths = _lengths(lengths, len(rows), window_rows)
    out, address = _out(out, (len(rows), window_rows + pad_rows) + array.shape[1:], array.dtype)
    get_native_lib().gather_windows(
        array.ctypes.data_as(ctypes.c_void_p), _row_bytes(array), _p_i64(rows), _p_i64(lengths),
        len(rows), window_rows + pad_rows, address,
    )
    if pad_rows:
        pad_windows(out, lengths)
    return out


def pad_windows(out: Buffer, lengths: Sequence[int], relative: bool = False) -> None:
    """Fill rows ``lengths[w]:`` of each window of a (B, rows, ...) ``out``
    in place from its last real row ``lengths[w] - 1``: repeated whole
    (frames, states) or, ``relative``, zeroed but for the last entry of the
    row's first axis, repeated (a relative action's gripper channel)."""
    if out.ndim < 2 or (relative and out.ndim < 3):
        raise ValueError(f"pad_windows needs (windows, rows{', channels' if relative else ''}, ...), "
                         f"not {tuple(out.shape)}")
    view = _view(out)
    lengths = _lengths(lengths, view.shape[0], view.shape[1])
    row_bytes = int(np.prod(view.shape[2:], dtype=np.int64)) * view.itemsize
    keep_bytes = row_bytes // view.shape[2] if relative else row_bytes
    get_native_lib().pad_windows(view.ctypes.data, row_bytes, _p_i64(lengths), view.shape[0], view.shape[1], keep_bytes)


def gather_rows(array: np.ndarray, rows: Sequence[int], out: Optional[Buffer] = None) -> Buffer:
    """(B rows) gather from a (n_steps, ...) array into ``out`` (as
    ``gather_windows``)."""
    rows = _rows(array, rows, 1)
    out, address = _out(out, (len(rows),) + array.shape[1:], array.dtype)
    get_native_lib().gather_rows(
        array.ctypes.data_as(ctypes.c_void_p), _row_bytes(array), _p_i64(rows), len(rows), address,
    )
    return out
