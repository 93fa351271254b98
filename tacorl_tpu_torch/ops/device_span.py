"""The frozen R3M backbone's span on the card, which a device trace can read.

A ``record_function`` range covers the kernels it launches only in an eager
step: a CUDA graph replays the kernels with no host range around them.
``backbone_span(device)`` launches a marker kernel of one thread
(``csrc/device_span.cu``) on the current stream before the block and
another after it, so a torch.profiler trace shows
``tacorl_span_begin_encoder_backbone`` and
``tacorl_span_end_encoder_backbone`` around the backbone's kernels,
eagerly and in every replay of a graph that captured them. The backbone's
time on the card is the end marker's start less the begin marker's end
(``perfbench/device_spans.py`` reads it). The markers are launched on
every step, traced or not; each costs a launch of an empty kernel (a few
microseconds on the card). On the CPU the block runs without markers."""

from __future__ import annotations

import contextlib
import ctypes
from typing import Iterator

import torch

from tacorl_tpu_torch.ops._cuda_build import load_library

__all__ = ["backbone_span"]


def _launch(name: str, device: torch.device) -> None:
    fn = getattr(load_library("device_span"), name)
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    status = fn(torch.cuda.current_stream(device).cuda_stream)
    if status != 0:
        raise RuntimeError(f"{name}: marker launch failed with CUDA error {status}")


@contextlib.contextmanager
def backbone_span(device: torch.device) -> Iterator[None]:
    """Marker kernels around the block's work on ``device``'s current
    stream (none on the CPU). The end marker is launched only when the
    block completes."""
    if device.type != "cuda":
        yield
        return
    _launch("backbone_span_begin", device)
    yield
    _launch("backbone_span_end", device)
