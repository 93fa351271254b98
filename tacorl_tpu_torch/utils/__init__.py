"""Shared small utilities."""

from __future__ import annotations

import os
from typing import Union

import torch

from tacorl_tpu_torch.parallel.mesh import local_rank

__all__ = ["resolve_device"]


def resolve_device(device: Union[str, torch.device] = "cuda") -> torch.device:
    """The device an entry point runs on. CUDA is the default; without a
    card this raises rather than falling back to the CPU, so a CPU run
    happens only when the caller asks for it (``device="cpu"``). Under a
    launcher (``LOCAL_RANK`` in the environment) "cuda" is the rank's own
    card, ``cuda:<LOCAL_RANK>``, made the current device."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    if dev.type == "cuda" and dev.index is None and "LOCAL_RANK" in os.environ:
        dev = torch.device("cuda", local_rank())
        torch.cuda.set_device(dev)
    return dev
