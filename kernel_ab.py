#!/usr/bin/env python3
"""Times the port's two augmentation kernels against an earlier version of
them on one NVIDIA GPU, in turns (old, new, new, old), in one process.

    git archive <commit> | tar -x -C build/parent
    python3 kernel_ab.py --parent build/parent

``--parent`` is a checkout of an earlier commit of this repository whose
``tacorl_tpu_torch/ops/jitter_aug.py`` holds the Triton ``jitter_normalize``
and whose ``tacorl_tpu_torch/csrc/shift_jitter.cu`` holds the one-block-per-
image CUDA kernel (with its 10-argument launcher). The Triton kernel is
loaded from that file and built into ``<parent>/build/triton``; the old CUDA
kernel is built with nvcc into ``<parent>/build/cuda``. Both versions run on
the inputs of ``chip_smoke.py`` (the cycled factor mix, and the main
path's mix, where every image is jittered) and are held to each other's
output; each time is the device time of one call (``chip_smoke._device_ms``,
CUDA-graph replays). Prints one line per pair and a JSON summary last.
"""

import argparse
import ctypes
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import torch

import chip_smoke as smoke
from tacorl_tpu_torch.ops._cuda_build import NVCC_FLAGS, nvcc_path
from tacorl_tpu_torch.ops.jitter_aug import jitter_normalize
from tacorl_tpu_torch.ops.shift_jitter_aug import shift_jitter_normalize


def _old_jitter(parent: Path):
    """The earlier ``jitter_normalize`` (Triton), loaded from its file."""
    path = parent / "tacorl_tpu_torch" / "ops" / "jitter_aug.py"
    spec = importlib.util.spec_from_file_location("old_jitter_aug", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.jitter_normalize


def _old_shift(parent: Path):
    """The earlier ``shift_jitter_normalize`` launcher, built with nvcc."""
    source = parent / "tacorl_tpu_torch" / "csrc" / "shift_jitter.cu"
    target = parent / "build" / "cuda" / "libshift_jitter_old.so"
    target.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([nvcc_path(), *NVCC_FLAGS, "-o", str(target), str(source)],
                   check=True, capture_output=True, text=True)
    fn = ctypes.CDLL(str(target)).shift_jitter_normalize_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def run(images, table, pad):
        n, _, h, w = images.shape
        out = torch.empty_like(images)
        status = fn(images.data_ptr(), table.data_ptr(), out.data_ptr(), n, h, w, h, w, pad,
                    torch.cuda.current_stream().cuda_stream)
        if status != 0:
            raise RuntimeError(f"old shift_jitter_normalize: CUDA error {status}")
        return out

    return run


def _turns(name: str, old, new, atol: float) -> dict:
    """old, new, new, old: each a device time of one call; the outputs held
    to each other at ``atol``."""
    err = (old().float() - new().float()).abs().max().item()
    if err > atol:
        raise RuntimeError(f"{name}: old and new differ by {err} > {atol}")
    times = [smoke._device_ms(f) for f in (old, new, new, old)]
    row = {"name": name, "old_ms": [times[0], times[3]], "new_ms": [times[1], times[2]],
           "max_abs_diff": err}
    print(f"[ab] {name}: old {times[0]:.4f} / {times[3]:.4f} ms, new {times[1]:.4f} / "
          f"{times[2]:.4f} ms (old, new, new, old), outputs within {err:.3g}", flush=True)
    return row


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--parent", type=Path, required=True)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("kernel_ab: CUDA is not available", file=sys.stderr)
        return 1
    card = smoke.phase_env()
    old_jitter, old_shift = _old_jitter(args.parent), _old_shift(args.parent)

    images, factors = smoke._kernel_inputs()
    n = images.shape[0]
    x = images.to(torch.bfloat16).contiguous()
    main_mix = smoke._main_mix(n)
    x64, main64 = x[:64].contiguous(), smoke._main_mix(64, seed=2)
    rows = [
        _turns("jitter_normalize bf16 N=1024, cycled mix",
               lambda: old_jitter(x, factors), lambda: jitter_normalize(x, factors), smoke.BF16_ATOL),
        _turns("jitter_normalize bf16 N=1024, main mix",
               lambda: old_jitter(x, main_mix), lambda: jitter_normalize(x, main_mix), smoke.BF16_ATOL),
        _turns("jitter_normalize bf16 N=64, main mix",
               lambda: old_jitter(x64, main64), lambda: jitter_normalize(x64, main64), smoke.BF16_ATOL),
    ]
    table, main_table = smoke._shift_table(factors), smoke._shift_table(main_mix)
    pad = smoke.PAD
    for mix, t in (("cycled mix", table), ("main mix", main_table)):
        rows.append(_turns(
            f"shift_jitter_normalize f32 unpadded N=1024, {mix}",
            lambda: old_shift(images, t, pad),
            lambda: shift_jitter_normalize(images, t, pad, padded=False), smoke.F32_ATOL,
        ))
    print(json.dumps({"card": card, "ab": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
