#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``tacorl_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each, then a JSON ``kernels`` line, the card's name and
power limit, and the last line ``{"ok": true, "device": {...}}``:

  1. env        the card (nvidia-smi name, power limit, max SM clock),
                torch / CUDA versions; TF32 is switched off for float32
                matmuls and convolutions, so float32 means float32.
  2. build      builds both CUDA C++ kernels from this checkout at once
                (one nvcc -arch=sm_90a per source, in parallel, into
                build/cuda), launches each once, and prints each kernel's
                registers, shared memory and spills (ptxas -v) and its
                instructions per pixel (cuobjdump -sass of the library).
  3. kernel     holds ``jitter_normalize`` against its plain PyTorch version
                at the production shape (1024, 3, 128, 128) and at the
                stage-2 goal call's N=64, over all 6 op orders, jitter on
                and off, op rows with contrast in 0, 2 or 3 slots,
                saturated / grey / hue-wrapping pixels: float32 IO at atol
                2e-5, bfloat16 IO at atol 8e-3 (one bf16 ulp at |x| <= 1).
                Also frames off the main path (OTHER_SHAPES), which take
                the kernel's other instantiations. Times it on the
                cycled factor mix (half the images jittered), on the main
                path's mix (``sample_jitter_factors(..., prob=1.0)``) and
                at N=64,
                each beside its bytes bound and its instruction budget.
  4. kernel_shift  ``shift_jitter_normalize`` against its plain version on
                the same images, edge-padded (1024, 3, 140, 140) and
                unpadded with the pad as a clamp, every shift in [0, 12]^2,
                float32 at atol 2e-5, and OTHER_SHAPES; times it on both
                factor mixes.
  5. augment    the fused train augmentation that reaches the CUDA kernel
                (the counterpart of pallas_augment_rgb_train) on a uint8
                (64, 16, 200, 200, 3) batch: one launch per call, output
                finite and in [-1, 1].
  6. reference  one Play-LMP train step at a tiny float32 config on the
                card and on the CPU, from the same weights, batch and
                draws; the losses and gradient norms must agree.
  7. slice      the production Play-LMP train step (batch 64, window 16,
                200x200 uint8 -> 128x128 bf16 augmentation, 2x2048 RNN
                decoder, 2048/4096 transformer posterior, Adam) for 12
                steps: finite losses, changed parameters, and exactly one
                kernel launch per step.
  8. profile    torch.profiler over 5 more steps: the device's busy share
                of the step, each stage's host time and device span, and
                the kernels that take the most device time; then one step
                under torch's sync debug mode: where the host waits for
                the device.
  9. reference_tacorl  one TACO-RL (stage 2) step at a tiny float32 config
                on the card and on the CPU from the same weights, batch and
                draws; q1/actor/decoder losses and alpha agree to 1e-4.
 10. slice_tacorl  the production stage-2 step (stage 1 of phase 7's config
                saved and grafted through the port's CheckpointManager;
                configs/module/tacorl.yaml) for 12 steps: finite losses,
                exactly two jitter launches per step (window and goal),
                frozen parts bit-unchanged, actor / critics / decoder
                changed, targets the Polyak average.
 11. profile_tacorl  as phase 8, for the stage-2 step.

Any failure raises, so the script exits non-zero and prints no last line.
It imports nothing of JAX and nothing of the JAX package.
"""

import copy
import json
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from tacorl_tpu_torch.core.checkpoint import CheckpointManager
from tacorl_tpu_torch.modules.play_lmp import PlayLMPModule
from tacorl_tpu_torch.modules.tacorl import FROZEN, TACORLModule
from tacorl_tpu_torch.ops._cuda_build import build_log, library_path, load_library
from tacorl_tpu_torch.ops.jitter_aug import (
    NUM_SMS,
    PERM_TABLE,
    jitter_normalize,
    jitter_normalize_geometry,
    jitter_normalize_reference,
    sample_jitter_factors,
)
from tacorl_tpu_torch.ops.shift_jitter_aug import (
    fused_augment_rgb_train,
    shift_jitter_normalize,
    shift_jitter_normalize_geometry,
    shift_jitter_normalize_reference,
)

# The card's rated rates (NVIDIA's H100 SXM data sheet, dense, at 700 W):
# HBM bandwidth and the float32 rate outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

# float32 operations per pixel of the kernel's arithmetic: load scale+clip
# (3 channels x 3), normalize (3 x 2), and per op slot brightness (3 x 3),
# contrast (3 x 4, plus 6 for the grayscale sum of its mean), hue (the
# RGB->HSV->RGB chain of compares, selects and arithmetic, about 70)
_OPS_SCALE, _OPS_NORMALIZE = 9, 6
_OPS_PER_OP = {0: 9, 1: 18, 2: 70}  # any other op code is hue
LANES_PER_SM = 128  # an SM issues one instruction for 4 warps of 32 lanes a clock
# op rows the sampler never draws, which the kernels take like the TPU's:
# contrast in two slots, in all three, and in none
ODD_OP_ROWS = ((1, 1, 2), (1, 1, 1), (0, 2, 2), (2, 1, 1))

KERNEL_SHAPE = (1024, 3, 128, 128)  # batch 64 x window 16 frames at 128x128
F32_ATOL, BF16_ATOL = 2e-5, 8e-3
BATCH, WINDOW, RAW_HW = 64, 16, 200
PAD = 6  # configs/transforms/rl.yaml
SLICE_STEPS, SLICE_WARMUP = 12, 2

# __graft_entry__._module(tiny=False): the production Play-LMP config
PRODUCTION_CFG = {
    "lr": 1e-4,
    "kl_beta": 1e-3,
    "latent_plan_dim": 16,
    "plan_proposal_obs_modalities": ["rgb_static"],
    "plan_proposal_goal_modalities": ["rgb_static"],
    "plan_recognition_modalities": ["rgb_static"],
    "action_decoder_modalities": ["rgb_static"],
    "perceptual_encoder": {
        "networks": {
            "rgb_static": {
                "_target_": "tacorl_tpu.networks.encoders.LMPVisionEncoder",
                "latent_dim": 32,
                "hidden_dim": 256,
            }
        }
    },
    "goal_encoder": {"hidden_size": 256},
    "plan_recognition": {
        "num_heads": 8, "num_layers": 2, "encoder_hidden_size": 2048,
        "fc_hidden_size": 4096, "max_position_embeddings": 16,
    },
    "plan_proposal": {"policy": {"num_layers": 2, "hidden_dim": 256}},
    "action_decoder": {
        "hidden_size": 2048, "num_layers": 2, "n_mixtures": 10,
        "bf16_matmul": False,
    },
    "transforms": {
        "rgb_static": {
            "kind": "rgb", "size": [128, 128], "pad": 6, "aug_dtype": "bfloat16",
        }
    },
}


def _tiny_cfg():
    """__graft_entry__._module(tiny=True) in float32 without dropout."""
    cfg = copy.deepcopy(PRODUCTION_CFG)
    cfg["perceptual_encoder"]["networks"]["rgb_static"].update(
        latent_dim=16, hidden_dim=32, compute_dtype=None
    )
    cfg["goal_encoder"] = {"hidden_size": 32}
    cfg["plan_recognition"] = {
        "num_heads": 4, "num_layers": 1, "encoder_hidden_size": 32,
        "fc_hidden_size": 32, "max_position_embeddings": 8, "dropout_p": 0.0,
    }
    cfg["plan_proposal"] = {"policy": {"num_layers": 2, "hidden_dim": 32}}
    cfg["action_decoder"] = {"hidden_size": 32, "num_layers": 1, "n_mixtures": 4}
    cfg["transforms"] = {"rgb_static": {"kind": "rgb", "size": [48, 48], "pad": 2}}
    return cfg


def _batch(b: int, t: int, hw: int, seed: int = 0):
    """__graft_entry__._batch: uint8 (b, t, hw, hw, 3) frames and actions."""
    rs = np.random.RandomState(seed)
    return {
        "states": {
            "rgb_static": rs.randint(0, 255, (b, t, hw, hw, 3), dtype=np.uint8)
        },
        "actions": np.clip(rs.randn(b, t, 7), -1, 1).astype(np.float32),
    }


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def _time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn`` after ``warmup``."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _smi(query: str, fmt: str = "csv,noheader") -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", f"--format={fmt}"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


# the card's max SM clock in Hz, read by phase_env (for the instruction budgets)
SM_CLOCK_HZ = None


def _device_ms(fn, reps: int = 20, rounds: int = 5) -> float:
    """Device time of one call of ``fn``: ``reps`` calls captured in a CUDA
    graph, the graph replayed ``rounds`` times between CUDA events, the
    median over ``reps``. The replay launches no Python, so host launch
    gaps, which a per-call event pair would count, are left out."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def phase_env() -> str:
    global SM_CLOCK_HZ
    card = _smi("name,power.limit")
    SM_CLOCK_HZ = float(_smi("clocks.max.sm", "csv,noheader,nounits")) * 1e6
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(
        f"[env] card: {card}, max SM clock {SM_CLOCK_HZ / 1e6:.0f} MHz | torch "
        f"{torch.__version__} cuda {torch.version.cuda} | tf32: matmul "
        f"{torch.backends.cuda.matmul.allow_tf32} cudnn {torch.backends.cudnn.allow_tf32}",
        flush=True,
    )
    return card


def _ptxas_report(log: str) -> dict:
    """Mangled kernel name -> (registers, smem bytes, spill stores, spill
    loads), from ptxas -v's report."""
    report, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            report.setdefault(name, [0, 0, 0, 0])[2:] = [int(m.group(1)), int(m.group(2))]
            continue
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"Used (\d+) registers.*?(\d+) bytes smem", line)
        if m and name:
            report.setdefault(name, [0, 0, 0, 0])[:2] = [int(m.group(1)), int(m.group(2))]
    return {k: tuple(v) for k, v in report.items()}


def _sass_counts(lib) -> dict:
    """Mangled kernel name -> (instructions, float32 instructions), counted
    in the library's SASS (cuobjdump -sass); NOPs are left out, float32
    instructions are the F* opcodes (FADD, FMUL, FFMA, FMNMX, FSETP, FSEL,
    FRND, F2I, ...) but FLO."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run(
        [tool, "-sass", str(lib)], capture_output=True, text=True, check=True, timeout=300
    ).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            counts[name] = [0, 0]
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", line)
        if name and m and m.group(1) != "NOP":
            counts[name][0] += 1
            counts[name][1] += m.group(1).startswith("F") and m.group(1) != "FLO"
    return {k: tuple(v) for k, v in counts.items()}


def _kernel_symbol(name: str, k: int) -> str:
    """The part of the mangled name of the 16-byte-access instantiation of
    ``name``'s kernel with k chunks per thread (bf16 IO for kernel 1, the
    main path's)."""
    if name == "jitter_normalize":
        return f"23jitter_normalize_kernelI13__nv_bfloat16Li{k}ELb1E"
    return f"29shift_jitter_normalize_kernelILi{k}ELb1E"


# filled by phase_build: per library, the ptxas report and the SASS counts
KERNEL_REPORTS = {}


def _kernel_stats(name: str, k: int) -> dict:
    """Registers, shared memory, spills and instructions per pixel of one
    instantiation. The SASS holds the bodies of brightness, contrast and hue
    once each (the slot loop is not unrolled) and the thread's k x 8 pixels
    unrolled, so its count over k x 8 is the count per pixel of an image that
    runs each op once, as the main path's factor rows do."""
    ptxas, sass = KERNEL_REPORTS[name]
    sym = _kernel_symbol(name, k)
    regs, smem, spill_st, spill_ld = next(v for key, v in ptxas.items() if sym in key)
    total, fp32 = next(v for key, v in sass.items() if sym in key)
    px = k * 8
    return {
        "registers": regs, "smem_static_bytes": smem, "spill_bytes": spill_st + spill_ld,
        "instr_per_px": total / px, "fp32_instr_per_px": fp32 / px,
    }


def phase_build() -> None:
    """Builds both CUDA kernels from this checkout at once (one nvcc per
    source, in parallel), launches each once, and prints what ptxas and the
    SASS say of them."""
    names = ("jitter_normalize", "shift_jitter")
    t0 = time.perf_counter()

    def build(name):
        load_library(name)
        return time.perf_counter() - t0

    with ThreadPoolExecutor(len(names)) as pool:
        secs = dict(zip(names, pool.map(build, names)))
    g = torch.Generator(device="cuda").manual_seed(0)
    for dtype in (torch.float32, torch.bfloat16):
        jitter_normalize(torch.full((2, 3, 128, 128), 100.0, device="cuda", dtype=dtype),
                         sample_jitter_factors(2, g))
    table = torch.zeros((2, 10), device="cuda")
    table[:, 3:6] = torch.tensor(PERM_TABLE[0], dtype=torch.float32)
    shift_jitter_normalize(torch.full((2, 3, 140, 140), 100.0, device="cuda"), table, PAD)
    torch.cuda.synchronize()
    print(
        "[build] nvcc -arch=sm_90a built, in parallel from the start of the phase: "
        + ", ".join(f"csrc/{n}.cu in {t:.1f} s" for n, t in secs.items())
        + " (with csrc/jitter_common.cuh) into build/cuda; no Triton build; both launched",
        flush=True,
    )
    for name in names:
        KERNEL_REPORTS[name] = (_ptxas_report(build_log(name)), _sass_counts(library_path(name)))
        ptxas, sass = KERNEL_REPORTS[name]
        _check(bool(ptxas) and bool(sass), f"no ptxas report or SASS for {name}")
        for sym, (regs, smem, spill_st, spill_ld) in sorted(ptxas.items()):
            total, fp32 = sass.get(sym, (0, 0))
            print(
                f"[build] {sym}: {regs} registers, {smem} bytes static smem, spill "
                f"{spill_st}/{spill_ld} bytes st/ld, SASS {total} instructions ({fp32} F*)",
                flush=True,
            )


def _kernel_inputs():
    """Production-shape images with special colours in their first rows,
    and a factor table cycling through all 6 op orders x apply on/off (the
    "cycled" mix, on which the earlier kernels were timed)."""
    n, _, h, w = KERNEL_SHAPE
    g = torch.Generator(device="cuda").manual_seed(0)
    images = torch.rand(KERNEL_SHAPE, generator=g, device="cuda") * 255.0
    special = torch.tensor(
        [
            [255, 0, 0], [0, 255, 0], [0, 0, 255],  # saturated
            [255, 0, 10], [250, 3, 60],  # max = r, g < b: negative hue, wraps
            [128, 128, 128], [0, 0, 0], [255, 255, 255],  # grey, black, white
            [200, 200, 10], [10, 200, 200], [200, 10, 200],  # max ties
        ],
        dtype=torch.float32, device="cuda",
    )
    images[:, :, : len(special), :] = special.T[None, :, :, None]
    factors = sample_jitter_factors(n, g)
    idx = torch.arange(n, device="cuda")
    perm = torch.tensor(PERM_TABLE, dtype=torch.float32, device="cuda")
    factors[:, 3:6] = perm[idx % 6]
    factors[:, 6] = ((idx // 6) % 2 == 0).float()
    # every 4th image: a large hue offset, so h + offset wraps often
    wide = idx % 4 == 3
    factors[wide, 2] = torch.rand(int(wide.sum()), generator=g, device="cuda") - 0.5
    return images, factors.contiguous()


def _with_odd_rows(factors: torch.Tensor) -> torch.Tensor:
    """The table with every 7th image's op row one of ODD_OP_ROWS, jitter on."""
    out = factors.clone()
    idx = torch.arange(out.shape[0], device=out.device)[6::7]
    rows = torch.tensor(ODD_OP_ROWS, dtype=torch.float32, device=out.device)
    out[idx, 3:6] = rows[torch.arange(len(idx), device=out.device) % len(ODD_OP_ROWS)]
    out[idx, 6] = 1.0
    return out.contiguous()


def _main_mix(n: int, seed: int = 1) -> torch.Tensor:
    """The factor table the main path draws: every image jittered."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    return sample_jitter_factors(n, g, prob=1.0)


def _kernel_bound_ms(images: torch.Tensor, factors: torch.Tensor, out=None):
    """Least time for the work: each input read once and each output
    (``out``, by default the shape and type of ``images``) written once over
    the HBM rate, and the operations these factors need per output pixel
    over the float32 rate; returns (ms, "bytes" | "operations", bytes)."""
    out = images if out is None else out
    h, w = out.shape[-2:]
    nbytes = (
        images.numel() * images.element_size() + out.numel() * out.element_size()
        + factors.numel() * 4
    )
    f = factors.cpu().numpy()
    per_op = np.vectorize(lambda op: _OPS_PER_OP.get(int(op), _OPS_PER_OP[2]))
    per_pixel = _OPS_SCALE + _OPS_NORMALIZE + (f[:, 6] > 0.5) * sum(
        per_op(f[:, 3 + s].astype(np.int64)) for s in range(3)
    )
    ops = float(per_pixel.sum()) * h * w
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / F32_OPS_PER_S * 1e3
    return (bytes_ms, "bytes", nbytes) if bytes_ms >= ops_ms else (ops_ms, "operations", nbytes)


def _issue_ms(instr_per_px: float, pixels: int) -> float:
    """Least time to issue ``instr_per_px`` instructions for each of
    ``pixels`` on every SM's lanes at the card's max SM clock."""
    return instr_per_px * pixels / (NUM_SMS * LANES_PER_SM * SM_CLOCK_HZ) * 1e3


def _report(tag: str, ms: float, bound: tuple, stats: dict, pixels: int) -> str:
    bound_ms, bound_by, nbytes = bound
    issue = _issue_ms(stats["instr_per_px"], pixels)
    fp32 = _issue_ms(stats["fp32_instr_per_px"], pixels)
    return (
        f"{tag}: {ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}: {nbytes / 1e6:.1f} MB at "
        f"{HBM_BYTES_PER_S / 1e12} TB/s, {bound_ms / ms:.1%} of it, {nbytes / ms / 1e9:.2f} TB/s), "
        f"issue budget {issue:.4f} ms ({stats['instr_per_px']:.1f} instr/px; F* {fp32:.4f} ms, "
        f"{stats['fp32_instr_per_px']:.1f}/px)"
    )


def _compare(got, want, atol, what):
    torch.cuda.synchronize()
    _check(got.dtype == want.dtype and got.shape == want.shape, f"{what}: output shape/dtype")
    _check(bool(torch.isfinite(got.float()).all()), f"{what}: output not finite")
    err = (got.float() - want.float()).abs().max().item()
    _check(err <= atol, f"{what}: max abs err {err} > {atol}")
    return err


# (n, h, w) off the main path that take the kernels' other instantiations:
# 2 and 4 chunks a thread (frames above 128x128), and scalar accesses
# (kernel 1: h*w not a multiple of 8; kernel 2: a row not a multiple of 4)
OTHER_SHAPES = ((3, 50, 50), (2, 130, 130), (2, 180, 180), (2, 200, 200))


def _other_shape_errs(kernel: str) -> float:
    """Largest error of ``kernel`` against its plain version over
    OTHER_SHAPES (kernel 1 in both dtypes; kernel 2 padded and unpadded),
    with random images, every op order and the odd op rows, jitter on."""
    g = torch.Generator(device="cuda").manual_seed(3)
    rows = torch.tensor(PERM_TABLE + ODD_OP_ROWS, dtype=torch.float32, device="cuda")
    worst = 0.0
    for n, h, w in OTHER_SHAPES:
        m = n * len(rows)
        factors = sample_jitter_factors(m, g)
        factors[:, 3:6] = rows.repeat(n, 1)
        images = torch.rand((m, 3, h, w), generator=g, device="cuda") * 255.0
        if kernel == "jitter_normalize":
            for dtype, atol in ((torch.float32, F32_ATOL), (torch.bfloat16, BF16_ATOL)):
                x = images.to(dtype)
                worst = max(worst, _compare(jitter_normalize(x, factors),
                                            jitter_normalize_reference(x, factors), atol,
                                            f"jitter_normalize {dtype} {tuple(x.shape)}"))
        else:
            table = _shift_table(factors)
            for x, padded in ((images, False), (_pad(images), True)):
                worst = max(worst, _compare(
                    shift_jitter_normalize(x, table, PAD, padded=padded),
                    shift_jitter_normalize_reference(x, table, PAD, padded=padded), F32_ATOL,
                    f"shift_jitter_normalize {tuple(x.shape)} padded={padded}"))
    return worst


def phase_kernel() -> dict:
    images, factors = _kernel_inputs()
    odd = _with_odd_rows(factors)
    n = images.shape[0]
    errs = {}
    for dtype, atol in ((torch.float32, F32_ATOL), (torch.bfloat16, BF16_ATOL)):
        for count in (n, 64):
            x, f = images[:count].to(dtype).contiguous(), odd[:count].contiguous()
            errs[(dtype, count)] = _compare(
                jitter_normalize(x, f), jitter_normalize_reference(x, f), atol,
                f"jitter_normalize {dtype} N={count}",
            )
    other = _other_shape_errs("jitter_normalize")
    x = images.to(torch.bfloat16).contiguous()  # the main path's dtype
    main = _main_mix(n)
    x64, main64 = x[:64].contiguous(), _main_mix(64, seed=2)
    ms_old = _device_ms(lambda: jitter_normalize(x, factors))
    ms = _device_ms(lambda: jitter_normalize(x, main))
    ms64 = _device_ms(lambda: jitter_normalize(x64, main64))
    plain_ms = _time_ms(lambda: jitter_normalize_reference(x, main))
    geo = jitter_normalize_geometry(n, *x.shape[2:])
    geo64 = jitter_normalize_geometry(64, *x.shape[2:])
    stats = _kernel_stats("jitter_normalize", geo["chunks_per_thread"])
    stats64 = _kernel_stats("jitter_normalize", geo64["chunks_per_thread"])
    bound = _kernel_bound_ms(x, main)
    bound_old, bound64 = _kernel_bound_ms(x, factors), _kernel_bound_ms(x64, main64)
    px = x.shape[0] * x.shape[2] * x.shape[3]
    print(
        f"[kernel] jitter_normalize (CUDA C++, csrc/jitter_normalize.cu) max abs err vs plain, "
        f"op rows incl. contrast in 0/2/3 slots: float32 {errs[(torch.float32, n)]:.3g} (N={n}), "
        f"{errs[(torch.float32, 64)]:.3g} (N=64) (atol {F32_ATOL}); bfloat16 "
        f"{errs[(torch.bfloat16, n)]:.3g}, {errs[(torch.bfloat16, 64)]:.3g} (atol {BF16_ATOL}); "
        f"other frames {OTHER_SHAPES} (2-4 chunks a thread, scalar accesses): {other:.3g}",
        flush=True,
    )
    for tag, g in (("N=1024", geo), ("N=64", geo64)):
        print(f"[kernel] jitter_normalize launch geometry {tag}: {g}", flush=True)
    print(f"[kernel] jitter_normalize bf16 {tuple(x.shape)}, registers {stats['registers']}, "
          f"spills {stats['spill_bytes']} bytes | "
          + _report("cycled mix", ms_old, bound_old, stats, px) + " | "
          + _report("main mix (prob 1.0)", ms, bound, stats, px), flush=True)
    print(f"[kernel] jitter_normalize bf16 {tuple(x64.shape)} (stage-2 goal call), registers "
          f"{stats64['registers']} | " + _report("main mix", ms64, bound64, stats64, px // 16)
          + f" | plain (N=1024, main mix) {plain_ms:.4f} ms; no single PyTorch call computes "
          f"this function, so no library time", flush=True)
    return {
        "name": "jitter_normalize",
        "route": "cuda",
        "source": "tacorl_tpu_torch/csrc/jitter_normalize.cu",
        "replaces": "tacorl_tpu/ops/pallas_aug.py:94",
        "launches": None,
        "max_abs_err": errs[(torch.bfloat16, n)],
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound[0],
        "bound_by": bound[1],
        "library_ms": None,
        "ms_cycled_mix": ms_old,
        "bound_ms_cycled_mix": bound_old[0],
        "ms_n64": ms64,
        "bound_ms_n64": bound64[0],
        "geometry": geo,
        "geometry_n64": geo64,
        **stats,
        "issue_ms": _issue_ms(stats["instr_per_px"], px),
        "comparison_passed": True,
    }


def _shift_inputs():
    """Production entry-shape images (the 128x128 resized frames, and the
    same frames edge-padded to 140x140) and a 10-column factor table:
    kernel 1's table cycling through every op order x apply on/off, and
    every shift (dy, dx) in [0, 2p]^2."""
    images, factors = _kernel_inputs()
    return images.contiguous(), _pad(images), _shift_table(factors)


def _pad(images: torch.Tensor) -> torch.Tensor:
    return torch.nn.functional.pad(images, (PAD,) * 4, mode="replicate").contiguous()


def _shift_table(factors: torch.Tensor) -> torch.Tensor:
    n = factors.shape[0]
    idx = torch.arange(n, device="cuda")
    span = 2 * PAD + 1
    shifts = torch.stack([(idx // span) % span, idx % span], dim=-1).float()
    return torch.cat([factors[:, :7], shifts, torch.zeros((n, 1), device="cuda")], dim=-1).contiguous()


def phase_kernel_shift() -> dict:
    images, padded, table = _shift_inputs()
    odd = _shift_table(_with_odd_rows(table[:, :8]))
    errs = {}
    for name, x, is_padded in (("padded", padded, True), ("unpadded", images, False)):
        errs[name] = _compare(
            shift_jitter_normalize(x, odd, PAD, padded=is_padded),
            shift_jitter_normalize_reference(x, odd, PAD, padded=is_padded),
            F32_ATOL, f"shift_jitter_normalize {name}",
        )
    other = _other_shape_errs("shift_jitter_normalize")
    main = _shift_table(_main_mix(images.shape[0]))
    # the main path (fused_augment_rgb_train) passes the unpadded image
    ms_old = _device_ms(lambda: shift_jitter_normalize(images, table, PAD, padded=False))
    ms = _device_ms(lambda: shift_jitter_normalize(images, main, PAD, padded=False))
    plain_ms = _time_ms(lambda: shift_jitter_normalize_reference(images, main, PAD, padded=False))
    padded_ms = _device_ms(lambda: shift_jitter_normalize(padded, main, PAD))
    out = torch.empty_like(images)
    bound, bound_old = _kernel_bound_ms(images, main, out), _kernel_bound_ms(images, table, out)
    padded_bound = _kernel_bound_ms(padded, main, out)
    geo = shift_jitter_normalize_geometry(images.shape[0], *images.shape[2:], *images.shape[2:])
    geo_padded = shift_jitter_normalize_geometry(images.shape[0], *padded.shape[2:], *images.shape[2:])
    stats = _kernel_stats("shift_jitter", geo["chunks_per_thread"])
    px = images.shape[0] * images.shape[2] * images.shape[3]
    print(
        f"[kernel_shift] shift_jitter_normalize, all 6 op orders x apply on/off, op rows with "
        f"contrast in 0/2/3 slots, every shift in [0, {2 * PAD}]^2: max abs err padded "
        f"{tuple(padded.shape)} {errs['padded']:.3g}, unpadded {tuple(images.shape)} "
        f"{errs['unpadded']:.3g}; other frames {OTHER_SHAPES}, padded and unpadded (2-4 chunks "
        f"a thread, scalar copies): {other:.3g} (float32, atol {F32_ATOL})",
        flush=True,
    )
    print(f"[kernel_shift] launch geometry unpadded {geo}; padded {geo_padded}", flush=True)
    print(
        f"[kernel_shift] unpadded (the main path's input), registers {stats['registers']}, spills "
        f"{stats['spill_bytes']} bytes | " + _report("cycled mix", ms_old, bound_old, stats, px)
        + " | " + _report("main mix", ms, bound, stats, px)
        + f" | padded, main mix: {padded_ms:.4f} ms, bound {padded_bound[0]:.4f} ms | plain "
        f"{plain_ms:.4f} ms; no single PyTorch call computes this function, so no library time",
        flush=True,
    )
    return {
        "name": "shift_jitter_normalize",
        "route": "cuda",
        "source": "tacorl_tpu_torch/csrc/shift_jitter.cu",
        "replaces": "tacorl_tpu/ops/pallas_aug.py:201",
        "launches": None,
        "max_abs_err": max(errs.values()),
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound[0],
        "bound_by": bound[1],
        "library_ms": None,
        "ms_cycled_mix": ms_old,
        "bound_ms_cycled_mix": bound_old[0],
        "ms_padded": padded_ms,
        "bound_ms_padded": padded_bound[0],
        "geometry": geo,
        **stats,
        "issue_ms": _issue_ms(stats["instr_per_px"], px),
        "comparison_passed": True,
    }


def phase_augment(card: str) -> int:
    """The fused train augmentation (the counterpart of
    pallas_augment_rgb_train) on a production window batch; returns the
    kernel's launches in the timed calls."""
    images = torch.from_numpy(_batch(BATCH, WINDOW, RAW_HW)["states"]["rgb_static"]).cuda()
    g = torch.Generator(device="cuda").manual_seed(0)
    calls = 10
    shift_jitter_normalize.launches = 0
    times = []
    for _ in range(calls):
        t0 = time.perf_counter()
        out = fused_augment_rgb_train(images, (128, 128), PAD, generator=g)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    launches = shift_jitter_normalize.launches
    _check(launches == calls, f"shift_jitter_normalize launched {launches} times in {calls} calls")
    _check(out.shape == (BATCH, WINDOW, 128, 128, 3) and out.dtype == torch.float32, "augment output shape")
    _check(bool(torch.isfinite(out).all()), "augment output not finite")
    lo, hi = out.min().item(), out.max().item()
    _check(-1.0 <= lo and hi <= 1.0, f"augment output outside [-1, 1]: {lo}, {hi}")
    print(
        f"[augment] fused_augment_rgb_train uint8 {tuple(images.shape)} -> float32 "
        f"{tuple(out.shape)}: median {statistics.median(times[2:]):.3f} ms/call over calls "
        f"3-{calls}, range [{lo:.4f}, {hi:.4f}], shift_jitter_normalize launches "
        f"{launches} in {calls} calls | {card}",
        flush=True,
    )
    return launches


def phase_reference() -> None:
    """The tiny float32 step on the card against the same step on the CPU."""
    cfg = _tiny_cfg()
    batch = _batch(3, 5, 56, seed=1)
    n = 3 * 5
    g = torch.Generator().manual_seed(1)
    draws = {
        "rgb_static": {
            "shifts": torch.randint(0, 5, (n, 2), generator=g),
            "factors": sample_jitter_factors(n, g),
        }
    }
    eps = torch.randn((3, 16), generator=g)
    results = {}
    for device in ("cpu", "cuda"):
        module = PlayLMPModule(cfg, device=device)
        state = module.init_state(0)
        dev_draws = {"rgb_static": {k: v.to(device) for k, v in draws["rgb_static"].items()}}
        _, metrics = module.make_train_step()(
            state, batch, aug_draws=dev_draws, eps=eps.to(device)
        )
        results[device] = {k: float(v) for k, v in metrics.items()}
    for key in ("total_loss", "kl_loss", "action_loss", "grad_norm"):
        a, b = results["cuda"][key], results["cpu"][key]
        _check(abs(a - b) <= 1e-4 * abs(b) + 1e-6, f"reference {key}: cuda {a} vs cpu {b}")
    print(
        f"[reference] tiny float32 step, cuda vs cpu: total_loss "
        f"{results['cuda']['total_loss']:.6f} vs {results['cpu']['total_loss']:.6f}, "
        f"grad_norm {results['cuda']['grad_norm']:.6f} vs "
        f"{results['cpu']['grad_norm']:.6f} (rtol 1e-4)",
        flush=True,
    )


def _production_step():
    """The production module, its state and train step, and a batch made
    device-resident before the step, as a prefetching loader leaves it (the
    step time excludes the host-to-device copy)."""
    module = PlayLMPModule(PRODUCTION_CFG, device="cuda")
    state = module.init_state(0)
    batch = _batch(BATCH, WINDOW, RAW_HW)
    batch = {
        "states": {k: torch.from_numpy(v).cuda() for k, v in batch["states"].items()},
        "actions": torch.from_numpy(batch["actions"]).cuda(),
    }
    return module, state, module.make_train_step(), batch


def phase_slice(card: str):
    """Returns the kernel's launches in the timed steps, the median step
    time, and a function that runs one more step, for the profile."""
    module, state, step, batch = _production_step()
    before = {k: v.detach().clone() for k, v in module.net.state_dict().items()}
    torch.cuda.synchronize()

    jitter_normalize.launches = 0
    times, losses = [], []
    for _ in range(SLICE_STEPS):
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        loss, grad_norm = metrics["total_loss"].item(), metrics["grad_norm"].item()
        _check(np.isfinite(loss) and np.isfinite(grad_norm), f"non-finite loss {loss} / grad_norm {grad_norm}")
        losses.append(loss)
    launches = jitter_normalize.launches

    _check(state.step == SLICE_STEPS, "step counter")
    _check(launches == SLICE_STEPS, f"jitter_normalize launched {launches} times in {SLICE_STEPS} steps")
    after = module.net.state_dict()
    changed = sum(not torch.equal(before[k], after[k]) for k in before)
    _check(changed > 0, "no parameter changed")
    ms = statistics.median(times[SLICE_WARMUP:])
    print(
        f"[slice] production Play-LMP train step, batch {BATCH} x window {WINDOW}, "
        f"{RAW_HW}x{RAW_HW} uint8 -> 128x128 bf16: {SLICE_STEPS} steps, median "
        f"{ms:.3f} ms/step ({1e3 / ms:.2f} steps/s) over steps {SLICE_WARMUP + 1}-"
        f"{SLICE_STEPS}, first step {times[0]:.1f} ms | loss {losses[0]:.4f} -> "
        f"{losses[-1]:.4f} | {changed}/{len(before)} tensors changed | "
        f"jitter_normalize launches {launches} | {card}",
        flush=True,
    )
    return launches, ms, lambda: step(state, batch)


def phase_profile(
    run_step, step_ms: float, tag: str = "profile", stages=("play_lmp/",), steps: int = 5
) -> None:
    """torch.profiler over ``steps`` more calls of ``run_step``: the
    device's busy share of the unprofiled median step time ``step_ms``, each
    stage's host time and device span (the record_function ranges whose
    names start with one of ``stages``), and the largest kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            run_step()
        torch.cuda.synchronize()
    events = prof.key_averages()
    # record_function ranges appear twice: on the host and as a device-side
    # annotation spanning their kernels; only real kernels count as busy
    ranges = {e.key for e in events if e.device_type == DeviceType.CPU}
    kernels = [e for e in events if e.device_type == DeviceType.CUDA and e.key not in ranges]
    spans = {e.key: e for e in events if e.device_type == DeviceType.CUDA and e.key in ranges}
    device_ms = sum(e.device_time_total for e in kernels) / 1e3 / steps
    print(
        f"[{tag}] step {step_ms:.3f} ms unprofiled; device kernels {device_ms:.3f} "
        f"ms/step (busy {device_ms / step_ms:.1%}, idle {1 - device_ms / step_ms:.1%}); "
        f"{sum(e.count for e in kernels) / steps:.0f} kernels/step",
        flush=True,
    )
    for e in events:
        if e.device_type == DeviceType.CPU and e.key.startswith(tuple(stages)):
            span = spans.get(e.key)
            span_ms = span.device_time_total / 1e3 / steps if span else float("nan")
            print(
                f"[{tag}] stage {e.key}: host {e.cpu_time_total / 1e3 / steps:.3f} "
                f"ms/step under the profiler, device span {span_ms:.3f} ms/step",
                flush=True,
            )
    for e in sorted(kernels, key=lambda e: -e.device_time_total)[:15]:
        print(
            f"[{tag}] kernel {e.device_time_total / 1e3 / steps:8.3f} ms/step "
            f"{e.count / steps:5.0f} calls/step  {e.key[:100]}",
            flush=True,
        )
    syncs = _host_syncs(run_step)
    print(
        f"[{tag}] host waits for the device {sum(syncs.values())} times in one step (torch's sync "
        f"debug mode), at: " + ("; ".join(f"{n}x {site}" for site, n in syncs.items()) or "-"),
        flush=True,
    )


def _host_syncs(run_step) -> dict:
    """The calls of one ``run_step`` that make the host wait for the device
    (a host copy of a result, a copy from pageable host memory), as torch's
    sync debug mode warns of them: the count by calling file and line."""
    import warnings

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            run_step()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    sites = [
        f"{w.filename.rsplit('/', 1)[-1]}:{w.lineno}"
        for w in caught if "synchroniz" in str(w.message)
    ]
    return {site: sites.count(site) for site in dict.fromkeys(sites)}


# ---------------------------------------------------------------------------
# Stage 2: TACO-RL (CQL over the frozen Play-LMP's latent plans)
# ---------------------------------------------------------------------------

LMP_TARGET = "tacorl_tpu.modules.play_lmp.PlayLMPModule"
TRAINED = ("actor", "q1", "q2", "action_decoder")

# configs/module/tacorl.yaml, with its q_network (configs/networks/
# q_network/mlp.yaml) and the rgb_static entry of configs/transforms/rl.yaml
# (tests/test_torch_tacorl.py holds this copy to those files)
TACORL_CFG = {
    "_target_": "tacorl_tpu.modules.tacorl.TACORLModule",
    "lmp_epoch_to_load": -1,
    "finetune_action_decoder": True,
    "action_decoder_lr": 3.0e-4,
    "actor_lr": 1.0e-4,
    "critic_lr": 3.0e-4,
    "discount": 0.95,
    "conservative_weight": 1.0,
    "reward_scale": 10.0,
    "n_action_samples": 4,
    "with_lagrange": True,
    "deterministic_backup": True,
    "bc_epochs": 5,
    "with_dr3": False,
    "dr3_coefficient": 0.03,
    "with_vib": False,
    "vib_coefficient": 0.03,
    "target_entropy": -7.0,
    "q_network": {
        "_target_": "tacorl_tpu.networks.critic.MLPQNetwork",
        "num_layers": 3,
        "hidden_dim": 256,
        "last_layer_activation": "Identity",
    },
    "transforms": {
        "rgb_static": {
            "kind": "rgb", "size": [128, 128], "pad": PAD, "aug_dtype": "bfloat16",
            "brightness": 0.1, "contrast": 0.1, "hue": 0.02, "jitter_prob": 1.0,
        }
    },
}


def _tiny_tacorl_cfg(lmp_dir: str):
    cfg = copy.deepcopy(TACORL_CFG)
    cfg.update(play_lmp_dir=lmp_dir, n_action_samples=3)
    cfg["q_network"].update(num_layers=2, hidden_dim=16)
    cfg["transforms"] = {"rgb_static": {"kind": "rgb", "size": [48, 48], "pad": 2}}
    return cfg


def _tacorl_batch(b: int, t: int, hw: int, seed: int = 0):
    """A window batch with a goal frame and ``disp`` (the goal's distance
    in windows; about one in three is 1, a success)."""
    batch = _batch(b, t, hw, seed)
    rs = np.random.RandomState(seed + 1)
    batch["goal"] = {"rgb_static": rs.randint(0, 255, (b, hw, hw, 3), dtype=np.uint8)}
    batch["disp"] = rs.randint(1, 4, b)
    return batch


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return torch.as_tensor(tree).to(device)


def _save_lmp(cfg: dict, directory: str, device: str) -> None:
    """Stage 1 with seed-0 weights, saved as a checkpoint to graft from."""
    lmp = PlayLMPModule(cfg, device=device)
    CheckpointManager(directory, config={"module": {"_target_": LMP_TARGET, **cfg}}).save(
        0, lmp.init_state(0)
    )


def phase_reference_tacorl() -> None:
    """The tiny float32 TACO-RL step on the card and on the CPU from the
    same weights, batch and draws."""
    b, t, n, latent = 3, 5, 3, 16
    batch = _tacorl_batch(b, t, 56, seed=2)
    g = torch.Generator().manual_seed(2)

    def aug(m):
        return {"rgb_static": {"shifts": torch.randint(0, 5, (m, 2), generator=g),
                               "factors": sample_jitter_factors(m, g)}}

    def eps(*shape):
        return {"eps": torch.randn(shape, generator=g)}

    draws = {
        "aug_states": aug(b * t), "aug_goal": aug(b), "plan_eps": torch.randn((b, latent), generator=g),
        "curr": eps(b, latent), "next_bellman": eps(b, latent),
        "curr_n": eps(n, b, latent), "next_n": eps(n, b, latent),
        "rand": torch.rand((b * n, latent), generator=g) * 2.0 - 1.0,
    }
    results, weights = {}, None
    with tempfile.TemporaryDirectory() as tmp:
        _save_lmp(_tiny_cfg(), tmp, "cpu")
        for device in ("cpu", "cuda"):
            module = TACORLModule(_tiny_tacorl_cfg(tmp), device=device)
            state = module.init_state(0)
            if weights is None:
                weights = {k: v.clone() for k, v in module.net.state_dict().items()}
            module.net.load_state_dict(weights)
            _, metrics = module.make_train_step()(
                state, batch, {"bc_phase": 0.0}, draws=_to_device(draws, device)
            )
            results[device] = {k: float(v) for k, v in metrics.items()}
    for key in ("q1_loss", "actor_loss", "action_loss", "alpha"):
        a, c = results["cuda"][key], results["cpu"][key]
        _check(abs(a - c) <= 1e-4 * abs(c) + 1e-6, f"reference_tacorl {key}: cuda {a} vs cpu {c}")
    print(
        "[reference_tacorl] tiny float32 TACO-RL step, cuda vs cpu (rtol 1e-4): "
        + ", ".join(
            f"{k} {results['cuda'][k]:.6f} vs {results['cpu'][k]:.6f}"
            for k in ("q1_loss", "actor_loss", "action_loss", "alpha")
        ),
        flush=True,
    )


def phase_slice_tacorl(card: str):
    """The production stage-2 step: stage 1 (PRODUCTION_CFG, seed-0
    weights) saved through the port's CheckpointManager and grafted from
    there; the stage-2 config of configs/; a device-resident batch.
    Returns the jitter kernel's launches in the timed steps, the median
    step time, and a function that runs one more step."""
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        _save_lmp(PRODUCTION_CFG, tmp, "cuda")
        torch.cuda.empty_cache()
        module = TACORLModule({**TACORL_CFG, "play_lmp_dir": tmp}, device="cuda")
        setup_s = time.perf_counter() - t0
    state = module.init_state(0)
    step, scalars = module.make_train_step(), module.step_scalars()
    batch = _to_device(_tacorl_batch(BATCH, WINDOW, RAW_HW), "cuda")
    net = module.net
    before = {k: v.detach().clone() for k, v in net.state_dict().items()}
    torch.cuda.synchronize()

    keys = ("q1_loss", "q2_loss", "actor_loss", "action_loss", "alpha")
    jitter_normalize.launches = 0
    times, first, last = [], None, None
    for i in range(SLICE_STEPS):
        if i == SLICE_STEPS - 1:
            targets_prev = {k: v.clone() for k, v in net.state_dict().items() if k.startswith("target_q")}
        t0 = time.perf_counter()
        state, metrics = step(state, batch, scalars)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        last = {k: metrics[k].item() for k in keys}
        _check(all(np.isfinite(v) for v in last.values()), f"non-finite stage-2 metrics {last}")
        first = first or last
    launches = jitter_normalize.launches

    _check(state.step == SLICE_STEPS, "stage-2 step counter")
    _check(
        launches == 2 * SLICE_STEPS,
        f"jitter_normalize launched {launches} times in {SLICE_STEPS} stage-2 steps (2 per step expected)",
    )
    after = net.state_dict()

    def part_keys(part):
        return [k for k in before if k.split(".")[0] == part]

    for part in FROZEN:
        _check(all(torch.equal(before[k], after[k]) for k in part_keys(part)), f"frozen {part} changed")
    for part in TRAINED:
        _check(any(not torch.equal(before[k], after[k]) for k in part_keys(part)), f"{part} did not change")
    # the last step's Polyak update: tau * new critic + (1 - tau) * old target
    tau = module.tau
    for k, prev in targets_prev.items():
        want = (1.0 - tau) * prev + tau * after[k[len("target_"):]]
        _check(torch.allclose(after[k], want, atol=1e-6, rtol=1e-5), f"{k} is not the Polyak average")
    ms = statistics.median(times[SLICE_WARMUP:])
    print(
        f"[slice_tacorl] production TACO-RL (stage 2) train step, batch {BATCH} x window "
        f"{WINDOW}, {RAW_HW}x{RAW_HW} uint8 states + goal -> 128x128 bf16, frozen "
        f"2048/4096 posterior, 2x2048 decoder finetune, 3x256 twin critics, n_action_samples "
        f"{TACORL_CFG['n_action_samples']}: {SLICE_STEPS} steps, median {ms:.3f} ms/step "
        f"({1e3 / ms:.2f} steps/s) over steps {SLICE_WARMUP + 1}-{SLICE_STEPS}, first step "
        f"{times[0]:.1f} ms, set-up (stage-1 save + graft) {setup_s:.1f} s | "
        + ", ".join(f"{k} {first[k]:.4f} -> {last[k]:.4f}" for k in keys)
        + f" | frozen {'/'.join(FROZEN)} bit-unchanged, {'/'.join(TRAINED)} changed, targets "
        f"Polyak-averaged | jitter_normalize launches {launches} | {card}",
        flush=True,
    )
    return launches, ms, lambda: step(state, batch, scalars)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    card = phase_env()
    phase_build()
    kernel = phase_kernel()
    shift = phase_kernel_shift()
    shift["launches"] = phase_augment(card)
    phase_reference()
    launches_lmp, step_ms, run_step = phase_slice(card)
    phase_profile(run_step, step_ms)
    del run_step
    torch.cuda.empty_cache()
    phase_reference_tacorl()
    launches_tacorl, tacorl_ms, run_tacorl = phase_slice_tacorl(card)
    phase_profile(
        run_tacorl, tacorl_ms, tag="profile_tacorl", stages=("tacorl/", "cql/")
    )
    kernel["launches"] = launches_tacorl
    kernel["launches_by_path"] = {"slice": launches_lmp, "slice_tacorl": launches_tacorl}
    shift["launches_by_path"] = {"augment": shift["launches"]}
    print(json.dumps({"kernels": [kernel, shift]}))
    print(card)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
