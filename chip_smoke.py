#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``tacorl_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each, then a JSON ``kernels`` line, the card's name and
power limit, and the last line ``{"ok": true, "device": {...}}``:

  1. env        the card (nvidia-smi name, power limit), torch / CUDA /
                Triton versions; TF32 is switched off for float32 matmuls
                and convolutions, so float32 means float32.
  2. build      builds the Triton ``jitter_normalize`` kernel from this
                checkout into build/triton and times the build.
  3. kernel     holds the kernel against its plain PyTorch version at the
                production shape (1024, 3, 128, 128), over all 6 op orders,
                jitter on and off, saturated / grey / hue-wrapping pixels:
                float32 IO at atol 2e-5, bfloat16 IO at atol 8e-3 (one
                bf16 ulp at |x| <= 1). Times both with CUDA events.
  4. reference  one train step at a tiny float32 config on the card and on
                the CPU, from the same weights, batch and draws; the losses
                and gradient norms must agree.
  5. slice      the production Play-LMP train step (batch 64, window 16,
                200x200 uint8 -> 128x128 bf16 augmentation, 2x2048 RNN
                decoder, 2048/4096 transformer posterior, Adam) for 12
                steps: finite losses, changed parameters, and exactly one
                kernel launch per step.
  6. profile    torch.profiler over 5 more steps: the device's busy share
                of the step, each stage's host time and device span, and
                the kernels that take the most device time.

Any failure raises, so the script exits non-zero and prints no last line.
It imports nothing of JAX and nothing of the JAX package.
"""

import copy
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from tacorl_tpu_torch.modules.play_lmp import PlayLMPModule
from tacorl_tpu_torch.ops.jitter_aug import (
    PERM_TABLE,
    jitter_normalize,
    jitter_normalize_reference,
    sample_jitter_factors,
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
_OPS_PER_OP = {0: 9, 1: 18, 2: 70}

KERNEL_SHAPE = (1024, 3, 128, 128)  # batch 64 x window 16 frames at 128x128
F32_ATOL, BF16_ATOL = 2e-5, 8e-3
BATCH, WINDOW, RAW_HW = 64, 16, 200
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


def phase_env() -> str:
    import triton

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(
        f"[env] card: {card} | torch {torch.__version__} cuda {torch.version.cuda} "
        f"triton {triton.__version__} | tf32: matmul "
        f"{torch.backends.cuda.matmul.allow_tf32} cudnn {torch.backends.cudnn.allow_tf32}",
        flush=True,
    )
    return card


def phase_build() -> None:
    t0 = time.perf_counter()
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.full((2, 3, 128, 128), 100.0, device="cuda", dtype=dtype)
        g = torch.Generator(device="cuda").manual_seed(0)
        jitter_normalize(x, sample_jitter_factors(2, g))
    torch.cuda.synchronize()
    print(
        f"[build] triton jitter_normalize (float32 and bfloat16) built and "
        f"launched in {time.perf_counter() - t0:.1f} s",
        flush=True,
    )


def _kernel_inputs():
    """Production-shape images with special colours in their first rows,
    and a factor table cycling through all 6 op orders x apply on/off."""
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


def _kernel_bound_ms(images: torch.Tensor, factors: torch.Tensor):
    """Least time for the work: each input read once and each output written
    once over the HBM rate, and the operations these factors need over the
    float32 rate; returns (ms, "bytes" | "operations", bytes moved)."""
    n, c, h, w = images.shape
    nbytes = 2 * images.numel() * images.element_size() + factors.numel() * 4
    f = factors.cpu().numpy()
    per_pixel = _OPS_SCALE + _OPS_NORMALIZE + (f[:, 6] > 0.5) * sum(
        np.vectorize(_OPS_PER_OP.get)(f[:, 3 + s].astype(np.int64)) for s in range(3)
    )
    ops = float(per_pixel.sum()) * h * w
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / F32_OPS_PER_S * 1e3
    return (bytes_ms, "bytes", nbytes) if bytes_ms >= ops_ms else (ops_ms, "operations", nbytes)


def phase_kernel() -> dict:
    images, factors = _kernel_inputs()
    errs = {}
    for dtype, atol in ((torch.float32, F32_ATOL), (torch.bfloat16, BF16_ATOL)):
        x = images.to(dtype).contiguous()
        got = jitter_normalize(x, factors)
        want = jitter_normalize_reference(x, factors)
        torch.cuda.synchronize()
        _check(got.dtype == dtype and got.shape == x.shape, "kernel output shape/dtype")
        _check(bool(torch.isfinite(got.float()).all()), "kernel output not finite")
        err = (got.float() - want.float()).abs().max().item()
        errs[dtype] = err
        _check(err <= atol, f"jitter_normalize {dtype}: max abs err {err} > {atol}")
    x = images.to(torch.bfloat16).contiguous()  # the main path's dtype
    ms = _time_ms(lambda: jitter_normalize(x, factors))
    plain_ms = _time_ms(lambda: jitter_normalize_reference(x, factors))
    bound_ms, bound_by, nbytes = _kernel_bound_ms(x, factors)
    print(
        f"[kernel] jitter_normalize {tuple(x.shape)}: max abs err float32 "
        f"{errs[torch.float32]:.3g} (atol {F32_ATOL}), bfloat16 "
        f"{errs[torch.bfloat16]:.3g} (atol {BF16_ATOL}) | bf16 kernel {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}: "
        f"{nbytes / 1e6:.1f} MB at {HBM_BYTES_PER_S / 1e12} TB/s); no single "
        f"PyTorch call computes this function, so no library time",
        flush=True,
    )
    return {
        "name": "jitter_normalize",
        "route": "triton",
        "source": "tacorl_tpu_torch/ops/jitter_aug.py",
        "replaces": "tacorl_tpu/ops/pallas_aug.py:94",
        "launches": None,
        "max_abs_err": errs[torch.bfloat16],
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
        "comparison_passed": True,
    }


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
    time, and (state, step, batch) for the profile."""
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
    return launches, ms, (state, step, batch)


def phase_profile(state, step, batch, step_ms: float, steps: int = 5) -> None:
    """torch.profiler over ``steps`` more production train steps: the
    device's busy share of the unprofiled median step time ``step_ms``, each
    stage's host time and device span, and the largest kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            state, _ = step(state, batch)
        torch.cuda.synchronize()
    events = prof.key_averages()
    # record_function ranges appear twice: on the host and as a device-side
    # annotation spanning their kernels; only real kernels count as busy
    ranges = {e.key for e in events if e.device_type == DeviceType.CPU}
    kernels = [e for e in events if e.device_type == DeviceType.CUDA and e.key not in ranges]
    spans = {e.key: e for e in events if e.device_type == DeviceType.CUDA and e.key in ranges}
    device_ms = sum(e.device_time_total for e in kernels) / 1e3 / steps
    print(
        f"[profile] step {step_ms:.3f} ms unprofiled; device kernels {device_ms:.3f} "
        f"ms/step (busy {device_ms / step_ms:.1%}, idle {1 - device_ms / step_ms:.1%}); "
        f"{sum(e.count for e in kernels) / steps:.0f} kernels/step",
        flush=True,
    )
    for e in events:
        if e.device_type == DeviceType.CPU and e.key.startswith("play_lmp/"):
            span = spans.get(e.key)
            span_ms = span.device_time_total / 1e3 / steps if span else float("nan")
            print(
                f"[profile] stage {e.key}: host {e.cpu_time_total / 1e3 / steps:.3f} "
                f"ms/step under the profiler, device span {span_ms:.3f} ms/step",
                flush=True,
            )
    for e in sorted(kernels, key=lambda e: -e.device_time_total)[:15]:
        print(
            f"[profile] kernel {e.device_time_total / 1e3 / steps:8.3f} ms/step "
            f"{e.count / steps:5.0f} calls/step  {e.key[:100]}",
            flush=True,
        )


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    card = phase_env()
    phase_build()
    kernel = phase_kernel()
    phase_reference()
    kernel["launches"], step_ms, slice_state = phase_slice(card)
    phase_profile(*slice_state, step_ms)
    print(json.dumps({"kernels": [kernel]}))
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
