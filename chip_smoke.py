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
 12. reference_rollout  at the tiny float32 config, LatentPlanRollout and
                TACORLRollout episodes on the card and on the CPU from the
                same weights, env seed, reset infos and draws (one CPU
                generator): every action within 1e-4, grippers, episode
                lengths, successes and successful tasks equal.
 13. rollout    the production Play-LMP agent (phase 7's config, seed-0
                weights) through EvaluationManager.evaluate_all_tasks with
                LatentPlanRollout(plan_duration=15) on FakeCalvinEnv(200x200,
                "hard" tasks, 60 steps), over an expert-play validation set
                the port writes (3 rollouts per task): episodes, env steps,
                ms per decode step (agent + env.step) and per replan, env
                steps/s, kernel launches per decode step and per replan, the
                device's busy share over 100 decode steps (torch.profiler),
                host waits per env step (sync debug mode, also with the
                interpolation matrices copied each call as before), and 0
                jitter_normalize launches.
 14. rollout_tacorl  the same for the stage-2 module of phase 10, saved and
                loaded back through the port's CheckpointManager and
                load_module_from_checkpoint, with TACORLAgent and
                TACORLRollout.
 15. reference_train  the trainer at the tiny float32 config on the card
                and on the CPU, from the same data, weights and draws, for
                6 steps over 2 epochs with validation: every logged metric
                within rtol 1e-4 (a wrong or late prefetched batch shows).
 16. train      stage 1 through ``tacorl_tpu_torch.train.main`` (the command
                ``python -m tacorl_tpu_torch.train``), experiment=
                play_lmp_for_rl at its composed width with the linear KL
                schedule over epochs 0-2 (kl_beta 0, then 5e-4), on a synthetic CALVIN
                set of 200x200 frames packed by the port (12 steps of 64
                windows per epoch): 2 epochs, a val pass and a checkpoint
                per epoch, ckpt_max_to_keep=2. Prints ms/step and steps/s
                over the second epoch beside phase 7's bare step, the
                loader's wait per step, the host-to-device ms of one pinned
                batch, the device's busy share over 10 steps
                (torch.profiler), host waits of a non-logging and a logging
                step (sync debug mode), jitter_normalize launches per train
                step (1) and per val pass (0), checkpoint bytes and save
                ms; then the run's own step on a device-resident batch,
                alone and beside the loader producing pinned and unpinned
                batches (what the loader's host work costs the step).
 17. train_resume  the same run directory with trainer.max_steps raised:
                resumes at the saved step, reloads callbacks_state.json,
                appends to metrics.jsonl.
 18. train_tacorl  stage 2 through the trainer: experiment=tacorl grafted
                from phase 16's run, goals from both strategies, 2 epochs of
                12 steps; the same measurements, 2 launches per train step.
 19. train_callback  experiment=play_lmp_fake on a small expert-play set:
                2 epochs with RolloutCallback scoring val_accuracy, the
                checkpoint monitor on it, then
                ``tacorl_tpu_torch.evaluate.main`` with epoch=best on the card.
 20. reference_cql  one flat CQL train step and one validation step on the
                card and on the CPU from the same weights, batch and draws
                (dropout masks included), at the full widths of three
                configs: experiment=cql_d4rl's ``state_based`` module,
                experiment=cql_fake_state, and experiment=cql_fake with
                MC-dropout critics; every metric within rtol 1e-4.
 21. train_cql  experiment=cql_fake with callbacks/increase_horizon=
                uncertainty and MC-dropout critics through the trainer on a
                small packed flagship-recipe set from ``make_flagship_data``
                (64x64 frames, 12 steps of 32 an epoch, the
                rollout monitor on): 2 epochs with the measurements of phase
                16 but the step beside the loader, 4 jitter_normalize
                launches per train step (observation,
                goal, next observation, next goal), the horizon's growth,
                then a resume that reloads it from callbacks_state.json.
 22. train_cql_state  experiment=cql_fake_state at its full width on the same
                set: 2 epochs with the rollout monitor and the measurements
                of phase 16 (5 steps each beside the loader), 0
                jitter_normalize launches, then
                ``evaluate`` epoch=best with the vector env.
 23. reference_d4rl  one train step and one val step of each D4RL stage
                (PlayLMPD4RLModule, TACORLD4RLModule grafted from it) at a
                tiny float32 config on the card and on the CPU, from the
                same weights, batch and draws: every metric within rtol
                1e-4.
 24. train_d4rl  experiment=play_lmp_d4rl (8-head 2-layer 2048/4096
                posterior padded 29 -> 32, 2x2048 continuous decoder, batch
                64), experiment=tacorl_d4rl grafted from that run, and
                experiment=cql_d4rl (batch 256) through train.main on a
                synthetic .npz of antmaze-large's shapes (29-wide states,
                8-wide actions), 2 epochs of 12 steps each: ms/step over the
                second epoch, busy share, kernels and host waits a step,
                loader wait; finite losses, the frozen posterior
                bit-unchanged in stage 2, actor, critics and decoder changed,
                0 launches of either kernel.
 25. rollout_d4rl  both hierarchical D4RL agents of phase 24's runs on
                FakeD4RLEnv(29, 8, 60 steps), plan_duration 15, 10 episodes
                each: ms per decode step and per replan, env steps/s,
                kernels per decode step, 0 kernel launches.
 26. reference_ril  at tiny float32 configs, card against CPU from the same
                weights, batch and draws: one RIL train and val step (every
                metric within rtol 1e-4), ``cem_optimize`` with and without
                a gripper, RILAgent and OracleSubgoalAgent episodes through
                RILRollout, CEM-refined FlatPolicyAgent and TACORLAgent
                episodes (actions within 1e-4, grippers and outcomes equal).
 27. train_ril  experiment=ril at its composed width (lmp_vision_encoder,
                goal encoder 256 -> 32 Tanh, MLP policies, batch 64, 200x200
                uint8 -> 128x128 bf16) through train.main on phase 16's set,
                2 epochs of 12 steps with phase 16's measurements, 4
                jitter_normalize launches a step counted (the four image
                leaves), the kernel against its plain version at (64, 3,
                128, 128) bf16; then experiment=ril_fake_state on phase 21's
                set with the rollout monitor, 0 launches, evaluate
                epoch=best.
 28. rollout_ril  phase 27's ril_fake_state module with its learned high
                level and with the oracle through RILRollout on the
                ril_fake_state env, and the cql_fake_state (phase 22) and
                TACO-RL (phase 18) modules without and with CEM, each
                through evaluate_all_tasks: env steps/s, ms per decode step
                and per replan, kernels a step, 0 kernel launches.

 29. reference_online  the trainer over OnlineRLDataModule (the pinned
                replay-buffer loader on the card) for the SAC and the
                CQL-online module, visual (48x48 frames through the kernel
                on the card) and on vectors, at tiny float32 widths, on the
                card and on the CPU from the same weights, warm-start buffer
                and draws (the play step's included): 4 steps over 2
                epochs, every logged metric within rtol 1e-4 and every play
                action within 1e-4.
 30. train_online  experiment=sac_online and cql_online at their composed
                widths (lmp_vision_encoder, 3x256 MLP policy and critics,
                batch 256, FakeCalvinEnv 64x64 frames -> 128x128 bf16, a
                1,000-step warm start), then sac_online_fake and
                cql_online_fake (vectors, with the rollout monitor), 2
                epochs of 12 steps each through train.main (depth cut from
                steps_per_epoch 1,000): ms/step over the second epoch, busy
                share, kernels a step, host waits a non-logging and a
                logging step, env steps/s of the warm start and of the play
                step, jitter_normalize launches per play step (2 at N=1:
                observation and goal) and per update (4 at N=256) on the
                visual runs and 0 on the vector runs; the kernel against its
                plain version on the run's own frames at N=1 and N=256
                (bf16, atol 8e-3) and its time at N=1 beside its bytes bound.
 31. train_scan  trainer.steps_per_call > 1 as CUDA-graph replays of the
                train step, each run held against the eager run of the same
                seed and batches (the runs of phases 16, 18, 24, 27 and 30):
                stage 1 (phase 16's run, whose linear KL schedule moves
                kl_beta at each epoch) and stage 2 (phase 18's) at K=4 for 2
                epochs of 12 steps: every row within rtol 1e-4, the
                parameters at step 24 within atol 2.5 lr a step; graph
                captures and replays; kernel 1's launches counted in the
                device trace of the run's own replays of steps 5-12 (8 and
                16: 1 and 2 a step; no eager launch in that span); kernel
                1 against its plain version on the graphed run's own frames
                (bf16, atol 8e-3); ms/step over steps 17-24 beside the eager
                run's; busy share; host waits of a logging and a non-logging
                chunk (sync debug mode); peak memory beside the eager run's.
                Then stage 1 at K=5 (2 chunks and a dropped chunk of 2 an
                epoch, logged) against an eager run of its first 10 steps;
                experiment=cql_fake (against an eager epoch made here), ril,
                play_lmp_d4rl and tacorl_d4rl at K=4 for one epoch; and
                sac_online_fake at K=4, which trains one step a call (its
                train step plays an env step) with no graph.

 32. reference_variants  tiny float32 configs on the card and on the CPU from
                the same weights, batch and draws: (a) a Play-LMP step with
                the Gaussian LSTM decoder and the random-plan loss, (b) a
                visual CQL step with a D2RL actor, DenseNet critics and VIB,
                (c) train-mode forward and backward of each new encoder
                (CustomEncoder, ResNetRLEncoder, DeepSpatialEncoder,
                ResNet18Encoder, R3MEncoder, VectorEncoder) with its
                BatchNorm running statistics: losses, gradient norms,
                outputs and statistics within rtol 1e-4; (d) the
                bf16_matmul ReLU-RNN decoder's forward and backward (the
                recurrence's torch.mm with out_dtype=float32 and its own
                backward on the card, the upcast product on the CPU): loss
                and gradient norm within rtol 1e-4, the output and every
                gradient as far from the float32 decoder's as the CPU's
                bf16 path is, within 2e-2 of its scale; and the bf16
                decoder in a tiny Play-LMP step, K=4 through StepGraph
                against an eager twin with capturable Adam.
 33. slice_variants  at production widths: phase 7's step with
                gaussian.yaml's decoder (2x2048 LSTM, 10 mixtures) and the
                random-plan loss for 12 steps (finite losses, changed
                parameters, one jitter_normalize launch a step), then a K=4
                chunk through core/graphs.py:StepGraph against an eager
                twin with capturable Adam (cuDNN's LSTM captured; kernel 1
                counted in the device trace of the replays); experiment=
                cql_fake's module with networks/policy=d2rl,
                networks/q_network=densenet and VIB for 12 steps (4 launches
                a step); depth_static (64, 16, 200, 200) through
                DeviceTransforms to planar (..., 3, 128, 128), finite, in
                [-1, 1], 0 launches; ms per forward+backward of each new
                encoder at (1024, 3, 128, 128), DeepSpatialEncoder and
                ResNet18Encoder in eval mode too.
 34. train_variants  train.main on the card for 200 steps each:
                play_lmp_fake with networks/action_decoder=gaussian and
                cql_fake with networks/policy=d2rl networks/q_network=
                densenet (the rollout monitor and validation off, one save
                at the stop): finite losses, the mean action (q1)
                loss of the last 20 steps below the first 20's; then
                ``tacorl_tpu_torch.evaluate.main`` on the Gaussian run's
                checkpoint for 2 short-horizon rollouts (the LSTM carry
                through a rollout).
 35. train_ddp  data-parallel training through train.main under a
                launcher's environment (ranks started as ``python3
                chip_smoke.py --ddp-child <spec>``): (a) one rank over
                NCCL repeats phase 31's graphed runs of both stages (K=4):
                every row and weight bit for bit, the gradient all-reduce
                issued from Python only in the warm-up steps and the
                capture (then replayed from the graph), NCCL's kernels and
                kernel 1's launches counted in the device trace of the
                replays of steps 5-12; (b) two ranks sharing the card over
                gloo, eager (gloo cannot be captured), one epoch of each
                stage on the global batch of 64, every step logged,
                against one rank of the same batches run in the phase
                (stage 1's posterior dropout off in both): the first
                step's row within rtol 1e-4, the weights after the epoch
                within atol 2.5 lr a step, each later row's difference
                printed; kernel 1 once a step (twice in stage 2) per rank
                on its 32 x 16 frames and against its plain version on
                them (bf16 atol 8e-3), rank 0 alone wrote; then ms/step of
                (a) and (b) beside phase 31's and the one rank's.
 36. tooling    the JAX package's remaining tools on the card: (a) the XLA
                rgb route (``use_pallas: false``) on the main path's 1,024
                frames of 200x200 uint8 -> 128x128, its first frames against
                the CPU's run on the same draws (float32, atol 2e-5), and
                DeviceTransforms' ms on (64, 16, 200, 200, 3) by the XLA
                route beside the fused route's (bf16 and float32); (b) a
                Lightning-format checkpoint of the production Play-LMP
                (nonzero recurrent biases) through ``python -m
                tacorl_tpu_torch.convert_checkpoint``: the forward loss on
                one batch against the unconverted module's (rtol 1e-4),
                experiment=tacorl grafted from it for 4 steps (kernel 1
                twice a step), ``evaluate`` scoring it over 2 long-horizon
                episodes; (c) a play_lmp_fake validation with the t-SNE
                callback named in the config: exact t-SNE on the card, its
                KL and ms, the PNG; (d) ``utils/profiling.trace`` around 4
                production stage-1 steps, the trace naming the kernel
                once a step; (e) RealWorldEnv over an in-process stand-in
                for robot_io, and one ``evaluate_real_world`` rollout of the
                converted checkpoint; (f) play_lmp_fake (biRNN posterior) at
                K=2 as graph replays across a validation pass against the
                eager run with capturable Adam: every row within rtol 1e-4
                (the kl_loss spike of results/torch_r12_ddp/ run J: the
                pass moved the RNN weights under the graph; StepGraph now
                captures again).
 37. train_tp   tensor parallelism: (a) the production Play-LMP at
                (dp, mp) = (1, 2), two gloo ranks sharing the card
                (``python3 chip_smoke.py --tp-child <spec>``), eager, the
                JAX dry run's four rules (``PLAY_LMP_RULES``) sharding the
                posterior's fc and linear1 and the decoder's heads, 8 steps
                against one rank's mp = 1 run of the same weights and
                batches: the first row at rtol 1e-4, later rows at
                DDP_ROW_RTOL, the replicated weights bit-equal on the two
                ranks, the gathered weights atol 2.5 lr a step; kernel 1
                once a step a rank, and against its plain version on a
                rank's frames; (b) the run's checkpoint (the unsharded
                layout) loaded at mp = 1: the same val loss at rtol 1e-4;
                (c) ``dryrun_multichip(2)`` on the card; ms/step of (a)
                beside one rank's.
 38. train_hierarchy  the visual hierarchy's recipes of
                results/torch_r15_visual/run.sh on the flagship set cut to
                10 + 4 episodes (3 epochs of 16 batches of 32):
                play_lmp_fake for 16 graph replays, then tacorl_fake grafted
                from it at K=8, 2 BC epochs and one of CQL, ``rollout``
                after every epoch and ``rollout_lh`` after the first,
                against the eager run with capturable Adam: every row
                within rtol 1e-4 and the rollout_lh rows equal, the
                weights within atol 2.5 lr a step; the step graph's
                captures at each epoch end (it captures again when a
                rollout moved the net's weights); kernel 1's launches in
                the device trace of the replays of steps 9-16 (2 a step)
                and the kernel against its plain version on the graphed
                run's own frames (bf16, atol 8e-3).

Any failure raises, so the script exits non-zero and prints no last line.
It imports nothing of JAX and nothing of the JAX package.
"""

import contextlib
import copy
import json
import logging
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from tacorl_tpu_torch.callbacks.base import Callback
from tacorl_tpu_torch.config import compose
from tacorl_tpu_torch.core.checkpoint import CheckpointManager, load_module_from_checkpoint
from tacorl_tpu_torch.core.graphs import WARMUP_STEPS
from tacorl_tpu_torch.data.expert_play import generate_expert_play
from tacorl_tpu_torch.data.storage import load_ep_start_end_ids
from tacorl_tpu_torch.envs.fake_calvin import FakeCalvinEnv
from tacorl_tpu_torch.evaluation.agents import make_agent
from tacorl_tpu_torch.evaluation.manager import EvaluationManager
from tacorl_tpu_torch.evaluation.rollout_generator import SingleTaskRolloutGenerator
from tacorl_tpu_torch.modules.cql import CQLModule
from tacorl_tpu_torch.modules.play_lmp import PlayLMPModule
from tacorl_tpu_torch.modules.ril import LEAVES, RILModule
from tacorl_tpu_torch.modules.tacorl import FROZEN, TACORLModule
from tacorl_tpu_torch.ops import image_aug
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
from tacorl_tpu_torch.parallel.mesh import all_reduce_mean

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
    with _uncached_matrices():
        before = _host_syncs(run_step)
    print(
        f"[{tag}] host waits for the device {sum(syncs.values())} times in one step (torch's sync "
        f"debug mode), at: {_sites(syncs)} | {sum(before.values())} with the interpolation "
        f"matrices copied from host memory each call, as before their cache, at: {_sites(before)}",
        flush=True,
    )


def _sites(syncs: dict) -> str:
    return "; ".join(f"{n}x {site}" for site, n in syncs.items()) or "-"


@contextlib.contextmanager
def _uncached_matrices():
    """The interpolation matrices copied from host memory on every call of
    ``image_aug._interp``, as before they were cached on the device."""
    cached = image_aug._interp_on
    image_aug._interp_on = cached.__wrapped__
    try:
        yield
    finally:
        image_aug._interp_on = cached


# what torch's sync debug mode says of a synchronizing call (its first use in
# a process also warns that the mode is a prototype, which is no wait)
SYNC_WARNING = "called a synchronizing CUDA operation"


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
        for w in caught if SYNC_WARNING in str(w.message)
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
    step time, a function that runs one more step, and the module and its
    state (for rollout_tacorl)."""
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
    return launches, ms, lambda: step(state, batch, scalars), (module, state)


# ---------------------------------------------------------------------------
# Stage 3: rollouts (scoring both stages on the fake CALVIN env)
# ---------------------------------------------------------------------------

ROLLOUT_HW, ROLLOUT_STEPS = 200, 60  # 200x200 frames -> 128x128, as in training
PLAN_DURATION = 15  # configs/evaluate.yaml
ROLLOUTS_PER_TASK = 3
PROFILE_DECODE_STEPS, REPLANS = 100, 20
ACTION_ATOL = 1e-4


class _CpuDraws:
    """A rollout manager's draw source from one CPU generator: a replan's
    eps (1, latent) and a decode step's mixture uniforms, the same tensors
    for the card's run and the CPU's."""

    def __init__(self, latent: int, a: int, k: int, seed: int = 0):
        self.g = torch.Generator().manual_seed(seed)
        self.latent, self.a, self.k = latent, a, k

    def __call__(self, call):
        if call == "propose":
            return {"eps": torch.randn((1, self.latent), generator=self.g)}
        lo, hi = 1e-5, 1.0 - 1e-5
        return {
            "u_mix": torch.rand((1, 1, self.a, self.k), generator=self.g) * (hi - lo) + lo,
            "u": torch.rand((1, 1, self.a), generator=self.g) * (hi - lo) + lo,
        }


class _ActionLog:
    """Forwards an agent's calls, keeps every action it returns and the
    start time of the latest decode step (or flat policy step)."""

    def __init__(self, agent):
        self.agent, self.actions, self.t0 = agent, [], None

    def __getattr__(self, name):  # reset, propose_plan, device, ...
        return getattr(self.agent, name)

    def decode_step(self, *args):
        return self._timed(self.agent.decode_step, args)

    def act(self, *args):  # a flat policy's step
        return self._timed(self.agent.act, args)

    def _timed(self, fn, args):
        self.t0 = time.perf_counter()
        action = fn(*args)
        self.actions.append(action)
        return action


class _TimedEnv:
    """Forwards an env; each step records its own time and the time since
    the decode step that chose its action began (agent plus env.step)."""

    def __init__(self, env, log: _ActionLog):
        self.env, self.log, self.step_ms, self.env_ms, self.episodes = env, log, [], [], 0

    def __getattr__(self, name):
        return getattr(self.env, name)

    def reset(self, **kwargs):
        self.episodes += 1
        return self.env.reset(**kwargs)

    def step(self, action):
        t0 = time.perf_counter()
        out = self.env.step(action)
        t1 = time.perf_counter()
        self.env_ms.append((t1 - t0) * 1e3)
        self.step_ms.append((t1 - self.log.t0) * 1e3)
        return out


def phase_reference_rollout() -> None:
    """Tiny float32 LatentPlanRollout and TACORLRollout episodes on the card
    and on the CPU from the same weights, env seed, reset infos and draws."""
    cfg = _tiny_cfg()
    latent, k = cfg["latent_plan_dim"], cfg["action_decoder"]["n_mixtures"]
    resets = ({"task_info": {"task": "open_drawer", "index": 0}},
              {"task_info": {"task": "lift_block", "index": 2}})
    results = {}
    with tempfile.TemporaryDirectory() as tmp:
        _save_lmp(cfg, tmp, "cpu")
        modules = {}
        for device in ("cpu", "cuda"):
            lmp = PlayLMPModule(cfg, device=device)
            lmp_state = lmp.init_state(0)
            tacorl = TACORLModule(_tiny_tacorl_cfg(tmp), device=device)
            tacorl_state = tacorl.init_state(0)
            if modules:  # the card's run takes the CPU's weights
                lmp.net.load_state_dict(modules["cpu"][0].net.state_dict())
                tacorl.net.load_state_dict(modules["cpu"][1].net.state_dict())
            modules[device] = (lmp, tacorl)
            for name, module, state in (("lmp", lmp, lmp_state), ("tacorl", tacorl, tacorl_state)):
                agent, manager_cls = make_agent(module, state)
                log = _ActionLog(agent)
                # 6 continuous action columns beside the gripper
                manager = manager_cls(plan_duration=5, draw_source=_CpuDraws(latent, 6, k))
                env = FakeCalvinEnv(image_hw=64, max_episode_steps=30, seed=0)
                outs = [manager.episode_rollout(log, env, r) for r in resets]
                results[(name, device)] = (outs, np.stack(log.actions))
    worst = {}
    for name in ("lmp", "tacorl"):
        (outs_cpu, acts_cpu), (outs_card, acts_card) = results[(name, "cpu")], results[(name, "cuda")]
        _check(acts_card.shape == acts_cpu.shape, f"reference_rollout {name}: {acts_card.shape} vs {acts_cpu.shape} actions")
        worst[name] = float(np.abs(acts_card[:, :-1] - acts_cpu[:, :-1]).max())
        _check(worst[name] <= ACTION_ATOL, f"reference_rollout {name}: max action error {worst[name]}")
        _check(np.array_equal(acts_card[:, -1], acts_cpu[:, -1]), f"reference_rollout {name}: grippers differ")
        for key in ("episode_length", "success", "successful_tasks"):
            _check([o[key] for o in outs_card] == [o[key] for o in outs_cpu],
                   f"reference_rollout {name}: {key} differs")
    print(
        "[reference_rollout] tiny float32 rollouts, card vs CPU, same weights, env seed, resets and "
        f"draws: LatentPlanRollout {len(results[('lmp', 'cpu')][1])} actions, max abs err "
        f"{worst['lmp']:.3g}; TACORLRollout {len(results[('tacorl', 'cpu')][1])} actions, max abs err "
        f"{worst['tacorl']:.3g} (atol {ACTION_ATOL}); grippers, episode lengths, successes and "
        "successful tasks equal",
        flush=True,
    )


def _expert_validation(root) -> str:
    """An expert-play validation set of 200x200 frames with at least
    ROLLOUTS_PER_TASK verified single-task spans for each "hard" task."""
    generate_expert_play(root, n_train_episodes=0, n_val_episodes=6, image_hw=ROLLOUT_HW, seed=0)
    return f"{root}/validation"


def _jitter_in_trace(events) -> int:
    """jitter_normalize's kernel launches in a profile's device events."""
    from torch.autograd import DeviceType

    ranges = {e.key for e in events if e.device_type == DeviceType.CPU}
    return sum(e.count for e in events if e.device_type == DeviceType.CUDA and e.key not in ranges
               and "jitter_normalize_kernel" in e.key and "shift_" not in e.key)


def _kernel_counts(events, steps: int):
    """Kernels (launches), copies and device ms per step in a profile."""
    from torch.autograd import DeviceType

    ranges = {e.key for e in events if e.device_type == DeviceType.CPU}
    device = [e for e in events if e.device_type == DeviceType.CUDA and e.key not in ranges]
    copies = [e for e in device if e.key.startswith(("Memcpy", "Memset"))]
    kernels = [e for e in device if e not in copies]
    return (
        sum(e.count for e in kernels) / steps,
        sum(e.count for e in copies) / steps,
        sum(e.device_time_total for e in device) / 1e3 / steps,
    )


def _rollout_waits(agent, reset, uncached: bool):
    """Host waits (by call site) and actions of one replan and PLAN_DURATION
    decode steps, env steps included; ``uncached`` copies the interpolation
    matrices from host memory on every call, as before their cache."""
    env = FakeCalvinEnv(image_hw=ROLLOUT_HW, task_set="hard", max_episode_steps=10**6)
    gen = torch.Generator(device="cuda").manual_seed(7)
    actions = []

    def run():
        obs = env.reset(**reset)
        plan = agent.propose_plan(obs, None, gen)
        for _ in range(PLAN_DURATION):
            actions.append(agent.decode_step(obs, plan, None, gen))
            obs = env.step(actions[-1])[0]

    with _uncached_matrices() if uncached else contextlib.nullcontext():
        return _host_syncs(run), np.stack(actions)


def _measure_rollout(tag: str, card: str, module, state, data_dir: str) -> dict:
    """evaluate_all_tasks with the module's agent and rollout manager on
    200x200 frames, then the profile, replan and sync-debug measurements."""
    from torch.profiler import ProfilerActivity, profile

    agent, manager_cls = make_agent(module, state)
    gen = SingleTaskRolloutGenerator(
        data_dir=data_dir, start_end_tasks=f"{data_dir}/start_end_tasks.json",
        min_seq_len=1, max_seq_len=400,
    )
    tasks = gen.get_rollout_tasks()
    _check(len(tasks) == 4 and all(len(v) >= ROLLOUTS_PER_TASK for v in tasks.values()),
           f"{tag}: validation set spans {({t: len(v) for t, v in tasks.items()})}")
    log = _ActionLog(agent)
    env = _TimedEnv(
        FakeCalvinEnv(image_hw=ROLLOUT_HW, task_set="hard", max_episode_steps=ROLLOUT_STEPS), log
    )
    evaluation = EvaluationManager(
        agent=log, env=env, rollout_manager=manager_cls(plan_duration=PLAN_DURATION),
        single_task_generator=gen,
    )
    with tempfile.TemporaryDirectory() as tmp:
        jitter_normalize.launches = 0
        shift_jitter_normalize.launches = 0
        t0 = time.perf_counter()
        results = evaluation.evaluate_all_tasks(f"{tmp}/all_tasks.json", ROLLOUTS_PER_TASK)
        wall = time.perf_counter() - t0
        launches = {"jitter_normalize": jitter_normalize.launches,
                    "shift_jitter_normalize": shift_jitter_normalize.launches}
        _check(json.loads(open(f"{tmp}/all_tasks.json").read()) == results, f"{tag}: results file")
    _check(launches["jitter_normalize"] == 0, f"{tag}: jitter_normalize launched {launches}")
    _check(sorted(results) == sorted(tasks) and all(
        r["num_rollouts"] == ROLLOUTS_PER_TASK and np.isfinite(r["avg_episode_return"])
        and 0.0 <= r["accuracy"] <= 1.0 for r in results.values()), f"{tag}: results {results}")
    steps = len(env.step_ms)
    _check(steps == sum(r["avg_episode_length"] * r["num_rollouts"] for r in results.values()),
           f"{tag}: env steps")
    acts = np.stack(log.actions)
    _check(bool(np.isfinite(acts).all()) and acts.shape == (steps, 7), f"{tag}: actions")
    step_ms = statistics.median(env.step_ms)

    # replans: each call and the device work it queues
    reset = gen.get_reset_info(next(iter(tasks)), 0)
    obs = env.env.reset(**reset)
    g = torch.Generator(device="cuda").manual_seed(3)
    replan_ms = []
    for _ in range(REPLANS):
        t0 = time.perf_counter()
        plan = agent.propose_plan(obs, None, g)
        torch.cuda.synchronize()
        replan_ms.append((time.perf_counter() - t0) * 1e3)
    replan = statistics.median(replan_ms[2:])

    # the profile: 100 decode steps (agent + env.step), then 10 replans
    prof_env = FakeCalvinEnv(image_hw=ROLLOUT_HW, task_set="hard", max_episode_steps=10**6)
    obs = prof_env.reset(**reset)
    plan = agent.propose_plan(obs, None, g)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILE_DECODE_STEPS):
            obs = prof_env.step(agent.decode_step(obs, plan, None, g))[0]
        torch.cuda.synchronize()
    per_decode, copies_decode, device_ms = _kernel_counts(prof.key_averages(), PROFILE_DECODE_STEPS)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            agent.propose_plan(obs, None, g)
        torch.cuda.synchronize()
    per_replan, copies_replan, replan_device_ms = _kernel_counts(prof.key_averages(), 10)

    waits, actions = _rollout_waits(agent, reset, uncached=False)
    waits_before, actions_before = _rollout_waits(agent, reset, uncached=True)
    same = float(np.abs(actions - actions_before).max())
    _check(same == 0.0, f"{tag}: actions with and without the matrix cache differ by {same}")
    print(
        f"[{tag}] evaluate_all_tasks, {type(agent).__name__} + {manager_cls.__name__}"
        f"(plan_duration={PLAN_DURATION}), FakeCalvinEnv {ROLLOUT_HW}x{ROLLOUT_HW} hard, "
        f"{ROLLOUT_STEPS} steps: {env.episodes} episodes, {steps} env steps in {wall:.3f} s "
        f"({steps / wall:.1f} env steps/s), accuracy "
        + ", ".join(f"{t} {r['accuracy']:.2f}" for t, r in results.items())
        + f" | decode step (agent + env.step) median {step_ms:.3f} ms over {steps}, of it "
        f"env.step {statistics.median(env.env_ms):.3f} ms; replan "
        f"(propose + sync) median {replan:.3f} ms | jitter_normalize launches "
        f"{launches['jitter_normalize']}, shift_jitter_normalize {launches['shift_jitter_normalize']} | {card}",
        flush=True,
    )
    print(
        f"[{tag}] profile: {per_decode:.1f} kernels and {copies_decode:.1f} copies per decode step, "
        f"device {device_ms:.3f} ms per decode step over {PROFILE_DECODE_STEPS} (busy "
        f"{device_ms / step_ms:.1%} of the {step_ms:.3f} ms step, idle {1 - device_ms / step_ms:.1%}); "
        f"{per_replan:.1f} kernels and {copies_replan:.1f} copies per replan, device "
        f"{replan_device_ms:.3f} ms per replan",
        flush=True,
    )
    for name, w in (("now", waits), ("with the matrices copied each call", waits_before)):
        print(
            f"[{tag}] host waits ({name}) in one replan + {PLAN_DURATION} env steps: "
            f"{sum(w.values())} ({sum(w.values()) / PLAN_DURATION:.2f} per env step), at: {_sites(w)}",
            flush=True,
        )
    return launches


def phase_rollout(card: str, data_dir: str) -> dict:
    """The production Play-LMP agent (PRODUCTION_CFG, seed-0 weights)."""
    module = PlayLMPModule(PRODUCTION_CFG, device="cuda")
    return _measure_rollout("rollout", card, module, module.init_state(0), data_dir)


def phase_rollout_tacorl(card: str, data_dir: str, trained, trained_state) -> dict:
    """The stage-2 module of phase 10, saved and loaded back through the
    port's CheckpointManager and load_module_from_checkpoint."""
    with tempfile.TemporaryDirectory() as tmp:
        _save_lmp(PRODUCTION_CFG, f"{tmp}/lmp", "cuda")  # phase 10's stage 1: seed 0
        cfg = {**TACORL_CFG, "play_lmp_dir": f"{tmp}/lmp"}
        CheckpointManager(f"{tmp}/tacorl", config={"module": cfg}).save(trained_state.step, trained_state)
        module, state = load_module_from_checkpoint(f"{tmp}/tacorl", device="cuda")
    want = trained.net.state_dict()
    got = state.net.state_dict()
    _check(type(module) is TACORLModule and state.step == trained_state.step
           and all(torch.equal(got[k], v) for k, v in want.items()), "rollout_tacorl: reload")
    return _measure_rollout("rollout_tacorl", card, module, state, data_dir)


# ---------------------------------------------------------------------------
# Stage 4: training through python -m tacorl_tpu_torch.train
# ---------------------------------------------------------------------------

# the synthetic CALVIN set at 200x200: 4 x (220 - 16) = 816 train windows,
# 12 batches of 64; 2 x (220 - 16) = 408 val windows, 20 % of them (the
# config's val_percentage) one batch
TRAIN_EPISODES, VAL_EPISODES, EPISODE_LEN = 4, 2, 220
TRAIN_KEYS = ("rgb_static", "robot_obs", "scene_obs", "rel_actions_world")
TRAIN_STEPS, TRAIN_LOG_EVERY, RESUME_STEPS = 24, 4, 6
PROFILE_FROM, PROFILE_STEPS = 2, 10  # steps 3-12 under torch.profiler
TIMED_FROM, TIMED_TO = 13, 22  # the second epoch's steps 14-22, between syncs
# stage 1's KL warm-up moved into the run: kl_beta 0, 5e-4, 1e-3 in epochs 0-2
LMP_KL = ("callbacks/kl_schedule=linear", "callbacks.kl_schedule.start_epoch=0",
          "callbacks.kl_schedule.end_epoch=2")

# the eager (steps_per_call=1) runs of the train phases that phase train_scan
# repeats at K > 1: experiment -> args, run dir, final parameters and step, ms/step
REFERENCES = {}


def _remember(experiment: str, args: list, trainer, probe) -> None:
    REFERENCES[experiment] = {
        "args": list(args),
        "run_dir": str(trainer.ckpt.dir),
        "params": {k: v.detach().cpu().clone() for k, v in trainer.state.net.state_dict().items()},
        "step": trainer.global_step,
        "ms": probe.ms_per_step() if TIMED_TO in probe.times else None,
    }
# step 23 is a non-logging step and step 24 a logging one (sync debug mode)


class _TrainProbe(Callback):
    """A trainer callback that measures the run it rides in: the profile of
    steps PROFILE_FROM+1 .. PROFILE_FROM+PROFILE_STEPS, the host clock over
    steps TIMED_FROM+1 .. TIMED_TO (a sync at both ends), host waits of
    steps TIMED_TO+1 (non-logging) and TIMED_TO+2 (logging) under torch's
    sync debug mode, jitter_normalize launches per train step and per
    validation pass, and a snapshot of the weights at the start. Its
    ``state_dict`` (steps seen) rides in callbacks_state.json."""

    def __init__(self, measure: bool = True):
        self.measure = measure
        self.steps_seen = 0
        self.loaded = None
        self.step_launches, self.val_launches, self.epoch_steps = [], [], []
        self.times, self.syncs = {}, {}
        self.prof = self.warn = None
        self.device_ms = self.kernels = self.copies = None

    def state_dict(self):
        return {"steps_seen": self.steps_seen}

    def load_state_dict(self, state):
        self.loaded = dict(state)
        self.steps_seen = int(state["steps_seen"])

    def on_fit_start(self, trainer, module):
        self.module = module
        self.before = {k: v.detach().clone() for k, v in trainer.state.net.state_dict().items()}

    def on_epoch_start(self, trainer, module, epoch):
        self.epoch_steps.append(0)
        self._last = jitter_normalize.launches

    def on_train_batch_end(self, trainer, module, metrics, step):
        self.steps_seen += 1
        self.epoch_steps[-1] += 1
        self.step_launches.append(jitter_normalize.launches - self._last)
        self._last = jitter_normalize.launches
        if not self.measure:
            return
        self._profile(step)
        if step in (TIMED_FROM, TIMED_TO):
            torch.cuda.synchronize()
            self.times[step] = time.perf_counter()
        if step in (TIMED_TO + 1, TIMED_TO + 2):
            self._stop_sync_debug(step)
        if step in (TIMED_TO, TIMED_TO + 1):
            self._start_sync_debug()

    def _profile(self, step):
        from torch.profiler import ProfilerActivity, profile

        if step == PROFILE_FROM:
            torch.cuda.synchronize()
            self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            self.prof.__enter__()
            self.t_prof = time.perf_counter()
        elif step == PROFILE_FROM + PROFILE_STEPS:
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - self.t_prof) * 1e3
            self.prof.__exit__(None, None, None)
            kernels, copies, device_ms = _kernel_counts(self.prof.key_averages(), PROFILE_STEPS)
            self.wall_ms, self.kernels, self.copies = wall_ms / PROFILE_STEPS, kernels, copies
            # busy: kernels only (the copies run on the copy engines)
            from torch.autograd import DeviceType

            events = self.prof.key_averages()
            ranges = {e.key for e in events if e.device_type == DeviceType.CPU}
            self.device_ms = sum(
                e.device_time_total for e in events
                if e.device_type == DeviceType.CUDA and e.key not in ranges
                and not e.key.startswith(("Memcpy", "Memset"))
            ) / 1e3 / PROFILE_STEPS
            self.prof = None

    def _start_sync_debug(self):
        import warnings

        self.warn = warnings.catch_warnings(record=True)
        self._caught = self.warn.__enter__()
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")

    def _stop_sync_debug(self, step):
        torch.cuda.set_sync_debug_mode("default")
        self.warn.__exit__(None, None, None)
        sites = [
            f"{w.filename.rsplit('/', 1)[-1]}:{w.lineno}"
            for w in self._caught if SYNC_WARNING in str(w.message)
        ]
        self.syncs[step] = {site: sites.count(site) for site in dict.fromkeys(sites)}

    def on_validation_end(self, trainer, module, metrics, outputs, epoch):
        self.val_launches.append(jitter_normalize.launches - self._last)
        self._last = jitter_normalize.launches

    def ms_per_step(self) -> float:
        return (self.times[TIMED_TO] - self.times[TIMED_FROM]) * 1e3 / (TIMED_TO - TIMED_FROM)


def phase_reference_train() -> None:
    """The trainer at the tiny float32 config on the card and on the CPU:
    the same synthetic packed data, initial weights and draws (a CPU
    generator seeded by the step), 2 epochs with validation. Every logged
    metric must agree (rtol 1e-4), so a batch that the card's pinned
    side-stream prefetch delivered wrong (or late) shows here."""
    from tacorl_tpu_torch.core.logging import MetricsSink
    from tacorl_tpu_torch.core.trainer import Trainer
    from tacorl_tpu_torch.data.datamodule import BasicDataModule
    from tacorl_tpu_torch.data.storage import pack_frames
    from tacorl_tpu_torch.data.synthetic import generate_synthetic_calvin

    cfg = _tiny_cfg()
    b, t, latent, pad = 4, 6, cfg["latent_plan_dim"], cfg["transforms"]["rgb_static"]["pad"]

    def draws(device):
        def source(split, index):
            g = torch.Generator().manual_seed(index if split == "train" else 10_000 + index)
            if split == "train":
                out = {"aug_draws": {"rgb_static": {
                    "shifts": torch.randint(0, 2 * pad + 1, (b * t, 2), generator=g),
                    "factors": sample_jitter_factors(b * t, g),
                }}, "eps": torch.randn((b, latent), generator=g)}
            else:
                out = {"eps": torch.randn((b, latent), generator=g),
                       "pp_eps": torch.randn((b, latent), generator=g)}
            return _to_device(out, device)
        return source

    rows = {}
    with tempfile.TemporaryDirectory() as tmp:
        generate_synthetic_calvin(f"{tmp}/frames", 1, 1, 24, 56, keys=TRAIN_KEYS)
        for split in ("training", "validation"):
            pack_frames(f"{tmp}/frames/{split}", f"{tmp}/packed/{split}")
        for device in ("cpu", "cuda"):
            dm = BasicDataModule(
                f"{tmp}/packed", batch_size=b, val_percentage=1.0, seed=1,
                dataset={"modalities": ["rgb_static", "rel_actions_world"],
                         "min_window_size": 4, "max_window_size": t},
            )
            sink = MetricsSink(f"{tmp}/{device}", console_every=0)
            Trainer(max_steps=6, limit_val_batches=2, log_every_n_steps=1, sink=sink, seed=1,
                    device=device, draw_source=draws(device)).fit(PlayLMPModule(cfg, device=device), dm)
            sink.close()
            rows[device] = _metrics_rows(f"{tmp}/{device}")
    _check([r["step"] for r in rows["cuda"]] == [r["step"] for r in rows["cpu"]], "reference_train: steps")
    worst = 0.0
    for card_row, cpu_row in zip(rows["cuda"], rows["cpu"]):
        _check(set(card_row) == set(cpu_row), "reference_train: metric keys")
        for k, v in cpu_row.items():
            if k not in ("step", "time"):
                err = abs(card_row[k] - v) / max(abs(v), 1e-6)
                worst = max(worst, err)
                _check(err <= 1e-4, f"reference_train {k} at step {cpu_row['step']}: card {card_row[k]} vs cpu {v}")
    print(
        f"[reference_train] tiny float32 trainer, card (pinned loader, side-stream prefetch) vs CPU, "
        f"same data, weights and draws: {len(rows['cpu'])} metric rows over 6 steps, 2 epochs and 2 "
        f"val passes, largest relative difference {worst:.3g} (rtol 1e-4)",
        flush=True,
    )


def _train_data(root) -> str:
    """The synthetic CALVIN set at 200x200, packed; returns its root."""
    from tacorl_tpu_torch.data.storage import pack_frames
    from tacorl_tpu_torch.data.synthetic import generate_synthetic_calvin

    generate_synthetic_calvin(
        f"{root}/frames", TRAIN_EPISODES, VAL_EPISODES, EPISODE_LEN, RAW_HW, keys=TRAIN_KEYS
    )
    for split in ("training", "validation"):
        pack_frames(f"{root}/frames/{split}", f"{root}/packed/{split}")
    shutil.rmtree(f"{root}/frames")
    return f"{root}/packed"


def _train_args(experiment: str, data_dir: str, run_dir: str, max_steps: int, *extra) -> list:
    return [
        f"experiment={experiment}", f"data_dir={data_dir}", f"run_dir={run_dir}",
        f"trainer.max_steps={max_steps}", f"trainer.log_every_n_steps={TRAIN_LOG_EVERY}",
        *extra,
    ]


def _metrics_rows(run_dir) -> list:
    with open(f"{run_dir}/metrics.jsonl") as f:
        return [json.loads(line) for line in f]


def _h2d_ms(trainer) -> tuple:
    """One pinned train batch of the run's loader copied to the card by the
    trainer's DevicePut: median CUDA-event ms of 5 copies, and its bytes."""
    from tacorl_tpu_torch.data.loader import DevicePut, tree_map

    loader = trainer.datamodule.train_loader()
    loader.pin_memory = True
    batch = next(iter(loader))
    sizes = []
    tree_map(lambda t: sizes.append(t.numel() * t.element_size()), batch)
    nbytes = sum(sizes)
    put = DevicePut("cuda")
    times = []
    for _ in range(6):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record(put.stream)
        done = put(batch)
        end.record(put.stream)
        put.ready(done)
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times[1:]), nbytes


def _report_trainer(tag, card, trainer, probe, bare_ms, launches_per_step):
    """Checks and prints what the probe measured in a train phase."""
    _check(trainer.device.type == "cuda", f"{tag}: trained on {trainer.device}")
    _check(all(n == launches_per_step for n in probe.step_launches),
           f"{tag}: jitter_normalize launches per train step {probe.step_launches}")
    _check(all(n == 0 for n in probe.val_launches), f"{tag}: launches in validation {probe.val_launches}")
    after = trainer.state.net.state_dict()
    changed = sum(not torch.equal(probe.before[k], after[k]) for k in probe.before)
    _check(changed > 0, f"{tag}: no parameter changed")
    rows = [r for r in _metrics_rows(trainer.ckpt.dir) if any(k.startswith("train/") for k in r)]
    _check(bool(rows) and all(np.isfinite(v) for r in rows for k, v in r.items() if k.startswith("train/")),
           f"{tag}: non-finite or missing train metrics")
    ms = probe.ms_per_step()
    epoch1 = trainer.batch_wait_ms[-probe.epoch_steps[-1]:]
    h2d_ms, nbytes = _h2d_ms(trainer)
    # the val pass's rows (a rollout callback's rows are validation/<task>/...)
    val_s = [r for r in _metrics_rows(trainer.ckpt.dir)
             if any(k.startswith("validation/") and k.count("/") == 1 for k in r)]
    _check(len(val_s) == len(probe.epoch_steps), f"{tag}: {len(val_s)} val passes in {len(probe.epoch_steps)} epochs")
    saves = ", ".join(f"step {s}: {b / 1e6:.1f} MB in {t:.0f} ms" for s, b, t in trainer.saves)
    bare = (f"bare step (same call) {bare_ms:.3f} ms ({1e3 / bare_ms:.2f} steps/s)" if bare_ms
            else "no bare step of this config")
    print(
        f"[{tag}] {probe.steps_seen} steps in {len(probe.epoch_steps)} epochs {probe.epoch_steps}: "
        f"{ms:.3f} ms/step ({1e3 / ms:.2f} steps/s) over steps {TIMED_FROM + 1}-{TIMED_TO} of the "
        f"second epoch, {bare} | "
        f"loader wait per step (second epoch) median {statistics.median(epoch1):.3f} ms, max "
        f"{max(epoch1):.3f} ms | H2D of one pinned batch ({nbytes / 1e6:.1f} MB) {h2d_ms:.3f} ms "
        f"({nbytes / h2d_ms / 1e6:.2f} GB/s) | {train_loss_line(rows)} | {changed}/{len(after)} "
        f"tensors changed | {card}",
        flush=True,
    )
    print(
        f"[{tag}] profile of {PROFILE_STEPS} steps ({PROFILE_FROM + 1}-{PROFILE_FROM + PROFILE_STEPS}): "
        f"{probe.wall_ms:.3f} ms/step under the profiler, device kernels {probe.device_ms:.3f} ms/step, "
        f"busy {probe.device_ms / probe.wall_ms:.1%} (idle {1 - probe.device_ms / probe.wall_ms:.1%}); "
        f"{probe.kernels:.0f} kernels and {probe.copies:.1f} copies per step",
        flush=True,
    )
    for step, kind in ((TIMED_TO + 1, "non-logging"), (TIMED_TO + 2, "logging")):
        waits = probe.syncs[step]
        print(f"[{tag}] host waits in step {step} ({kind}, loader and callbacks included): "
              f"{sum(waits.values())}, at: {_sites(waits)}", flush=True)
    print(
        f"[{tag}] jitter_normalize launches per train step {sorted(set(probe.step_launches))}, per "
        f"validation pass {probe.val_launches} | checkpoints: {saves}; kept {trainer.ckpt.all_steps()}",
        flush=True,
    )
    return ms


def _step_contention(tag: str, card: str, trainer, probe, steps: int = 10, warmup: int = 2) -> dict:
    """The trained module's own train step (the composed config) on one
    device-resident batch, a sync after each step: alone, then with the
    run's loader producing batches on its threads beside it, pinned and
    unpinned. Separates the config's step from what the loader's host work
    costs the launch-bound training thread; the loader's batches/s is its
    capacity."""
    import threading

    from tacorl_tpu_torch.data.loader import DevicePut

    module, state = probe.module, trainer.state
    step = module.make_train_step()
    put = DevicePut("cuda")
    loader = trainer.datamodule.train_loader()
    loader.pin_memory = True
    batch = put.ready(put(next(iter(loader))))

    def timed():
        nonlocal state
        times = []
        for _ in range(warmup + steps):
            t0 = time.perf_counter()
            state, _ = step(state, batch, module.step_scalars())
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times[warmup:])

    ms = {"alone": timed()}
    rate = {}
    for pin in (True, False):
        stop, produced = threading.Event(), [0]

        def produce():
            while not stop.is_set():
                dl = trainer.datamodule.train_loader()
                dl.pin_memory = pin
                for _ in dl:
                    produced[0] += 1
                    if stop.is_set():
                        break

        thread = threading.Thread(target=produce, daemon=True)
        thread.start()
        time.sleep(0.5)  # the pool's window fills
        t0, n0 = time.perf_counter(), produced[0]
        key = "pinned" if pin else "unpinned"
        ms[key] = timed()
        rate[key] = (produced[0] - n0) / (time.perf_counter() - t0)
        stop.set()
        thread.join(timeout=120)
        _check(not thread.is_alive(), f"{tag}: the loader thread did not stop")
    print(
        f"[{tag}] the run's own step on a device-resident batch (median of {steps}, a sync each): "
        f"alone {ms['alone']:.3f} ms; beside the loader producing pinned batches "
        f"{ms['pinned']:.3f} ms (loader {rate['pinned']:.1f} batches/s), unpinned "
        f"{ms['unpinned']:.3f} ms (loader {rate['unpinned']:.1f} batches/s) | {card}",
        flush=True,
    )
    return ms


def train_loss_line(rows) -> str:
    key = "train/total_loss" if any("train/total_loss" in r for r in rows) else "train/q1_loss"
    rows = [r for r in rows if key in r]
    return f"{key} {rows[0][key]:.4f} (step {rows[0]['step']}) -> {rows[-1][key]:.4f} (step {rows[-1]['step']})"


def phase_train(card: str, data_dir: str, run_dir: str, bare_ms: float):
    """Stage 1 through the trainer: experiment=play_lmp_for_rl (the
    composed config: 3-layer prior MLP, posterior dropout 0.1, unlike
    PRODUCTION_CFG's 2 and 0.01) for two epochs of 12 steps, a val pass and
    a checkpoint per epoch, ckpt_max_to_keep=2."""
    from tacorl_tpu_torch import train

    probe = _TrainProbe()
    jitter_normalize.launches = 0
    args = _train_args("play_lmp_for_rl", data_dir, run_dir, TRAIN_STEPS, "ckpt_max_to_keep=2", *LMP_KL)
    t0 = time.perf_counter()
    trainer = train.main(args, callbacks=[probe])
    wall = time.perf_counter() - t0
    launches = jitter_normalize.launches
    _remember("play_lmp_for_rl", args, trainer, probe)
    _check(trainer.global_step == TRAIN_STEPS and len(probe.epoch_steps) == 2, f"train: {probe.epoch_steps}")
    _check(launches == TRAIN_STEPS, f"train: jitter_normalize launched {launches} times in {TRAIN_STEPS} steps")
    kept = trainer.ckpt.all_steps()
    _check(len(kept) == 2 and kept[-1] == TRAIN_STEPS, f"train: kept {kept}")
    _report_trainer("train", card, trainer, probe, bare_ms, 1)
    _step_contention("train", card, trainer, probe)
    print(f"[train] train.main took {wall:.1f} s (module build, 2 epochs, 2 val passes, 2 saves)", flush=True)
    del trainer
    torch.cuda.empty_cache()
    return launches


def phase_train_resume(card: str, data_dir: str, run_dir: str) -> None:
    """The same run directory with trainer.max_steps raised: the run resumes
    at the saved step, continues global_step, reloads callbacks_state.json
    and appends to metrics.jsonl."""
    from tacorl_tpu_torch import train

    before = _metrics_rows(run_dir)
    probe = _TrainProbe(measure=False)
    trainer = train.main(
        _train_args("play_lmp_for_rl", data_dir, run_dir, TRAIN_STEPS + RESUME_STEPS, "ckpt_max_to_keep=2",
                    *LMP_KL),
        callbacks=[probe],
    )
    rows = _metrics_rows(run_dir)
    steps = [r["step"] for r in rows]
    new_train = [r["step"] for r in rows[len(before):] if any(k.startswith("train/") for k in r)]
    _check(probe.loaded == {"steps_seen": TRAIN_STEPS}, f"train_resume: callback state {probe.loaded}")
    _check(trainer.global_step == TRAIN_STEPS + RESUME_STEPS and probe.steps_seen == TRAIN_STEPS + RESUME_STEPS,
           f"train_resume: global step {trainer.global_step}")
    _check(steps == sorted(steps) and new_train and new_train[0] > TRAIN_STEPS,
           f"train_resume: metrics.jsonl steps {steps}")
    _check(trainer.ckpt.latest_step() == TRAIN_STEPS + RESUME_STEPS, "train_resume: no checkpoint at the stop")
    print(
        f"[train_resume] resumed at step {TRAIN_STEPS} (epoch 0 of the resumed run, as the JAX trainer "
        f"does), {RESUME_STEPS} more steps to {trainer.global_step}; callbacks_state.json reloaded "
        f"{probe.loaded}; metrics.jsonl steps increasing ({len(before)} -> {len(rows)} rows); kept "
        f"{trainer.ckpt.all_steps()} | {card}",
        flush=True,
    )
    del trainer
    torch.cuda.empty_cache()


def phase_train_tacorl(card: str, data_dir: str, lmp_dir: str, run_dir: str, bare_ms: float):
    """Stage 2 through the trainer: experiment=tacorl grafted from the train
    phase's run, goals from both strategies (geometric and
    similar_robot_obs), two epochs of 12 steps."""
    from tacorl_tpu_torch import train

    probe = _TrainProbe()
    jitter_normalize.launches = 0
    args = _train_args("tacorl", data_dir, run_dir, TRAIN_STEPS, f"play_lmp_dir={lmp_dir}")
    t0 = time.perf_counter()
    trainer = train.main(args, callbacks=[probe])
    wall = time.perf_counter() - t0
    launches = jitter_normalize.launches
    _remember("tacorl", args, trainer, probe)
    ds = trainer.datamodule.train_dataset
    _check(ds.include_goal and set(ds.goal_strategy_prob) == {"geometric", "similar_robot_obs"},
           f"train_tacorl: goal strategies {getattr(ds, 'goal_strategy_prob', None)}")
    _check(launches == 2 * TRAIN_STEPS, f"train_tacorl: jitter_normalize launched {launches} times")
    _report_trainer("train_tacorl", card, trainer, probe, bare_ms, 2)
    _step_contention("train_tacorl", card, trainer, probe)
    print(f"[train_tacorl] train.main took {wall:.1f} s (graft, k-NN goal index, 2 epochs, 2 val "
          f"passes, 2 saves)", flush=True)
    del trainer
    torch.cuda.empty_cache()
    return launches


def phase_train_callback(card: str, root: str) -> None:
    """experiment=play_lmp_fake on a small expert-play set for 2 epochs, the
    RolloutCallback scoring each epoch into val_accuracy, the checkpoint
    monitor on it (mode max); then python -m tacorl_tpu_torch.evaluate
    epoch=best scores the run on the card."""
    from tacorl_tpu_torch import evaluate, train

    generate_expert_play(f"{root}/play", n_train_episodes=4, n_val_episodes=3, image_hw=64, seed=1)
    run_dir = f"{root}/run"
    jitter_normalize.launches = 0
    t0 = time.perf_counter()
    trainer = train.main([
        "experiment=play_lmp_fake", f"data_dir={root}/play", f"run_dir={run_dir}",
        "trainer.max_epochs=2", f"trainer.log_every_n_steps={TRAIN_LOG_EVERY}",
    ])
    wall = time.perf_counter() - t0
    _check(trainer.device.type == "cuda", "train_callback: platform: cpu moved the run off the card")
    rows = _metrics_rows(run_dir)
    accs = [r["val_accuracy"] for r in rows if "val_accuracy" in r]
    _check(len(accs) == 2, f"train_callback: val_accuracy logged {len(accs)} times")
    kept, best = trainer.ckpt.all_steps(), trainer.ckpt.best_step()
    _check(best in kept, f"train_callback: best step {best} not in {kept}")
    with tempfile.TemporaryDirectory() as tmp:
        t1 = time.perf_counter()
        results = evaluate.main([
            f"module_path={run_dir}", "epoch=best", "eval_type=short_horizon",
            f"data_dir={root}/play/validation", "min_seq_len=1", "max_seq_len=400",
            "max_rollouts=2", "plan_duration=4", "env.max_episode_steps=56",
            f"filename={tmp}/best.json",
        ])
        eval_s = time.perf_counter() - t1
    _check(bool(results) and all(np.isfinite(r["accuracy"]) for r in results.values()),
           f"train_callback: evaluate results {results}")
    print(
        f"[train_callback] play_lmp_fake, 2 epochs of {trainer.global_step // 2} steps in {wall:.1f} s, "
        f"RolloutCallback val_accuracy {accs}, monitor val_accuracy (max): kept {kept}, best_step "
        f"{best} | evaluate epoch=best short_horizon on the card in {eval_s:.1f} s: "
        + ", ".join(f"{t} {r['accuracy']:.2f}" for t, r in results.items())
        + f" (an untrained policy scores about 0) | jitter_normalize launches "
        f"{jitter_normalize.launches} | {card}",
        flush=True,
    )
    del trainer
    torch.cuda.empty_cache()


# -- flat goal-conditioned CQL --------------------------------------------------------------

CONFIG_DIR = str(Path(__file__).resolve().parent / "configs")
# the three flat-CQL configs at their composed widths
FLAT_CASES = {
    "state_based": ["experiment=cql_d4rl"],
    "cql_fake_state": ["experiment=cql_fake_state"],
    "cql_fake_dropout": ["experiment=cql_fake", "module.q_network.with_dropout=true"],
}
FLAT_BATCH, FLAT_HW = 32, 64  # the experiments' batch size, the fake env's frames
CQL_LAUNCHES_PER_STEP = 4  # rgb_static of observation, goal, next observation, next goal


def _flat_module_cfg(overrides) -> dict:
    return compose(CONFIG_DIR, "train", list(overrides))["module"]


def _flat_batch(module, seed: int) -> dict:
    """A transition batch in the layout the module reads: flat arrays for
    a state-based module, else observation/goal dicts of its modalities."""
    rs, bs, cfg = np.random.RandomState(seed), FLAT_BATCH, module.cfg
    if cfg.get("state_based"):
        dim = int(cfg["state_dim"]) + int(cfg.get("goal_dim", 2))
        obs, next_obs = (rs.randn(bs, dim).astype(np.float32) for _ in range(2))
    else:
        dims = cfg.get("vector_dims", {})

        def frame():
            return {m: rs.randn(bs, dims[m]).astype(np.float32) if m in dims
                    else rs.randint(0, 256, (bs, FLAT_HW, FLAT_HW, 3), dtype=np.uint8)
                    for m in module.obs_modalities}

        goal = frame()
        obs, next_obs = {"observation": frame(), "goal": goal}, {"observation": frame(), "goal": goal}
    reached = (rs.rand(bs) < 0.2).astype(np.float32)
    return {"observations": obs, "actions": rs.uniform(-1, 1, (bs, module.action_dim)).astype(np.float32),
            "next_observations": next_obs, "rewards": reached, "terminals": reached}


def _flat_draws(module, g, bs: int = FLAT_BATCH) -> dict:
    """Every draw of one CQL update of ``bs`` transitions from the CPU
    generator ``g``: the actor samples, the random actions, the augmentation
    of each image leaf (by the module's transform config) and the
    MC-dropout masks."""
    n, a = module.n_action_samples, module.action_dim

    def actor(*lead):
        return _actor_draws(module, g, *lead)

    draws = {"curr": actor(bs), "next_bellman": actor(bs), "curr_n": actor(n, bs),
             "next_n": actor(n, bs), "rand": torch.rand((bs * n, a), generator=g) * 2.0 - 1.0}
    if module.critic_dropout:
        q = module.net.q1.critic.Q
        draws["dropout"] = {rows: torch.rand((rows, q.trunk_dim), generator=g) >= q.dropout_p
                            for rows in (bs, n * bs)}
    if any(c.get("kind") == "rgb" for m, c in module.transforms.cfg.items() if m in module.obs_modalities):
        draws["aug_obs"], draws["aug_next_obs"] = _aug_draws(module, g, bs), _aug_draws(module, g, bs)
    return draws


def _actor_draws(module, g, *lead) -> dict:
    """The actor's standard normals (and, with a gripper, Gumbel uniforms)
    for actions of shape ``lead``, from the CPU generator ``g``."""
    a = module.action_dim
    if not module.net.actor.actor.discrete_gripper:
        return {"eps": torch.randn(lead + (a,), generator=g)}
    return {"eps": torch.randn(lead + (a - 1,), generator=g),
            "gumbel_u": torch.rand(lead + (2,), generator=g) * (1 - 2e-6) + 1e-6}


def _aug_draws(module, g, n: int) -> dict:
    """The DeviceTransforms draws of ``n`` observation/goal pairs for each
    image leaf of the module, from the CPU generator ``g``."""
    images = {m: c for m, c in module.transforms.cfg.items() if c.get("kind") == "rgb"
              and m in module.obs_modalities}
    return {part: {m: {
        "shifts": torch.randint(0, 2 * int(c.get("pad", 6)) + 1, (n, 2), generator=g),
        "factors": sample_jitter_factors(
            n, g, brightness=float(c.get("brightness", 0.1)), contrast=float(c.get("contrast", 0.1)),
            hue=float(c.get("hue", 0.02)), prob=float(c.get("jitter_prob", 1.0))),
    } for m, c in images.items()} for part in ("observation", "goal")}


def phase_reference_cql() -> None:
    """One flat CQL train step and one validation step per FLAT_CASES
    config on the card and on the CPU, from the same weights, batch and
    draws: every metric within rtol 1e-4."""
    lines = []
    for case, overrides in FLAT_CASES.items():
        cfg = _flat_module_cfg(overrides)
        results, weights = {}, None
        for device in ("cpu", "cuda"):
            module = CQLModule(cfg, device=device)
            state = module.init_state(0)
            if weights is None:
                weights = {k: v.clone() for k, v in module.net.state_dict().items()}
                batch = _flat_batch(module, seed=3)
                draws = _flat_draws(module, torch.Generator().manual_seed(3))
            module.net.load_state_dict(weights)
            on_device = _to_device(draws, device)
            val, _ = module.make_val_step()(state, batch, {"bc_phase": 0.0}, draws=on_device)
            _, train = module.make_train_step()(state, batch, {"bc_phase": 0.0}, draws=on_device)
            results[device] = {**{f"train/{k}": float(v) for k, v in train.items()},
                               **{f"val/{k}": float(v) for k, v in val.items()}}
        _check(set(results["cuda"]) == set(results["cpu"]), f"reference_cql {case}: metric keys")
        worst = 0.0
        for key, c in results["cpu"].items():
            a = results["cuda"][key]
            _check(np.isfinite(a) and abs(a - c) <= 1e-4 * abs(c) + 1e-6,
                   f"reference_cql {case} {key}: cuda {a} vs cpu {c}")
            worst = max(worst, abs(a - c) / max(abs(c), 1e-6))
        lines.append(f"{case} {len(results['cpu'])} metrics, q1_loss {results['cuda']['train/q1_loss']:.6f} "
                     f"vs {results['cpu']['train/q1_loss']:.6f}, largest relative difference {worst:.3g}")
    print("[reference_cql] flat CQL train + val step, cuda vs cpu at the configs' widths, batch "
          f"{FLAT_BATCH} (rtol 1e-4): " + "; ".join(lines), flush=True)


def _flat_train_data(root) -> tuple:
    """The flagship expert-play set's recipe at 8 train and 3 validation
    episodes, packed (``make_flagship_data``); returns its root and the
    train_percentage that makes an epoch 12 batches of 32 (400
    transitions)."""
    from tacorl_tpu_torch import make_flagship_data

    make_flagship_data.main(f"{root}/play", n_train_episodes=8, n_val_episodes=3)
    n = sum(int(e) - int(s) for s, e in load_ep_start_end_ids(f"{root}/play/training", True))
    _check(n >= 416, f"flat train data: {n} transitions")
    return f"{root}/play", 400 / n


FLAT_ARGS = ("callbacks.rollout.num_rollouts_per_task=1",)


class _HorizonProbe(Callback):
    """The train dataset's goal horizon at each epoch start."""

    def __init__(self):
        self.horizons = []

    def on_epoch_start(self, trainer, module, epoch):
        self.horizons.append(trainer.datamodule.train_dataset.current_horizon)


def phase_train_cql(card: str, data_dir: str, pct: float, run_dir: str):
    """experiment=cql_fake with the uncertainty-gated horizon (threshold
    raised so that every epoch grows it) and MC-dropout critics, 2 epochs of
    12 steps, then a resume that reloads the horizon."""
    from tacorl_tpu_torch import train

    args = ["callbacks/increase_horizon=uncertainty", "callbacks.increase_horizon.std_threshold=1e9",
            "module.q_network.with_dropout=true", f"datamodule.train_percentage={pct}", *FLAT_ARGS]
    probe, horizon = _TrainProbe(), _HorizonProbe()
    jitter_normalize.launches = 0
    t0 = time.perf_counter()
    trainer = train.main(_train_args("cql_fake", data_dir, run_dir, TRAIN_STEPS, *args),
                         callbacks=[probe, horizon])
    wall = time.perf_counter() - t0
    launches = jitter_normalize.launches
    _check(type(trainer.callbacks[0]).__name__ == "IncreaseHorizonUncertainty", "train_cql: callbacks")
    _check(trainer.global_step == TRAIN_STEPS and probe.epoch_steps == [12, 12], f"train_cql: {probe.epoch_steps}")
    _check(launches == CQL_LAUNCHES_PER_STEP * TRAIN_STEPS, f"train_cql: jitter_normalize launched {launches} times")
    _report_trainer("train_cql", card, trainer, probe, None, CQL_LAUNCHES_PER_STEP)
    rows = _metrics_rows(run_dir)
    grown = [r["train/goal_horizon"] for r in rows if "train/goal_horizon" in r]
    stds = [r["train/Q_avg_std"] for r in rows if "train/Q_avg_std" in r]
    saved = json.loads(open(f"{run_dir}/callbacks_state.json").read())["IncreaseHorizonUncertainty"]
    final = trainer.datamodule.train_dataset.current_horizon
    _check(grown == [8.0, 12.0] and final == 16 and saved == {"current_horizon": 16},
           f"train_cql: horizon {grown} -> {final}, saved {saved}")
    _check(all(np.isfinite(s) and s > 0 for s in stds), f"train_cql: Q_avg_std {stds}")
    del trainer
    torch.cuda.empty_cache()
    resumed = _HorizonProbe()
    trainer = train.main(_train_args("cql_fake", data_dir, run_dir, TRAIN_STEPS + RESUME_STEPS, *args),
                         callbacks=[resumed])
    _check(resumed.horizons[0] == 16 and trainer.global_step == TRAIN_STEPS + RESUME_STEPS,
           f"train_cql resume: horizons {resumed.horizons}")
    print(
        f"[train_cql] train.main took {wall:.1f} s (2 epochs, 2 val passes with the rollout monitor, 2 "
        f"saves) | horizon at the epoch starts {horizon.horizons}, logged {grown}, Q_avg_std "
        f"{[round(s, 6) for s in stds]}, callbacks_state.json {saved} | resumed at step {TRAIN_STEPS}: "
        f"horizon {resumed.horizons[0]} reloaded, {RESUME_STEPS} more steps | {card}",
        flush=True,
    )
    del trainer
    torch.cuda.empty_cache()
    return launches


def phase_train_cql_state(card: str, data_dir: str, pct: float, run_dir: str):
    """experiment=cql_fake_state at its full width, 2 epochs of 12 steps with
    the rollout monitor and the linear horizon, then evaluate epoch=best."""
    from tacorl_tpu_torch import evaluate, train

    probe = _TrainProbe()
    jitter_normalize.launches = 0
    t0 = time.perf_counter()
    trainer = train.main(
        _train_args("cql_fake_state", data_dir, run_dir, TRAIN_STEPS, f"datamodule.train_percentage={pct}",
                    *FLAT_ARGS),
        callbacks=[probe],
    )
    wall = time.perf_counter() - t0
    launches = jitter_normalize.launches
    _check(launches == 0, f"train_cql_state: jitter_normalize launched {launches} times")
    _check(not any(".encoder." in k for k in trainer.state.net.state_dict()), "train_cql_state: encoders built")
    _report_trainer("train_cql_state", card, trainer, probe, None, 0)
    # a few steps: beside the loader's per-item sampling the step is slow
    _step_contention("train_cql_state", card, trainer, probe, steps=5, warmup=1)
    rows = _metrics_rows(run_dir)
    accs = [r["val_accuracy"] for r in rows if "val_accuracy" in r]
    horizons = [r["train/goal_horizon"] for r in rows if "train/goal_horizon" in r]
    _check(len(accs) == 2 and horizons == [16.0, 24.0], f"train_cql_state: {accs}, {horizons}")
    best = trainer.ckpt.best_step()
    del trainer
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        t1 = time.perf_counter()
        results = evaluate.main([
            f"module_path={run_dir}", "epoch=best", "eval_type=short_horizon",
            f"data_dir={data_dir}/validation", "env.image_hw=64", "env.max_episode_steps=56",
            "env.task_set=hard", "env.modalities=[robot_obs,scene_obs]",
            "env.goal_modalities=[robot_obs,scene_obs]", "min_seq_len=1", "max_seq_len=64",
            "max_rollouts=2", f"filename={tmp}/best.json",
        ])
        eval_s = time.perf_counter() - t1
    _check(bool(results) and all(np.isfinite(r["accuracy"]) for r in results.values()),
           f"train_cql_state: evaluate results {results}")
    print(
        f"[train_cql_state] train.main took {wall:.1f} s | val_accuracy {accs}, horizon {horizons}, "
        f"best step {best} | evaluate epoch=best short_horizon in {eval_s:.1f} s: "
        + ", ".join(f"{t} {r['accuracy']:.2f}" for t, r in results.items())
        + f" | jitter_normalize launches {launches} | {card}",
        flush=True,
    )
    return launches


# -- the D4RL branch: state-based Play-LMP and TACO-RL, flat CQL ----------------------------

D4RL_LMP_TARGET = "tacorl_tpu.modules.play_lmp_d4rl.PlayLMPD4RLModule"
# tests/test_torch_d4rl.py's tiny config (float32, no posterior dropout)
D4RL_TINY_LMP = {
    "_target_": D4RL_LMP_TARGET, "lr": 1e-3, "latent_plan_dim": 8, "state_dim": 8, "action_dim": 4,
    "plan_recognition": {"num_heads": 4, "num_layers": 1, "encoder_hidden_size": 32,
                         "fc_hidden_size": 32, "max_position_embeddings": 12, "dropout_p": 0.0},
    "plan_proposal": {"policy": {"num_layers": 2, "hidden_dim": 32}},
    "action_decoder": {"hidden_size": 32, "num_layers": 1, "n_mixtures": 4},
}
D4RL_TINY_TACORL = {
    "_target_": "tacorl_tpu.modules.tacorl_d4rl.TACORLD4RLModule", "finetune_action_decoder": True,
    "with_lagrange": True, "n_action_samples": 3, "q_network": {"num_layers": 2, "hidden_dim": 16},
}
# antmaze-large's shapes (experiment=play_lmp_d4rl / cql_d4rl): 29-wide
# states, 8-wide actions; 32 episodes of 100 steps
D4RL_OBS, D4RL_ACT, D4RL_STEPS = 29, 8, 3200
D4RL_BATCHES = 12  # an epoch of each experiment: 12 batches
D4RL_ROLLOUTS, D4RL_PLAN_DURATION = 10, 15


def phase_reference_d4rl() -> None:
    """One train step and one val step of each D4RL stage at the tiny
    float32 config on the card and on the CPU, from the same weights, batch
    and draws (one CPU generator): every metric within rtol 1e-4."""
    from tacorl_tpu_torch.data.d4rl_dataset import D4RLPlayDataset, generate_synthetic_d4rl
    from tacorl_tpu_torch.data.loader import DataLoader
    from tacorl_tpu_torch.modules.play_lmp_d4rl import PlayLMPD4RLModule
    from tacorl_tpu_torch.modules.tacorl_d4rl import TACORLD4RLModule

    b, latent, n = 4, D4RL_TINY_LMP["latent_plan_dim"], D4RL_TINY_TACORL["n_action_samples"]
    g = torch.Generator().manual_seed(4)

    def eps(*shape):
        return {"eps": torch.randn(shape, generator=g)}

    def uniform_plan():
        return torch.rand((b, latent), generator=g) * 2.0 - 1.0

    lmp_train = {"eps": torch.randn((b, latent), generator=g), "random_plan": uniform_plan()}
    lmp_val = {"eps": torch.randn((b, latent), generator=g), "random_plan": uniform_plan(),
               "pp_eps": torch.randn((b, latent), generator=g)}
    rl_draws = {
        "plan_eps": torch.randn((b, latent), generator=g), "curr": eps(b, latent),
        "next_bellman": eps(b, latent), "curr_n": eps(n, b, latent), "next_n": eps(n, b, latent),
        "rand": torch.rand((b * n, latent), generator=g) * 2.0 - 1.0,
    }
    results = {}
    with tempfile.TemporaryDirectory() as tmp:
        npz = generate_synthetic_d4rl(f"{tmp}/d.npz", n_steps=400, obs_dim=8, act_dim=4)
        windows = D4RLPlayDataset(dataset_path=npz, min_window_size=8, max_window_size=12, include_goal=True)
        batch = next(iter(DataLoader(windows, batch_size=b, seed=0, prefetch=0)))
        lmp = PlayLMPD4RLModule(D4RL_TINY_LMP, device="cpu")
        CheckpointManager(f"{tmp}/lmp", config={"module": D4RL_TINY_LMP}).save(0, lmp.init_state(0))
        weights = {}
        for device in ("cpu", "cuda"):
            out = {}
            for stage, module in (
                ("lmp", PlayLMPD4RLModule(D4RL_TINY_LMP, device=device)),
                ("tacorl", TACORLD4RLModule({**D4RL_TINY_TACORL, "play_lmp_dir": f"{tmp}/lmp"}, device=device)),
            ):
                state = module.init_state(0)
                weights.setdefault(stage, {k: v.clone() for k, v in module.net.state_dict().items()})
                module.net.load_state_dict(weights[stage])
                if stage == "lmp":
                    val, _ = module.make_val_step()(state, batch, {"kl_beta": 1e-2}, **_to_device(lmp_val, device))
                    _, train = module.make_train_step()(state, batch, {"kl_beta": 1e-2},
                                                        **_to_device(lmp_train, device))
                else:
                    on_device = _to_device(rl_draws, device)
                    val, _ = module.make_val_step()(state, batch, {"bc_phase": 0.0}, draws=on_device)
                    _, train = module.make_train_step()(state, batch, {"bc_phase": 0.0}, draws=on_device)
                out.update({f"{stage}/train/{k}": float(v) for k, v in train.items()})
                out.update({f"{stage}/val/{k}": float(v) for k, v in val.items()})
            results[device] = out
    _check(set(results["cuda"]) == set(results["cpu"]), "reference_d4rl: metric keys")
    worst = 0.0
    for key, c in results["cpu"].items():
        a = results["cuda"][key]
        _check(np.isfinite(a) and abs(a - c) <= 1e-4 * abs(c) + 1e-6, f"reference_d4rl {key}: cuda {a} vs cpu {c}")
        worst = max(worst, abs(a - c) / max(abs(c), 1e-6))
    print(
        f"[reference_d4rl] tiny float32 Play-LMP D4RL and TACO-RL D4RL train + val steps, cuda vs cpu, "
        f"same weights, batch and draws: {len(results['cpu'])} metrics, lmp total_loss "
        f"{results['cuda']['lmp/train/total_loss']:.6f} vs {results['cpu']['lmp/train/total_loss']:.6f}, "
        f"random_plan_action_loss {results['cuda']['lmp/train/random_plan_action_loss']:.6f} vs "
        f"{results['cpu']['lmp/train/random_plan_action_loss']:.6f}, tacorl q1_loss "
        f"{results['cuda']['tacorl/train/q1_loss']:.6f} vs {results['cpu']['tacorl/train/q1_loss']:.6f}; "
        f"largest relative difference {worst:.3g} (rtol 1e-4)",
        flush=True,
    )


def _d4rl_train_data(root) -> tuple:
    """A synthetic .npz of antmaze-large's shapes; returns its path and the
    train_percentage of the play windows and of the transitions that make
    an epoch D4RL_BATCHES batches of 64 and of 256."""
    from tacorl_tpu_torch.data.d4rl_dataset import (
        D4RLPlayDataset,
        D4RLTransitionDataset,
        generate_synthetic_d4rl,
    )

    npz = generate_synthetic_d4rl(f"{root}/antmaze_shapes.npz", n_steps=D4RL_STEPS, episode_len=100,
                                  obs_dim=D4RL_OBS, act_dim=D4RL_ACT, seed=0)
    windows = len(D4RLPlayDataset(dataset_path=npz, min_window_size=8, max_window_size=16))
    transitions = len(D4RLTransitionDataset(dataset_path=npz))
    pct = {"play": (D4RL_BATCHES * 64 + 0.5) / windows, "transition": (D4RL_BATCHES * 256 + 0.5) / transitions}
    _check(all(p <= 1.0 for p in pct.values()), f"d4rl train data: {windows} windows, {transitions} transitions")
    return str(npz), pct


def _report_d4rl(tag: str, card: str, trainer, probe) -> float:
    """Checks and prints what the probe measured in a D4RL train phase (no
    val split: no val pass to count)."""
    _check(trainer.device.type == "cuda", f"{tag}: trained on {trainer.device}")
    _check(probe.epoch_steps == [D4RL_BATCHES, D4RL_BATCHES], f"{tag}: epochs {probe.epoch_steps}")
    _check(all(n == 0 for n in probe.step_launches), f"{tag}: jitter_normalize launched {probe.step_launches}")
    rows = [r for r in _metrics_rows(trainer.ckpt.dir) if any(k.startswith("train/") for k in r)]
    _check(bool(rows) and all(np.isfinite(v) for r in rows for k, v in r.items() if k.startswith("train/")),
           f"{tag}: non-finite or missing train metrics")
    ms = probe.ms_per_step()
    epoch1 = trainer.batch_wait_ms[-probe.epoch_steps[-1]:]
    waits = {step: sum(probe.syncs[step].values()) for step in (TIMED_TO + 1, TIMED_TO + 2)}
    print(
        f"[{tag}] {probe.steps_seen} steps in 2 epochs of {D4RL_BATCHES}: {ms:.3f} ms/step "
        f"({1e3 / ms:.2f} steps/s) over steps {TIMED_FROM + 1}-{TIMED_TO} of the second epoch | "
        f"profile of steps {PROFILE_FROM + 1}-{PROFILE_FROM + PROFILE_STEPS}: {probe.wall_ms:.3f} ms/step "
        f"under the profiler, device kernels {probe.device_ms:.3f} ms/step, busy "
        f"{probe.device_ms / probe.wall_ms:.1%}; {probe.kernels:.0f} kernels and {probe.copies:.1f} copies "
        f"per step | host waits a non-logging / logging step {waits[TIMED_TO + 1]} / {waits[TIMED_TO + 2]}, "
        f"at: {_sites(probe.syncs[TIMED_TO + 2])} | loader wait per step (second epoch) median "
        f"{statistics.median(epoch1):.3f} ms, max {max(epoch1):.3f} ms | {train_loss_line(rows)} | "
        f"jitter_normalize launches {sum(probe.step_launches)} | {card}",
        flush=True,
    )
    return ms


def phase_train_d4rl(card: str, root: str) -> tuple:
    """experiment=play_lmp_d4rl, then experiment=tacorl_d4rl grafted from
    that run, then experiment=cql_d4rl, at their composed widths through
    train.main on the antmaze-shaped .npz: 2 epochs of 12 steps each.
    Returns the jitter kernel's launches and the two hierarchical run
    directories."""
    from tacorl_tpu_torch import train

    npz, pct = _d4rl_train_data(root)
    runs = {
        "play_lmp_d4rl": [f"datamodule.train_percentage={pct['play']}"],
        "tacorl_d4rl": [f"datamodule.train_percentage={pct['play']}", f"play_lmp_dir={root}/play_lmp_d4rl"],
        "cql_d4rl": [f"datamodule.train_percentage={pct['transition']}"],
    }
    jitter_normalize.launches = 0
    shift_jitter_normalize.launches = 0
    lines = []
    for experiment, extra in runs.items():
        probe = _TrainProbe()
        args = [f"experiment={experiment}", f"dataset_path={npz}", f"run_dir={root}/{experiment}",
                f"trainer.max_steps={TRAIN_STEPS}", f"trainer.log_every_n_steps={TRAIN_LOG_EVERY}", *extra]
        t0 = time.perf_counter()
        trainer = train.main(args, callbacks=[probe])
        wall = time.perf_counter() - t0
        _remember(experiment, args, trainer, probe)
        module = probe.module
        after = trainer.state.net.state_dict()

        def changed(part):
            keys = [k for k in probe.before if k.split(".")[0] == part]
            return bool(keys) and any(not torch.equal(probe.before[k], after[k]) for k in keys)

        if experiment == "play_lmp_d4rl":
            _check(module.net.plan_recognition.d_model == 32, "play_lmp_d4rl: d_model not padded to 32")
            _check(all(changed(p) for p in ("plan_recognition", "plan_proposal", "action_decoder")),
                   "play_lmp_d4rl: a part did not change")
        elif experiment == "tacorl_d4rl":
            pr = [k for k in probe.before if k.startswith("plan_recognition.")]
            _check(bool(pr) and all(torch.equal(probe.before[k], after[k]) for k in pr),
                   "tacorl_d4rl: the frozen posterior changed")
            _check(all(changed(p) for p in TRAINED), "tacorl_d4rl: actor, critics or decoder did not change")
        else:
            _check(all(changed(p) for p in ("actor", "q1", "q2")), "cql_d4rl: actor or critics did not change")
        ms = _report_d4rl(f"train_d4rl/{experiment}", card, trainer, probe)
        lines.append(f"{experiment} {ms:.3f} ms/step, train.main {wall:.1f} s")
        del trainer, probe
        torch.cuda.empty_cache()
    launches = {"jitter_normalize": jitter_normalize.launches, "shift_jitter_normalize": shift_jitter_normalize.launches}
    _check(launches["jitter_normalize"] == 0 and launches["shift_jitter_normalize"] == 0,
           f"train_d4rl: kernel launches {launches}")
    print(f"[train_d4rl] {'; '.join(lines)} | posterior d_model 29 -> 32 at 8 heads, frozen and bit-unchanged "
          f"in stage 2; actor, critics and decoder changed | kernel launches {launches} | {card}", flush=True)
    return launches, (f"{root}/play_lmp_d4rl", f"{root}/tacorl_d4rl")


def phase_rollout_d4rl(card: str, run_dirs) -> dict:
    """Both hierarchical D4RL agents at full width (train_d4rl's runs,
    loaded back through load_module_from_checkpoint) on
    FakeD4RLEnv(obs_dim=29, act_dim=8, 60 steps), plan_duration 15:
    episodes, ms per decode step (agent + env.step), ms per replan, env
    steps/s, kernels per decode step and per replan."""
    from torch.profiler import ProfilerActivity, profile

    from tacorl_tpu_torch.envs.fake_d4rl import FakeD4RLEnv
    from tacorl_tpu_torch.evaluation.agents import make_d4rl_agent

    jitter_normalize.launches = 0
    shift_jitter_normalize.launches = 0
    lines = []
    for run_dir in run_dirs:
        module, state = load_module_from_checkpoint(run_dir, device="cuda")
        agent, manager = make_d4rl_agent(module, state, D4RL_PLAN_DURATION)
        log = _ActionLog(agent)
        env = _TimedEnv(FakeD4RLEnv(obs_dim=D4RL_OBS, act_dim=D4RL_ACT, max_episode_steps=ROLLOUT_STEPS), log)
        t0 = time.perf_counter()
        outs = [manager.episode_rollout(log, env) for _ in range(D4RL_ROLLOUTS)]
        wall = time.perf_counter() - t0
        steps = len(env.step_ms)
        acts = np.stack(log.actions)
        _check(steps == sum(o["episode_length"] for o in outs) and acts.shape == (steps, D4RL_ACT)
               and bool(np.isfinite(acts).all()), f"rollout_d4rl {module.name}: actions {acts.shape}")
        _check(all(np.isfinite(o["score"]) for o in outs), f"rollout_d4rl {module.name}: scores")
        obs, goal = env.env.reset(), env.env.target_goal
        g = torch.Generator(device="cuda").manual_seed(3)
        replan_ms = []
        for _ in range(REPLANS):
            t1 = time.perf_counter()
            plan = agent.propose_plan_d4rl(obs, goal, None, g)
            torch.cuda.synchronize()
            replan_ms.append((time.perf_counter() - t1) * 1e3)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(PROFILE_DECODE_STEPS):
                obs = env.env.step(agent.decode_step({"observation": obs}, plan, None, g))[0]
            torch.cuda.synchronize()
        per_decode, copies, device_ms = _kernel_counts(prof.key_averages(), PROFILE_DECODE_STEPS)
        step_ms = statistics.median(env.step_ms)
        lines.append(
            f"{type(agent).__name__} + {type(manager).__name__}: {len(outs)} episodes, {steps} env steps in "
            f"{wall:.3f} s ({steps / wall:.1f} env steps/s), successes {sum(o['success'] for o in outs)}, "
            f"decode step (agent + env.step) median {step_ms:.3f} ms, replan (propose + sync) median "
            f"{statistics.median(replan_ms[2:]):.3f} ms, {per_decode:.1f} kernels and {copies:.1f} copies per "
            f"decode step, device {device_ms:.3f} ms per decode step (busy {device_ms / step_ms:.1%})"
        )
        del module, state, agent
        torch.cuda.empty_cache()
    launches = {"jitter_normalize": jitter_normalize.launches, "shift_jitter_normalize": shift_jitter_normalize.launches}
    _check(launches["jitter_normalize"] == 0 and launches["shift_jitter_normalize"] == 0,
           f"rollout_d4rl: kernel launches {launches}")
    print(f"[rollout_d4rl] FakeD4RLEnv({D4RL_OBS}, {D4RL_ACT}), {ROLLOUT_STEPS} steps, plan_duration "
          f"{D4RL_PLAN_DURATION}: " + " | ".join(lines) + f" | kernel launches {launches} | {card}", flush=True)
    return launches


# -- Relay Imitation Learning and CEM planning ----------------------------------------------

# tests/test_torch_ril.py's visual config (float32) with a discrete-gripper
# low level
RIL_TINY = {
    "_target_": "tacorl_tpu.modules.ril.RILModule", "lr": 1e-3, "action_dim": 7,
    "high_level_policy_modalities": ["rgb_static"], "low_level_policy_modalities": ["rgb_static"],
    "perceptual_encoder": {"networks": {"rgb_static": {
        "_target_": "tacorl_tpu.networks.encoders.LMPVisionEncoder", "latent_dim": 8, "hidden_dim": 16,
        "compute_dtype": None}}},
    "goal_encoder": {"out_features": 8, "hidden_size": 16, "last_layer_activation": "Tanh"},
    "high_level_policy": {"num_layers": 2, "hidden_dim": 16},
    "low_level_policy": {"num_layers": 2, "hidden_dim": 16, "discrete_gripper": True},
    "transforms": {"rgb_static": {"kind": "rgb", "size": [48, 48], "pad": 2}},
}
RIL_LAUNCHES_PER_STEP = 4  # rgb_static of each of the four leaves
# the CEM of configs/evaluate.yaml's use_cem (modules/cem.py's defaults)
CEM_ITERS, CEM_POP = 3, 64
RIL_PLAN_DURATION, RIL_LOOKAHEAD = 8, 8  # experiment=ril_fake_state, BASELINE.md's oracle run
VECTOR_ENV_KW = dict(image_hw=64, max_episode_steps=56, task_set="hard",
                     modalities=["robot_obs", "scene_obs"], goal_modalities=["robot_obs", "scene_obs"])


class _CemDraws:
    """A rollout manager's draw source from one CPU generator: the CEM's
    normals for a flat step or a replan (``width`` wide), and a decode
    step's mixture uniforms."""

    def __init__(self, width: int, a: int = 6, k: int = 4, seed: int = 0):
        self.mixture = _CpuDraws(1, a, k, seed)
        self.g, self.width = self.mixture.g, width

    def __call__(self, call):
        if call == "decode":
            return self.mixture("decode")
        return {"cem_eps": torch.randn((CEM_ITERS, CEM_POP, 1, self.width), generator=self.g)}


def _ril_batch(b: int, hw: int, seed: int) -> dict:
    rs = np.random.RandomState(seed)
    batch = {k: {"rgb_static": rs.randint(0, 256, (b, hw, hw, 3), dtype=np.uint8)} for k in LEAVES}
    actions = np.clip(rs.randn(b, 7), -1, 1).astype(np.float32)
    actions[:, -1] = np.where(actions[:, -1] >= 0, 1.0, -1.0)
    batch["low_level_action"] = actions
    return batch


def _episodes(agent, manager, env, resets) -> tuple:
    """Episodes of one agent: outcomes and stacked actions."""
    log = _ActionLog(agent)
    outs = [manager.episode_rollout(log, env, r) for r in resets]
    return outs, np.stack(log.actions)


def phase_reference_ril() -> None:
    """At tiny float32 configs, card against CPU from the same weights,
    batch and draws: one RIL train and validation step (every metric within
    rtol 1e-4); ``cem_optimize`` with and without a discrete gripper; RILAgent
    and OracleSubgoalAgent episodes through RILRollout; and the CEM-refined
    FlatPolicyAgent (cql_fake_state's widths) and TACORLAgent episodes
    (actions within 1e-4, grippers and outcomes equal)."""
    from tacorl_tpu_torch.evaluation.agents import OracleSubgoalAgent
    from tacorl_tpu_torch.evaluation.rollout_manager import RILRollout
    from tacorl_tpu_torch.modules.cem import cem_optimize

    b, g = 4, torch.Generator().manual_seed(5)
    batch = _ril_batch(b, 64, seed=5)
    draws = {leaf: {"rgb_static": {"shifts": torch.randint(0, 5, (b, 2), generator=g),
                                   "factors": sample_jitter_factors(b, g)}} for leaf in LEAVES}
    metrics, modules = {}, {}
    for device in ("cpu", "cuda"):
        module = RILModule(RIL_TINY, device=device)
        state = module.init_state(0)
        if modules:
            module.net.load_state_dict(modules["cpu"][0].net.state_dict())
        modules[device] = (module, state)
        val, _ = module.make_val_step()(state, batch)
        saved = {k: v.clone() for k, v in module.net.state_dict().items()}
        _, train = module.make_train_step()(state, batch, draws=_to_device(draws, device))
        module.net.load_state_dict(saved)  # the agents below act with the initial weights
        metrics[device] = {**{f"train/{k}": float(v) for k, v in train.items()},
                           **{f"val/{k}": float(v) for k, v in val.items()}}
    worst = 0.0
    for key, c in metrics["cpu"].items():
        a = metrics["cuda"][key]
        _check(np.isfinite(a) and abs(a - c) <= 1e-4 * abs(c) + 1e-6, f"reference_ril {key}: cuda {a} vs cpu {c}")
        worst = max(worst, abs(a - c) / max(abs(c), 1e-6))

    # cem_optimize on a fixed random critic over a tiled state embedding
    cem_err = {}
    for gripper in (False, True):
        emb, init = torch.randn(3, 5, generator=g), torch.rand(3, 7, generator=g) * 2 - 1
        w1, w2 = torch.randn(12, 32, generator=g), torch.randn(32, 1, generator=g)
        eps = torch.randn(CEM_ITERS, CEM_POP, 3, 7, generator=g)
        out = {}
        for device in ("cpu", "cuda"):
            e, a1, a2 = emb.to(device), w1.to(device), w2.to(device)

            def q(x):
                return torch.tanh(torch.cat([e.repeat(x.shape[0] // 3, 1), x], -1) @ a1) @ a2

            out[device] = cem_optimize(q, init.to(device), CEM_ITERS, CEM_POP, 8, 0.3, gripper,
                                       eps=eps.to(device)).cpu()
        cem_err[gripper] = float((out["cuda"] - out["cpu"]).abs().max())
        _check(cem_err[gripper] <= ACTION_ATOL, f"reference_ril: cem_optimize (gripper {gripper}) {cem_err}")

    resets = ({"task_info": {"task": "open_drawer", "index": 0}},
              {"task_info": {"task": "lift_block", "index": 2}})
    env_kw = dict(image_hw=64, max_episode_steps=20, task_set="hard", seed=0)
    runs = {}
    for device in ("cpu", "cuda"):
        module, state = modules[device]
        runs[("ril", device)] = _episodes(
            make_agent(module, state)[0], RILRollout(plan_duration=4), FakeCalvinEnv(**env_kw), resets)
        # the oracle rolls the expert ahead on a copy of the env it scores on
        env = FakeCalvinEnv(**env_kw)
        runs[("oracle", device)] = _episodes(
            OracleSubgoalAgent(module, state, env, lookahead=4), RILRollout(plan_duration=4), env, resets)
    with tempfile.TemporaryDirectory() as tmp:
        _save_lmp(_tiny_cfg(), tmp, "cpu")
        flat_cfg = _flat_module_cfg(FLAT_CASES["cql_fake_state"])
        weights = {}
        for device in ("cpu", "cuda"):
            for name, module in (("cql_cem", CQLModule(flat_cfg, device=device)),
                                 ("tacorl_cem", TACORLModule(_tiny_tacorl_cfg(tmp), device=device))):
                state = module.init_state(0)
                weights.setdefault(name, {k: v.clone() for k, v in module.net.state_dict().items()})
                module.net.load_state_dict(weights[name])
                agent, manager_cls = make_agent(module, state, use_cem=True)
                draws = _CemDraws(module.action_dim)
                if name == "cql_cem":
                    manager = manager_cls(draw_source=draws)
                    env = FakeCalvinEnv(**dict(VECTOR_ENV_KW, max_episode_steps=20))
                else:
                    manager, env = manager_cls(plan_duration=5, draw_source=draws), FakeCalvinEnv(**env_kw)
                runs[(name, device)] = _episodes(agent, manager, env, resets)
    errs = {}
    for name in ("ril", "oracle", "cql_cem", "tacorl_cem"):
        (outs_cpu, acts_cpu), (outs_card, acts_card) = runs[(name, "cpu")], runs[(name, "cuda")]
        _check(acts_card.shape == acts_cpu.shape, f"reference_ril {name}: {acts_card.shape} vs {acts_cpu.shape}")
        errs[name] = float(np.abs(acts_card[:, :-1] - acts_cpu[:, :-1]).max())
        _check(errs[name] <= ACTION_ATOL, f"reference_ril {name}: max action error {errs[name]}")
        _check(np.array_equal(acts_card[:, -1], acts_cpu[:, -1]), f"reference_ril {name}: grippers differ")
        _check([(o["episode_length"], o["success"]) for o in outs_card]
               == [(o["episode_length"], o["success"]) for o in outs_cpu], f"reference_ril {name}: outcomes")
    print(
        f"[reference_ril] tiny float32 RIL train + val step, cuda vs cpu, same weights, batch and per-leaf "
        f"draws: {len(metrics['cpu'])} metrics, total_loss {metrics['cuda']['train/total_loss']:.6f} vs "
        f"{metrics['cpu']['train/total_loss']:.6f}, largest relative difference {worst:.3g} (rtol 1e-4) | "
        f"cem_optimize ({CEM_ITERS} x {CEM_POP}) max abs err {cem_err[False]:.3g}, with a gripper "
        f"{cem_err[True]:.3g} | episodes, max action error (atol {ACTION_ATOL}): "
        + ", ".join(f"{n} {len(runs[(n, 'cpu')][1])} actions {e:.3g}" for n, e in errs.items())
        + "; grippers and outcomes equal",
        flush=True,
    )


def _ril_kernel_check(trainer) -> float:
    """jitter_normalize against its plain version on one of the run's
    batches at the main path's shape: the ``obs`` leaf resized and shifted
    to (64, 3, 128, 128) bf16, factors from the transform's ranges."""
    cfg = compose(CONFIG_DIR, "train", ["experiment=ril"])["transforms"]["rgb_static"]
    batch = next(iter(trainer.datamodule.train_loader()))
    frames = torch.as_tensor(batch["obs"]["rgb_static"]).cuda().movedim(-1, -3).contiguous()
    g = torch.Generator(device="cuda").manual_seed(11)
    n, pad = frames.shape[0], int(cfg["pad"])
    shifts = torch.randint(0, 2 * pad + 1, (n, 2), generator=g, device="cuda")
    x = image_aug.resize_shift(frames, shifts, tuple(cfg["size"]), pad, dtype=torch.bfloat16).contiguous()
    factors = sample_jitter_factors(n, g, brightness=cfg["brightness"], contrast=cfg["contrast"],
                                    hue=cfg["hue"], prob=cfg["jitter_prob"])
    _check(tuple(x.shape) == (64, 3, 128, 128) and x.dtype == torch.bfloat16, f"train_ril: kernel input {x.shape}")
    return _compare(jitter_normalize(x, factors), jitter_normalize_reference(x, factors), 8e-3,
                    "train_ril: jitter_normalize vs plain at (64, 3, 128, 128) bf16")


def phase_train_ril(card: str, train_data: str, flat_data: str, flat_pct: float, root: str) -> dict:
    """experiment=ril at its composed widths through train.main on phase
    16's packed 200x200 set, 2 epochs of 12 steps, with the measurements of
    phase 16 and 4 jitter_normalize launches a step; the kernel against its
    plain version on the run's frames. Then experiment=ril_fake_state at its
    full width on phase 21's set with the rollout monitor, 0 launches, then
    evaluate epoch=best. Returns the launches of each run."""
    from tacorl_tpu_torch import evaluate, train

    n = sum(int(e) - int(s) for s, e in load_ep_start_end_ids(f"{train_data}/training", True))
    pct = (12 * 64 + 8) / n  # 12 batches of 64 an epoch
    launches = {}
    probe = _TrainProbe()
    jitter_normalize.launches = shift_jitter_normalize.launches = 0
    args = _train_args("ril", train_data, f"{root}/ril", TRAIN_STEPS, f"datamodule.train_percentage={pct}")
    t0 = time.perf_counter()
    trainer = train.main(args, callbacks=[probe])
    wall = time.perf_counter() - t0
    _remember("ril", args, trainer, probe)
    launches["ril"] = {"jitter_normalize": jitter_normalize.launches,
                       "shift_jitter_normalize": shift_jitter_normalize.launches}
    _check(type(trainer.callbacks[0]).__name__ == "IncreaseHorizonLinear", "train_ril: callbacks")
    _check(trainer.global_step == TRAIN_STEPS and probe.epoch_steps == [12, 12], f"train_ril: {probe.epoch_steps}")
    _check(launches["ril"] == {"jitter_normalize": RIL_LAUNCHES_PER_STEP * TRAIN_STEPS, "shift_jitter_normalize": 0},
           f"train_ril: launches {launches['ril']}")
    _report_trainer("train_ril", card, trainer, probe, None, RIL_LAUNCHES_PER_STEP)
    err = _ril_kernel_check(trainer)
    rows = _metrics_rows(f"{root}/ril")
    print(
        f"[train_ril] experiment=ril: train.main took {wall:.1f} s (2 epochs, 2 val passes, 2 saves), "
        f"{RIL_LAUNCHES_PER_STEP} image leaves a step, launches {launches['ril']} counted in "
        f"{TRAIN_STEPS} steps | jitter_normalize vs plain on the run's frames at (64, 3, 128, 128) bf16: "
        f"max abs err {err:.3g} (atol 8e-3) | final high_level_loss "
        f"{[r['train/high_level_loss'] for r in rows if 'train/high_level_loss' in r][-1]:.4f} | {card}",
        flush=True,
    )
    del trainer
    torch.cuda.empty_cache()

    probe = _TrainProbe()
    jitter_normalize.launches = shift_jitter_normalize.launches = 0
    t0 = time.perf_counter()
    run_dir = f"{root}/ril_state"
    trainer = train.main(
        _train_args("ril_fake_state", flat_data, run_dir, TRAIN_STEPS, f"datamodule.train_percentage={flat_pct}",
                    *FLAT_ARGS),
        callbacks=[probe],
    )
    wall = time.perf_counter() - t0
    launches["ril_fake_state"] = {"jitter_normalize": jitter_normalize.launches,
                                  "shift_jitter_normalize": shift_jitter_normalize.launches}
    _check(launches["ril_fake_state"] == {"jitter_normalize": 0, "shift_jitter_normalize": 0},
           f"train_ril_state: launches {launches['ril_fake_state']}")
    _check(trainer.state.net.perceptual_encoder.networks.keys() == set(), "train_ril_state: encoders built")
    _report_trainer("train_ril_state", card, trainer, probe, None, 0)
    accs = [r["val_accuracy"] for r in _metrics_rows(run_dir) if "val_accuracy" in r]
    _check(len(accs) == 2, f"train_ril_state: val_accuracy {accs}")
    best = trainer.ckpt.best_step()
    del trainer
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        t1 = time.perf_counter()
        results = evaluate.main([
            f"module_path={run_dir}", "epoch=best", f"data_dir={flat_data}/validation", "env.image_hw=64",
            "env.max_episode_steps=56", "env.task_set=hard", "env.modalities=[robot_obs,scene_obs]",
            "env.goal_modalities=[robot_obs,scene_obs]", "min_seq_len=1", "max_seq_len=64",
            "max_rollouts=2", f"plan_duration={RIL_PLAN_DURATION}", f"filename={tmp}/best.json",
        ])
        eval_s = time.perf_counter() - t1
    _check(bool(results) and all(np.isfinite(r["accuracy"]) for r in results.values()),
           f"train_ril_state: evaluate results {results}")
    print(
        f"[train_ril_state] experiment=ril_fake_state: train.main took {wall:.1f} s | val_accuracy {accs}, "
        f"best step {best} | evaluate epoch=best in {eval_s:.1f} s: "
        + ", ".join(f"{t} {r['accuracy']:.2f}" for t, r in results.items())
        + f" | launches {launches['ril_fake_state']} | {card}",
        flush=True,
    )
    return launches


def _rollout_line(name, make, manager, env_kw, data_dir) -> str:
    """evaluate_all_tasks (ROLLOUTS_PER_TASK a task) with the agent that
    ``make(env)`` builds for the scored env, then its steps and replans
    timed and profiled."""
    from torch.profiler import ProfilerActivity, profile

    gen = SingleTaskRolloutGenerator(data_dir=data_dir, start_end_tasks=f"{data_dir}/start_end_tasks.json",
                                     min_seq_len=1, max_seq_len=64)
    scored = FakeCalvinEnv(**env_kw)
    agent = make(scored)
    log = _ActionLog(agent)
    env = _TimedEnv(scored, log)
    evaluation = EvaluationManager(agent=log, env=env, rollout_manager=manager, single_task_generator=gen)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        results = evaluation.evaluate_all_tasks(f"{tmp}/all_tasks.json", ROLLOUTS_PER_TASK)
        wall = time.perf_counter() - t0
    steps = len(env.step_ms)
    acts = np.stack(log.actions)
    _check(bool(results) and steps == sum(r["avg_episode_length"] * r["num_rollouts"] for r in results.values())
           and acts.shape == (steps, 7) and bool(np.isfinite(acts).all()), f"rollout_ril {name}: {acts.shape}")
    obs = env.env.reset(**gen.get_reset_info(next(iter(results)), 0))
    g = torch.Generator(device="cuda").manual_seed(3)
    flat = not hasattr(agent, "propose_plan")
    plan = None if flat else agent.propose_plan(obs, None, g)

    def step():
        if flat:
            return agent.act(obs, None, g)
        return agent.decode_step(obs, plan, None, g)

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(20):
            step()
        torch.cuda.synchronize()
    per_step, copies, device_ms = _kernel_counts(prof.key_averages(), 20)
    step_ms = statistics.median(env.step_ms)
    line = (f"{name} ({type(agent).__name__} + {type(manager).__name__}): {env.episodes} episodes, {steps} env "
            f"steps in {wall:.3f} s ({steps / wall:.1f} env steps/s), accuracy "
            f"{sum(r['accuracy'] * r['num_rollouts'] for r in results.values()) / env.episodes:.3f}, "
            f"{'step' if flat else 'decode step'} (agent + env.step) median {step_ms:.3f} ms, "
            f"{per_step:.1f} kernels and {copies:.1f} copies a step, device {device_ms:.3f} ms a step "
            f"(busy {device_ms / step_ms:.1%})")
    if not flat:
        replan_ms = []
        for _ in range(REPLANS):
            t1 = time.perf_counter()
            agent.propose_plan(obs, None, g)
            torch.cuda.synchronize()
            replan_ms.append((time.perf_counter() - t1) * 1e3)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                agent.propose_plan(obs, None, g)
            torch.cuda.synchronize()
        per_replan, _, replan_dev = _kernel_counts(prof.key_averages(), 5)
        line += (f", replan (propose + sync) median {statistics.median(replan_ms[2:]):.3f} ms, "
                 f"{per_replan:.1f} kernels and {replan_dev:.3f} device ms a replan")
    return line


def phase_rollout_ril(card: str, flat_data: str, root: str) -> dict:
    """The trained ril_fake_state module (phase 27) with its learned high
    level and with the oracle (lookahead 8) through RILRollout
    (plan_duration 8) on the ril_fake_state env; phase 22's cql_fake_state
    module and phase 18's TACO-RL module without and with CEM (3 x 64, 8
    elites), each through evaluate_all_tasks on the flagship-recipe
    validation set: env steps/s, ms per decode step and replan, kernels a
    step; 0 launches of either kernel."""
    from tacorl_tpu_torch.evaluation.agents import OracleSubgoalAgent
    from tacorl_tpu_torch.evaluation.rollout_manager import RILRollout

    image_kw = dict(image_hw=ROLLOUT_HW, max_episode_steps=ROLLOUT_STEPS, task_set="hard")
    lines = []
    jitter_normalize.launches = shift_jitter_normalize.launches = 0
    ril, ril_state = load_module_from_checkpoint(f"{root}/ril_state", device="cuda")
    for name, make in (("ril", lambda env: make_agent(ril, ril_state)[0]),
                       ("ril_oracle", lambda env: OracleSubgoalAgent(ril, ril_state, env, lookahead=RIL_LOOKAHEAD))):
        lines.append(_rollout_line(name, make, RILRollout(plan_duration=RIL_PLAN_DURATION), VECTOR_ENV_KW,
                                   f"{flat_data}/validation"))
    for run, env_kw in (("cql_state", VECTOR_ENV_KW), ("tacorl", image_kw)):
        module, state = load_module_from_checkpoint(f"{root}/{run}", device="cuda")
        for use_cem in (False, True):
            agent, manager_cls = make_agent(module, state, use_cem=use_cem)
            manager = manager_cls() if manager_cls.__name__ == "RLRollout" else manager_cls(plan_duration=PLAN_DURATION)
            lines.append(_rollout_line(f"{module.name}{'_cem' if use_cem else ''}", lambda env, a=agent: a,
                                       manager, env_kw, f"{flat_data}/validation"))
        del module, state
        torch.cuda.empty_cache()
    launches = {"jitter_normalize": jitter_normalize.launches, "shift_jitter_normalize": shift_jitter_normalize.launches}
    _check(launches == {"jitter_normalize": 0, "shift_jitter_normalize": 0}, f"rollout_ril: launches {launches}")
    for line in lines:
        print(f"[rollout_ril] {line}", flush=True)
    print(f"[rollout_ril] {ROLLOUTS_PER_TASK} rollouts a task; kernel launches {launches} | {card}", flush=True)
    return launches

# -- online SAC and CQL-online -------------------------------------------------------------

ONLINE_EXPERIMENTS = ("sac_online", "cql_online", "sac_online_fake", "cql_online_fake")
ONLINE_VISUAL = ("sac_online", "cql_online")
# jitter_normalize launches on a visual online path: the play step's
# observation and goal at N=1, the update's observation, goal, next
# observation and next goal at N=256
ONLINE_PLAY_LAUNCHES, ONLINE_UPDATE_LAUNCHES = 2, 4
ONLINE_REF_BATCH, ONLINE_REF_STEPS = 8, 4
PLAY_RATE_STEPS = 100


def _online_tiny_cfg(family: str, layout: str) -> dict:
    """tests/test_torch_online_rl.py's tiny float32 layouts."""
    enc = {"networks": {"rgb_static": {"_target_": "tacorl_tpu.networks.encoders.LMPVisionEncoder",
                                       "latent_dim": 8, "hidden_dim": 16, "compute_dtype": None}}}
    fake = "tacorl_tpu.envs.fake_calvin."
    cfg = {"action_dim": 7, "actor_lr": 1e-3, "critic_lr": 1e-3, "actor_encoder": enc, "critic_encoder": enc,
           "goal_encoder": {"hidden_size": 16}, "q_network": {"num_layers": 2, "hidden_dim": 16},
           "policy": {"num_layers": 2, "hidden_dim": 16, "discrete_gripper": True},
           "warm_start_steps": 16, "n_action_samples": 3, "with_lagrange": family == "cql_online"}
    if layout == "visual":
        cfg.update(obs_modalities=["rgb_static"], goal_modalities=["rgb_static"],
                   transforms={"rgb_static": {"kind": "rgb", "size": [48, 48], "pad": 2}},
                   env={"_target_": fake + "FakeCalvinEnv", "image_hw": 48, "max_episode_steps": 5})
    else:
        mods = ["robot_obs", "scene_obs"]
        cfg.update(obs_modalities=mods, goal_modalities=mods, vector_dims={"robot_obs": 15, "scene_obs": 24},
                   transforms={m: {"kind": "vector"} for m in mods},
                   env={"_target_": fake + "FakePlayTableEnv", "task": "open_drawer", "tcp_shaping_weight": 1.0,
                        "modalities": mods, "goal_modalities": mods, "max_episode_steps": 4})
    return cfg


def _online_module(family: str, cfg: dict, device: str):
    from tacorl_tpu_torch.modules.cql_online import CQLOnlineModule
    from tacorl_tpu_torch.modules.sac import SACModule

    return {"sac": SACModule, "cql_online": CQLOnlineModule}[family](cfg, device=device)


def phase_reference_online() -> None:
    """The trainer over OnlineRLDataModule on the card and on the CPU for
    each online family and layout at tiny float32 widths: the same weights
    (init_state from one seed), the same warm-start buffer (numpy's random
    fill) and the same draws (a CPU generator seeded by the step: the update's
    and the play step's), 4 steps over 2 epochs. Every logged metric must
    agree within rtol 1e-4 and every play action within 1e-4, so a batch
    that the pinned buffer loader or the side-stream prefetch delivered
    wrong or late shows here."""
    from tacorl_tpu_torch.core.logging import MetricsSink
    from tacorl_tpu_torch.core.trainer import Trainer
    from tacorl_tpu_torch.data.online_datamodule import OnlineRLDataModule

    lines = []
    with tempfile.TemporaryDirectory() as tmp:
        for family in ("sac", "cql_online"):
            for layout in ("visual", "vector"):
                rows, actions = {}, {}
                for device in ("cpu", "cuda"):
                    module = _online_module(family, _online_tiny_cfg(family, layout), device)

                    def source(split, index, module=module, device=device):
                        g = torch.Generator().manual_seed(index)
                        draws = _flat_draws(module, g, ONLINE_REF_BATCH)
                        draws["play"] = {"action": _actor_draws(module, g, 1), "aug": _aug_draws(module, g, 1)}
                        return {"draws": _to_device(draws, device)}

                    sink = MetricsSink(f"{tmp}/{family}_{layout}/{device}", console_every=0)
                    dm = OnlineRLDataModule(batch_size=ONLINE_REF_BATCH, steps_per_epoch=2, seed=1)
                    Trainer(max_steps=ONLINE_REF_STEPS, log_every_n_steps=1, sink=sink, seed=1, device=device,
                            draw_source=source).fit(module, dm)
                    sink.close()
                    rows[device] = _metrics_rows(f"{tmp}/{family}_{layout}/{device}")
                    actions[device] = np.stack([t.action for t in module.replay_buffer.buffer])
                tag = f"reference_online {family}/{layout}"
                _check([r["step"] for r in rows["cuda"]] == [r["step"] for r in rows["cpu"]], f"{tag}: steps")
                _check(actions["cuda"].shape == actions["cpu"].shape == (16 + ONLINE_REF_STEPS, 7),
                       f"{tag}: buffers {actions['cuda'].shape} vs {actions['cpu'].shape}")
                act_err = float(np.abs(actions["cuda"] - actions["cpu"]).max())
                _check(act_err <= 1e-4, f"{tag}: play actions differ by {act_err}")
                worst, n = 0.0, 0
                for card_row, cpu_row in zip(rows["cuda"], rows["cpu"]):
                    _check(set(card_row) == set(cpu_row), f"{tag}: metric keys")
                    for k, v in cpu_row.items():
                        if k in ("step", "time"):
                            continue
                        n += 1
                        err = abs(card_row[k] - v) / max(abs(v), 1e-6)
                        worst = max(worst, err)
                        _check(np.isfinite(card_row[k]) and err <= 1e-4,
                               f"{tag} {k} at step {cpu_row['step']}: card {card_row[k]} vs cpu {v}")
                conservative = any("train/conservative_q1_gap" in r for r in rows["cpu"])
                _check(conservative == (family == "cql_online"), f"{tag}: conservative metrics {conservative}")
                lines.append(f"{family}/{layout} {n} metrics, largest relative difference {worst:.3g}, "
                             f"play actions {act_err:.3g}")
    print("[reference_online] trainer over the replay-buffer loader, card vs CPU, tiny float32 widths, "
          f"{ONLINE_REF_STEPS} steps in 2 epochs (metrics rtol 1e-4, actions 1e-4): " + "; ".join(lines),
          flush=True)


class _OnlineProbe(_TrainProbe):
    """_TrainProbe, plus each play step's jitter_normalize launches and host
    time (its one wait for the device included: the action waits for the
    update queued before it)."""

    def on_fit_start(self, trainer, module):
        super().on_fit_start(trainer, module)
        self.play_launches, self.play_ms = [], []
        play_step = module.play_step

        def counted(*args, **kwargs):
            before, t0 = jitter_normalize.launches, time.perf_counter()
            out = play_step(*args, **kwargs)
            self.play_ms.append((time.perf_counter() - t0) * 1e3)
            self.play_launches.append(jitter_normalize.launches - before)
            return out

        module.play_step = counted


@contextlib.contextmanager
def _timed_populate():
    """Times SACModule.populate (the warm start) while the block runs."""
    from tacorl_tpu_torch.modules.sac import SACModule

    populate, out = SACModule.populate, {}

    def timed(self, net, steps=None):
        n0, t0 = len(self.replay_buffer), time.perf_counter()
        populate(self, net, steps)
        out.update(s=time.perf_counter() - t0, steps=len(self.replay_buffer) - n0)

    SACModule.populate = timed
    try:
        yield out
    finally:
        SACModule.populate = populate


def _online_kernel_check(module) -> dict:
    """jitter_normalize against its plain version on the run's own frames:
    a replay-buffer batch of 256 observations and the env's current
    observation (N=1), each resized and shifted to 128x128 bf16 with the
    transform's ranges; at N=1 also its device time, the plain version's
    and the bytes bound (at one image the time is the launch, not bytes)."""
    cfg = module.transforms.cfg["rgb_static"]
    batch = module.replay_buffer.sample(256, np.random.default_rng(0))
    g = torch.Generator(device="cuda").manual_seed(13)
    pad, size = int(cfg["pad"]), tuple(cfg["size"])

    def prepared(frames):
        frames = torch.as_tensor(frames).cuda().movedim(-1, -3).contiguous()
        n = frames.shape[0]
        shifts = torch.randint(0, 2 * pad + 1, (n, 2), generator=g, device="cuda")
        x = image_aug.resize_shift(frames, shifts, size, pad, dtype=torch.bfloat16).contiguous()
        # the transform's ranges, its defaults where the config names none
        f = sample_jitter_factors(n, g, brightness=cfg.get("brightness", 0.1), contrast=cfg.get("contrast", 0.1),
                                  hue=cfg.get("hue", 0.02), prob=cfg.get("jitter_prob", 1.0))
        return x, f

    out = {}
    for n, frames in ((256, batch["observations"]["observation"]["rgb_static"]),
                      (1, module._observation["observation"]["rgb_static"][None])):
        x, f = prepared(frames)
        _check(tuple(x.shape) == (n, 3, 128, 128) and x.dtype == torch.bfloat16, f"train_online: kernel input {x.shape}")
        out[n] = _compare(jitter_normalize(x, f), jitter_normalize_reference(x, f), BF16_ATOL,
                          f"train_online: jitter_normalize vs plain at ({n}, 3, 128, 128) bf16")
    out["ms_n1"] = _device_ms(lambda: jitter_normalize(x, f))
    out["plain_ms_n1"] = _time_ms(lambda: jitter_normalize_reference(x, f))
    bound = _kernel_bound_ms(x, f)
    out["bound_ms_n1"], out["bound_by_n1"] = bound[0], bound[1]
    out["geometry_n1"] = jitter_normalize_geometry(1, 128, 128)
    return out


def phase_train_online(card: str, root: str) -> tuple:
    """experiment=sac_online, cql_online (visual, composed widths, the
    1,000-step warm start uncut), sac_online_fake and cql_online_fake
    (vectors, the rollout monitor) through train.main, 2 epochs of 12
    steps each (steps_per_epoch cut from 1,000 and 250): the phase-16
    measurements plus the play step's launches and env steps/s. Returns
    the jitter_normalize launches of each run and the kernel's numbers on
    the visual runs' frames."""
    from tacorl_tpu_torch import train

    launches, kernel, lines = {}, {}, []
    for experiment in ONLINE_EXPERIMENTS:
        visual = experiment in ONLINE_VISUAL
        probe = _OnlineProbe()
        jitter_normalize.launches = shift_jitter_normalize.launches = 0
        args = [f"experiment={experiment}", f"run_dir={root}/{experiment}", f"trainer.max_steps={TRAIN_STEPS}",
                f"trainer.log_every_n_steps={TRAIN_LOG_EVERY}", "datamodule.steps_per_epoch=12"]
        with _timed_populate() as pop:
            t0 = time.perf_counter()
            trainer = train.main(args, callbacks=[probe])
            wall = time.perf_counter() - t0
        _remember(experiment, args, trainer, probe)
        tag = f"train_online/{experiment}"
        launches[experiment] = {"jitter_normalize": jitter_normalize.launches,
                                "shift_jitter_normalize": shift_jitter_normalize.launches}
        module = probe.module
        play, update = ((ONLINE_PLAY_LAUNCHES, ONLINE_UPDATE_LAUNCHES) if visual else (0, 0))
        updates = [s - p for s, p in zip(probe.step_launches, probe.play_launches)]
        _check(trainer.device.type == "cuda" and probe.epoch_steps == [12, 12], f"{tag}: {probe.epoch_steps}")
        _check(len(probe.play_launches) == TRAIN_STEPS and all(n == play for n in probe.play_launches),
               f"{tag}: launches per play step {probe.play_launches}")
        _check(all(n == update for n in updates), f"{tag}: launches per update {updates}")
        _check(launches[experiment] == {"jitter_normalize": (play + update) * TRAIN_STEPS, "shift_jitter_normalize": 0},
               f"{tag}: launches {launches[experiment]}")
        _check(pop.get("steps") == module.warm_start_steps, f"{tag}: warm start {pop}")
        _check(len(module.replay_buffer) == module.warm_start_steps + TRAIN_STEPS, f"{tag}: buffer")
        _check(("log_alpha_prime" in trainer.state.net.state_dict()) == experiment.startswith("cql"),
               f"{tag}: log_alpha_prime")
        after = trainer.state.net.state_dict()
        changed = [p for p in ("actor", "q1", "q2")
                   if any(not torch.equal(probe.before[k], after[k]) for k in probe.before if k.startswith(p + "."))]
        _check(changed == ["actor", "q1", "q2"], f"{tag}: changed {changed}")
        rows = _metrics_rows(trainer.ckpt.dir)
        train_rows = [r for r in rows if any(k.startswith("train/") for k in r)]
        _check(bool(train_rows) and all(np.isfinite(v) for r in train_rows for k, v in r.items()
                                        if k.startswith("train/")), f"{tag}: non-finite or missing train metrics")
        _check(any("train/conservative_q1_gap" in r for r in train_rows) == experiment.startswith("cql"),
               f"{tag}: conservative metrics")
        accs = [r["val_accuracy"] for r in rows if "val_accuracy" in r]
        _check(len(accs) == (0 if visual else 2), f"{tag}: val_accuracy {accs}")
        ms = probe.ms_per_step()
        waits = {step: sum(probe.syncs[step].values()) for step in (TIMED_TO + 1, TIMED_TO + 2)}
        _check(waits[TIMED_TO + 1] == 1, f"{tag}: host waits a non-logging step {probe.syncs[TIMED_TO + 1]}")
        # the play step alone: the net as trained, a sync before the first
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for _ in range(PLAY_RATE_STEPS):
            module.play_step(trainer.state.net, "stochastic")
        play_rate = PLAY_RATE_STEPS / (time.perf_counter() - t1)
        epoch1 = trainer.batch_wait_ms[-12:]
        print(
            f"[{tag}] {probe.steps_seen} steps in 2 epochs of 12: {ms:.3f} ms/step ({1e3 / ms:.2f} steps/s) over "
            f"steps {TIMED_FROM + 1}-{TIMED_TO} of the second epoch | profile of steps {PROFILE_FROM + 1}-"
            f"{PROFILE_FROM + PROFILE_STEPS}: {probe.wall_ms:.3f} ms/step under the profiler, device kernels "
            f"{probe.device_ms:.3f} ms/step, busy {probe.device_ms / probe.wall_ms:.1%}; {probe.kernels:.0f} kernels "
            f"and {probe.copies:.1f} copies per step | host waits a non-logging / logging step "
            f"{waits[TIMED_TO + 1]} / {waits[TIMED_TO + 2]}, at: {_sites(probe.syncs[TIMED_TO + 1])} / "
            f"{_sites(probe.syncs[TIMED_TO + 2])} | batch wait "
            f"(sampling on the training thread) median {statistics.median(epoch1):.3f} ms, max {max(epoch1):.3f} ms | "
            f"{train_loss_line(train_rows)} | {card}",
            flush=True,
        )
        print(
            f"[{tag}] warm start {pop['steps']} env steps in {pop['s']:.2f} s ({pop['steps'] / pop['s']:.1f} env "
            f"steps/s); play step in the loop median {statistics.median(probe.play_ms):.3f} ms (its wait includes "
            f"the update queued before it), alone {play_rate:.1f} env steps/s over {PLAY_RATE_STEPS} | "
            f"jitter_normalize launches per play step {sorted(set(probe.play_launches))}, per update "
            f"{sorted(set(updates))}, {launches[experiment]['jitter_normalize']} in {TRAIN_STEPS} steps | "
            f"val_accuracy {accs} | train.main {wall:.1f} s | {card}",
            flush=True,
        )
        if visual:
            kernel[experiment] = _online_kernel_check(module)
            k = kernel[experiment]
            print(
                f"[{tag}] jitter_normalize vs plain on the run's frames, bf16: N=256 max abs err {k[256]:.3g}, "
                f"N=1 {k[1]:.3g} (atol {BF16_ATOL}) | N=1: {k['ms_n1']:.4f} ms (launch-bound), bytes bound "
                f"{k['bound_ms_n1']:.6f} ms ({k['bound_by_n1']}), plain {k['plain_ms_n1']:.4f} ms, geometry "
                f"{k['geometry_n1']} | {card}",
                flush=True,
            )
        lines.append(f"{experiment} {ms:.3f} ms/step, {play_rate:.1f} play env steps/s")
        del trainer, probe, module
        torch.cuda.empty_cache()
    print(f"[train_online] {'; '.join(lines)} | {card}", flush=True)
    return launches, kernel


# -- phase train_scan: K-step dispatch as CUDA-graph replays ----------------------------

SCAN_K = 4  # 12 batches an epoch: 3 chunks
SCAN_LOG_EVERY = 8  # chunks ending at 8 and 24 log, 12 and 20 do not
SCAN_WAITS = (4, 8, 12)  # sync debug over chunk 5-8 (logs) and 9-12 (does not), epoch 1
SCAN_TIMED = (16, 24)  # steps 17-24 of epoch 2, a sync at both ends, nothing else on
SCAN_TRACED = (4, 12)  # the run's replays of steps 5-12 (chunks 2 and 3) under torch.profiler
SCAN_REPLAYS = 4  # replays of the captured step after the run, timed with CUDA events
SCAN_DROP_K = 5  # 12 batches an epoch: 2 chunks of 5 and a dropped chunk of 2
SCAN_OTHERS = ("ril", "play_lmp_d4rl", "tacorl_d4rl")


class _Capturable(Callback):
    """Puts the optimizer in the mode the step graph runs it in
    (``capturable=True``: bias corrections on the device), so an eager
    reference computes the graphed run's Adam arithmetic."""

    def on_fit_start(self, trainer, module):
        from tacorl_tpu_torch.core.optimizers import set_capturable

        set_capturable(trainer.state.optimizer, True)


class _ScanProbe(Callback):
    """Measures a run at the steps its callbacks see (chunk ends): the host
    clock over SCAN_TIMED, host waits under torch's sync debug mode over
    the chunks between SCAN_WAITS, kl_beta at each epoch start, the net's
    weights at ``snapshot_at`` and, with ``trace``, the device trace of the
    steps in SCAN_TRACED (torch.profiler, started before the first wait
    window opens and stopped after the last one closes) with the wrapper's
    own launch count over the same steps."""

    def __init__(self, snapshot_at=(), trace=False, timed=None):
        self.snapshot_at = set(snapshot_at)
        self.chunks, self.times, self.syncs, self.snapshots, self.kl_betas = [], {}, {}, {}, []
        self.warn = self.prof = None
        self.trace = trace
        self.timed = SCAN_TIMED if timed is None else tuple(timed)

    def on_epoch_start(self, trainer, module, epoch):
        self.module = module
        self.kl_betas.append(module.step_scalars().get("kl_beta"))

    def on_train_batch_end(self, trainer, module, metrics, step):
        import warnings

        self.chunks.append(step)
        if step in self.snapshot_at:
            self.snapshots[step] = {k: v.detach().cpu().clone() for k, v in trainer.state.net.state_dict().items()}
        if step in self.timed:
            torch.cuda.synchronize()
            self.times[step] = time.perf_counter()
        if step in SCAN_WAITS[1:]:
            torch.cuda.set_sync_debug_mode("default")
            self.warn.__exit__(None, None, None)
            sites = [f"{w.filename.rsplit('/', 1)[-1]}:{w.lineno}" for w in self._caught
                     if SYNC_WARNING in str(w.message)]
            self.syncs[step] = {site: sites.count(site) for site in dict.fromkeys(sites)}
        if self.trace and step == SCAN_TRACED[1]:
            self.prof.__exit__(None, None, None)
            self.eager_launches = jitter_normalize.launches - self.eager_launches
            self.eager_collectives = all_reduce_mean.calls - self.eager_collectives
        if self.trace and step == SCAN_TRACED[0]:
            from torch.profiler import ProfilerActivity, profile

            torch.cuda.synchronize()
            self.eager_launches = jitter_normalize.launches
            self.eager_collectives = all_reduce_mean.calls
            self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            self.prof.__enter__()
        if step in SCAN_WAITS[:-1]:
            self.warn = warnings.catch_warnings(record=True)
            self._caught = self.warn.__enter__()
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")

    def ms_per_step(self) -> float:
        a, b = self.timed
        return (self.times[b] - self.times[a]) * 1e3 / (b - a)


class _Lines(logging.Handler):
    def __init__(self):
        super().__init__(logging.INFO)
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


@contextlib.contextmanager
def _logged():
    """The port's INFO log lines while the block runs."""
    handler, log = _Lines(), logging.getLogger("tacorl_tpu_torch")
    level = log.level
    log.addHandler(handler)
    log.setLevel(logging.INFO)
    try:
        yield handler.lines
    finally:
        log.removeHandler(handler)
        log.setLevel(level)


def _rerun_args(ref: dict, run_dir: str, k: int, *extra) -> list:
    """A train phase's arguments in another run directory at K = k."""
    return [a for a in ref["args"] if not a.startswith("run_dir=")] + [
        f"run_dir={run_dir}", f"trainer.steps_per_call={k}", *extra]


def _hold_rows(tag: str, got_dir: str, want_dir: str, upto: float = math.inf, rtol: float = 1e-4) -> tuple:
    """Every train and validation row of the graphed run up to step
    ``upto`` against the eager run's row of the same step and keys; returns
    (rows held, largest relative difference)."""
    def kind(row):
        return tuple(sorted(k for k in row if k not in ("step", "time")))

    want = {(r["step"], kind(r)): r for r in _metrics_rows(want_dir)}
    held, worst = 0, 0.0
    for row in _metrics_rows(got_dir):
        if row["step"] > upto or not any(k.startswith(("train/", "validation/")) for k in row):
            continue
        ref = want.get((row["step"], kind(row)))
        _check(ref is not None, f"{tag}: the eager run logged no row like step {row['step']}'s")
        for k in kind(row):
            err = abs(row[k] - ref[k]) / max(abs(ref[k]), 1e-6)
            worst = max(worst, err)
            _check(err <= rtol, f"{tag} {k} at step {row['step']}: graphed {row[k]} vs eager {ref[k]}")
        held += 1
    _check(held > 0, f"{tag}: no row to hold")
    return held, worst


def _hold_params(tag: str, got: dict, want: dict, lr: float, steps: int) -> float:
    """Parameters against the eager run's at the same step, atol 2.5 lr a
    step; returns the largest difference."""
    worst = 0.0
    for k, w in want.items():
        d = float((got[k].float().cpu() - w.float().cpu()).abs().max()) if w.numel() else 0.0
        worst = max(worst, d)
        _check(d <= 2.5 * lr * steps, f"{tag}: {k} differs by {d} (atol {2.5 * lr * steps})")
    return worst


def _params(trainer) -> dict:
    return {k: v.detach().cpu().clone() for k, v in trainer.state.net.state_dict().items()}


def _max_lr(module_cfg: dict) -> float:
    return max(float(v) for k, v in module_cfg.items() if k == "lr" or k.endswith("_lr"))


def _scan_pair(tag: str, args: list, run_dir: str, k: int, *extra, probe=None) -> dict:
    """An eager run (K = 1, the optimizer as the graph runs it) and a graphed
    run (K = k) of the same arguments, seed and batches: every row within
    rtol 1e-4, the final parameters within atol 2.5 lr a step. Returns the
    graphed trainer, its probe and both runs' numbers."""
    from tacorl_tpu_torch import train

    ref = {"args": args}
    eager_probe = _ScanProbe() if probe is not None else None
    torch.cuda.reset_peak_memory_stats()
    eager = train.main(_rerun_args(ref, f"{run_dir}_eager", 1, *extra),
                       callbacks=[_Capturable()] + ([eager_probe] if eager_probe else []))
    out = {"eager_peak": torch.cuda.max_memory_allocated(), "eager_step": eager.global_step,
           "eager_params": _params(eager), "eager_ms": eager_probe.ms_per_step() if eager_probe else None}
    _check(eager.step_graph is None, f"{tag}: the eager run has a step graph")
    del eager
    torch.cuda.empty_cache()
    jitter_normalize.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with _logged() as lines:
        trainer = train.main(_rerun_args(ref, run_dir, k, *extra), callbacks=[probe] if probe else [])
    out.update(wall=time.perf_counter() - t0, peak=torch.cuda.max_memory_allocated(), trainer=trainer,
               lines=lines, wrapper_launches=jitter_normalize.launches)
    graph = trainer.step_graph
    _check(graph is not None and trainer.device.type == "cuda", f"{tag}: no step graph")
    _check(graph.captures == 1 and graph.replays == trainer.global_step,
           f"{tag}: {graph.captures} captures, {graph.replays} replays in {trainer.global_step} steps")
    out["rows"], out["row_err"] = _hold_rows(tag, run_dir, f"{run_dir}_eager")
    out["lr"] = _max_lr(graph.module.cfg)
    if trainer.global_step == out["eager_step"]:
        out["param_err"] = _hold_params(tag, _params(trainer), out["eager_params"], out["lr"], trainer.global_step)
    return out


def _scan_kernel_check(tag: str, trainer, leaves) -> float:
    """jitter_normalize against its plain version on the graphed run's own
    frames: the step graph's static batch (the last replayed step's),
    resized and shifted to 128x128 bf16 with the transform's ranges."""
    cfg = trainer.step_graph.module.transforms.cfg["rgb_static"]
    g = torch.Generator(device="cuda").manual_seed(17)
    pad, size = int(cfg["pad"]), tuple(cfg["size"])
    worst = 0.0
    for leaf in leaves:
        frames = trainer.step_graph.batch[leaf]["rgb_static"]
        frames = frames.reshape((-1,) + tuple(frames.shape[-3:])).movedim(-1, -3).contiguous()
        n = frames.shape[0]
        shifts = torch.randint(0, 2 * pad + 1, (n, 2), generator=g, device="cuda")
        x = image_aug.resize_shift(frames, shifts, size, pad, dtype=torch.bfloat16).contiguous()
        # the transform's ranges, its defaults where the config names none
        f = sample_jitter_factors(n, g, brightness=cfg.get("brightness", 0.1), contrast=cfg.get("contrast", 0.1),
                                  hue=cfg.get("hue", 0.02), prob=cfg.get("jitter_prob", 1.0))
        worst = max(worst, _compare(jitter_normalize(x, f), jitter_normalize_reference(x, f), BF16_ATOL,
                                    f"{tag}: jitter_normalize vs plain on the graphed run's {leaf} frames"))
    return worst


def _traced_steps(probe) -> dict:
    """The device trace of the run's own replays of the steps in SCAN_TRACED:
    kernels, copies and device ms a step and kernel 1's launches in all."""
    steps = SCAN_TRACED[1] - SCAN_TRACED[0]
    events = probe.prof.key_averages()
    kernels, copies, device_ms = _kernel_counts(events, steps)
    jitter = _jitter_in_trace(events)
    return {"steps": steps, "kernels": kernels, "copies": copies, "device_ms": device_ms, "jitter": jitter}


def _replay_ms(graph) -> float:
    """Device ms of one replay of the captured step, over SCAN_REPLAYS
    replays after the run (CUDA events)."""
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(SCAN_REPLAYS):
        graph.graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / SCAN_REPLAYS


def _scan_stage(card: str, experiment: str, root: str, leaves, launches_per_step: int) -> dict:
    """One stage at K = 4 for its phase's 2 epochs of 12 steps against an
    eager run of the same seed and batches, then the measurements."""
    ref = REFERENCES[experiment]
    tag = f"train_scan/{experiment}"
    probe = _ScanProbe(trace=True)
    out = _scan_pair(tag, ref["args"], f"{root}/scan_{experiment}", SCAN_K,
                     f"trainer.log_every_n_steps={SCAN_LOG_EVERY}", probe=probe)
    trainer = out["trainer"]
    params = _params(trainer)  # before the replays below step the weights on
    wrapper_count = out["wrapper_launches"]
    _check(probe.chunks == list(range(SCAN_K, trainer.global_step + 1, SCAN_K)), f"{tag}: chunks {probe.chunks}")
    default_err = _hold_params(f"{tag} vs the default eager run", _params(trainer), ref["params"], out["lr"],
                               ref["step"])
    kernel_err = _scan_kernel_check(tag, trainer, leaves)
    traced = _traced_steps(probe)
    _check(probe.eager_launches == 0, f"{tag}: {probe.eager_launches} eager launches in the traced steps")
    _check(traced["jitter"] == launches_per_step * traced["steps"],
           f"{tag}: {traced['jitter']} jitter_normalize launches in the trace of {traced['steps']} replays")
    replay_ms = _replay_ms(trainer.step_graph)
    waits = {step: sum(probe.syncs[step].values()) for step in SCAN_WAITS[1:]}
    ms = probe.ms_per_step()
    graph = trainer.step_graph
    print(
        f"[{tag}] K={SCAN_K}: {graph.captures} capture, {graph.replays} replays in {len(probe.chunks)} chunks"
        + (f", kl_beta at the epoch starts {probe.kl_betas}" if probe.kl_betas[0] is not None else "")
        + f" | against an eager run of the same seed and batches "
        f"(its Adam capturable, as the graph's): {out['rows']} rows within rtol 1e-4 (largest "
        f"{out['row_err']:.3g}), parameters at step {trainer.global_step} within {out['param_err']:.3g}; against "
        f"phase 16/18's eager run (Adam as the eager path runs it): parameters within {default_err:.3g} (atol "
        f"2.5 lr a step = {2.5 * out['lr'] * ref['step']:.3g}) | jitter_normalize {traced['jitter']} launches "
        f"in the device trace of the run's replays of steps {SCAN_TRACED[0] + 1}-{SCAN_TRACED[1]} (the wrapper "
        f"counted 0 there, and {wrapper_count} in the whole run, none of them a replay's), vs "
        f"plain on the graphed run's frames max abs err {kernel_err:.3g} (atol {BF16_ATOL}) | {card}",
        flush=True,
    )
    print(
        f"[{tag}] {ms:.3f} ms/step ({1e3 / ms:.2f} steps/s) over steps {SCAN_TIMED[0] + 1}-{SCAN_TIMED[1]}, the "
        f"eager run {out['eager_ms']:.3f} ms/step over the same steps (phase {16 if experiment == 'play_lmp_for_rl' else 18}: "
        f"{ref['ms']:.3f} over steps {TIMED_FROM + 1}-{TIMED_TO}) | a replay of the step: {replay_ms:.3f} "
        f"ms on the device after the run; in the trace of steps {SCAN_TRACED[0] + 1}-{SCAN_TRACED[1]} a step "
        f"ran {traced['kernels']:.0f} kernels and {traced['copies']:.1f} copies, {traced['device_ms']:.3f} device "
        f"ms; busy {replay_ms / ms:.1%} of the trained step (a replay's device ms over the step's ms; idle "
        f"{1 - replay_ms / ms:.1%}) | "
        f"host waits a logging / non-logging chunk of {SCAN_K} steps {waits[SCAN_WAITS[1]]} / "
        f"{waits[SCAN_WAITS[2]]}, at: {_sites(probe.syncs[SCAN_WAITS[1]])} / {_sites(probe.syncs[SCAN_WAITS[2]])} "
        f"| peak memory {out['peak'] / 2**30:.2f} GiB graphed, {out['eager_peak'] / 2**30:.2f} GiB eager | "
        f"train.main {out['wall']:.1f} s | {card}",
        flush=True,
    )
    result = {"ms": ms, "eager_ms": out["eager_ms"], "launches": traced["jitter"], "kernel_err": kernel_err,
              "args": _rerun_args(ref, f"{root}/scan_{experiment}", SCAN_K, f"trainer.log_every_n_steps={SCAN_LOG_EVERY}"),
              "dir": f"{root}/scan_{experiment}", "params": params}
    del trainer, out
    torch.cuda.empty_cache()
    return result


def _scan_drop(card: str, root: str) -> None:
    """Stage 1 at K = 5 for 2 epochs: 12 batches an epoch make 2 chunks and
    a dropped chunk of 2, logged each epoch; held against an eager run of
    the first 10 steps (rows up to step 10, parameters at step 10)."""
    from tacorl_tpu_torch import train

    ref = REFERENCES["play_lmp_for_rl"]
    tag = "train_scan/drop"
    log_every = f"trainer.log_every_n_steps={SCAN_DROP_K}"
    eager = train.main(_rerun_args(ref, f"{root}/drop_eager", 1, "trainer.max_steps=10", log_every),
                       callbacks=[_Capturable()])
    eager_params = _params(eager)
    del eager
    probe = _ScanProbe(snapshot_at=(10,))
    with _logged() as lines:
        trainer = train.main(_rerun_args(ref, f"{root}/drop", SCAN_DROP_K, "trainer.max_steps=1000",
                                         "trainer.max_epochs=2", log_every), callbacks=[probe])
    drops = [m for m in lines if m.startswith("scanned dispatch dropped a trailing partial chunk of 2/5")]
    _check(trainer.global_step == 20 and probe.chunks == [5, 10, 15, 20] and len(drops) == 2,
           f"{tag}: {trainer.global_step} steps, chunks {probe.chunks}, {len(drops)} drops logged")
    _check(trainer.step_graph.captures == 1 and trainer.step_graph.replays == 20, f"{tag}: replays")
    rows, row_err = _hold_rows(tag, f"{root}/drop", f"{root}/drop_eager", upto=10)
    param_err = _hold_params(tag, probe.snapshots[10], eager_params, _max_lr(trainer.step_graph.module.cfg), 10)
    print(f"[{tag}] K={SCAN_DROP_K}: {trainer.global_step} steps in 2 epochs of 12 batches, chunks ending at "
          f"{probe.chunks}, the trailing chunk of 2 dropped and logged {len(drops)} times | against an eager run "
          f"of steps 1-10: {rows} rows within rtol 1e-4 (largest {row_err:.3g}), parameters at step 10 within "
          f"{param_err:.3g} | {card}", flush=True)
    del trainer
    torch.cuda.empty_cache()


def phase_train_scan(card: str, root: str, flat_data: str, flat_pct: float) -> dict:
    """trainer.steps_per_call > 1 as CUDA-graph replays of the train step,
    each run held against an eager run of the same seed and batches:
    stage 1 (experiment=play_lmp_for_rl, phase 16's arguments) and stage 2
    (experiment=tacorl grafted from it, phase 18's) at K = 4, with the
    measurements; stage 1 at K = 5 (a dropped chunk); experiment=cql_fake
    (visual), ril, play_lmp_d4rl and tacorl_d4rl at K = 4 for one epoch;
    sac_online_fake at K = 4 trains one step a call."""
    from tacorl_tpu_torch import train

    t0 = time.perf_counter()
    out = {"play_lmp_for_rl": _scan_stage(card, "play_lmp_for_rl", root, ("states",), 1),
           "tacorl": _scan_stage(card, "tacorl", root, ("states", "goal"), 2)}
    _scan_drop(card, root)
    print(f"[train_scan] stages 1 and 2 and the dropped chunk took {time.perf_counter() - t0:.1f} s", flush=True)
    others = {"cql_fake": _train_args("cql_fake", flat_data, "", 12, f"datamodule.train_percentage={flat_pct}",
                                      *FLAT_ARGS)}
    others.update({e: REFERENCES[e]["args"] for e in SCAN_OTHERS})
    lines = []
    for experiment, args in others.items():
        pair = _scan_pair(f"train_scan/{experiment}", args, f"{root}/scan_{experiment}", SCAN_K,
                          "trainer.max_steps=12")
        _check(pair["trainer"].global_step == 12, f"train_scan/{experiment}: {pair['trainer'].global_step} steps")
        lines.append(f"{experiment}: {pair['rows']} rows (largest {pair['row_err']:.3g}), parameters within "
                     f"{pair['param_err']:.3g}, {pair['wall']:.1f} s")
        del pair
        torch.cuda.empty_cache()
    print(f"[train_scan] K={SCAN_K}, one epoch of 12 steps, 1 capture and 12 replays each, against an eager run "
          f"of the same seed and batches: {'; '.join(lines)} | {card}", flush=True)
    ref = REFERENCES["sac_online_fake"]
    online = train.main(_rerun_args(ref, f"{root}/scan_sac_online_fake", SCAN_K))
    _check(online.step_graph is None and online.global_step == ref["step"], "train_scan/sac_online_fake: graphed")
    held, err = _hold_rows("train_scan/sac_online_fake", f"{root}/scan_sac_online_fake", ref["run_dir"])
    print(f"[train_scan/sac_online_fake] steps_per_call={SCAN_K}: one step a call (SAC steps the env inside "
          f"its train step), no step graph, {online.global_step} steps; {held} rows equal to phase 30's K=1 run "
          f"within {err:.3g} | the phase took {time.perf_counter() - t0:.1f} s | {card}", flush=True)
    del online
    torch.cuda.empty_cache()
    return out


# -- the off-path networks and options: Gaussian decoder, D2RL/DenseNet, VIB, encoders, depth -----

GAUSSIAN_DECODER = {  # configs/networks/action_decoder/gaussian.yaml
    "_target_": "tacorl_tpu.networks.action_decoder.ActionDecoderGaussian", "n_mixtures": 10,
    "num_layers": 2, "hidden_size": 2048, "out_features": 7, "policy_rnn_dropout_p": 0.0,
    "rnn_model": "lstm_decoder", "include_goal": False, "discrete_gripper": False,
}
VARIANT_K = 4  # the graphed chunk of the Gaussian stage-1 step
ENCODER_N, ENCODER_HW = 1024, 128  # batch 64 x window 16 at the transform's 128x128
TRAIN_VARIANT_STEPS, TRAIN_VARIANT_WINDOW = 200, 20


def _gaussian_cfg(cfg: dict, decoder: dict) -> dict:
    cfg = copy.deepcopy(cfg)
    cfg["action_decoder"] = dict(decoder)
    cfg["add_random_plan_loss"] = True
    return cfg


def _lmp_variant_draws(module, g, b: int, t: int) -> dict:
    """The Play-LMP step's ``draws`` from the CPU generator ``g``: the
    uniform random plan and goal and both Gaussian decoder samples' Gumbel
    noise and normals (the window less its goal frame)."""
    dec = module.net.action_decoder
    latent, goal = module.latent_plan_dim, module.net.goal_encoder.mlp[-1].out_features

    def decoder():
        u = torch.rand((b, t - 1, dec.n_mixtures), generator=g).clamp_min(torch.finfo(torch.float32).tiny)
        return {"gumbel": -torch.log(-torch.log(u)), "eps": torch.randn((b, t - 1, dec.out_features), generator=g)}

    return {"random_plan": torch.rand((b, latent), generator=g) * 2 - 1,
            "random_goal": torch.rand((b, goal), generator=g) * 2 - 1,
            "decoder": decoder(), "random_decoder": decoder()}


def _tiny_cql_variant_cfg() -> dict:
    """A tiny float32 visual CQL config with a D2RL actor, DenseNet critics
    and the VIB regularizer on a vib: true critic encoder."""
    enc = {"_target_": "tacorl_tpu.networks.encoders.LMPVisionEncoder", "latent_dim": 8, "hidden_dim": 16,
           "compute_dtype": None}
    return {
        "action_dim": 7, "actor_lr": 1e-3, "critic_lr": 1e-3, "obs_modalities": ["rgb_static"],
        "goal_modalities": ["rgb_static"], "actor_encoder": {"networks": {"rgb_static": enc}},
        "critic_encoder": {"networks": {"rgb_static": {**enc, "vib": True}}}, "goal_encoder": {"hidden_size": 16},
        "policy": {"_target_": "tacorl_tpu.networks.actor.D2RLPolicy", "num_layers": 2, "hidden_dim": 16,
                   "discrete_gripper": True},
        "q_network": {"_target_": "tacorl_tpu.networks.critic.DenseNetQNetwork", "num_layers": 2,
                      "hidden_dim": 16},
        "n_action_samples": 3, "with_lagrange": True, "with_vib": True, "vib_coefficient": 0.05,
        "transforms": {"rgb_static": {"kind": "rgb", "size": [48, 48], "pad": 2}},
    }


def _vib_draws(module, g, bs: int) -> dict:
    lat = module.net.q1.encoder.networks["rgb_static"].latent_dim
    return {part: {"rgb_static": torch.randn((bs, lat), generator=g)} for part in ("observation", "goal")}


def _grad_norms(state):
    """Record each optimizer group's gradient norm as the CQL step hands
    the gradients over."""
    norms, step_group = {}, state.optimizer.step_group

    def recording(name, grads):
        norms[name] = float(torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads])))
        return step_group(name, grads)

    state.optimizer.step_group = recording
    return norms


def _variant_encoders(hw: int, dtype=None) -> dict:
    """Each new encoder at its config defaults (float32 convolutions when
    ``dtype`` is None), the input size its transform would give."""
    from tacorl_tpu_torch.networks.encoders import CustomEncoder, DeepSpatialEncoder, ResNetRLEncoder
    from tacorl_tpu_torch.networks.layers import TorchConv, resolve_dtype
    from tacorl_tpu_torch.networks.resnet import R3MEncoder, ResNet18Encoder

    cd = {"compute_dtype": dtype}
    r3m = R3MEncoder()  # its backbone has no dtype option: set its convolutions'
    r3m.backbone.apply(lambda m: setattr(m, "compute_dtype", resolve_dtype(dtype)) if isinstance(m, TorchConv) else None)
    return {
        "CustomEncoder": CustomEncoder(input_hw=(hw, hw), **cd),
        "ResNetRLEncoder": ResNetRLEncoder(**cd),
        "DeepSpatialEncoder": DeepSpatialEncoder(**cd),
        "ResNet18Encoder": ResNet18Encoder(**cd),
        "R3MEncoder": r3m,
    }


def phase_reference_variants() -> None:
    """Tiny float32 configs on the card and on the CPU from the same
    weights, batch and draws: (a) a Play-LMP step with the Gaussian LSTM
    decoder and the random-plan loss, (b) a visual CQL step with a D2RL
    actor, DenseNet critics and VIB, (c) forward and backward of each new
    encoder in train mode with its BatchNorm running statistics; losses,
    gradient norms, outputs and statistics within rtol 1e-4; (d) the
    bf16_matmul decoder (``_reference_bf16_decoder``)."""
    from tacorl_tpu_torch.networks.encoders import VectorEncoder

    def close(tag, a, b):
        _check(np.isfinite(a) and abs(a - b) <= 1e-4 * abs(b) + 1e-6, f"reference_variants {tag}: cuda {a} vs cpu {b}")
        return abs(a - b) / max(abs(b), 1e-6)

    # (a) Play-LMP, Gaussian LSTM decoder, random-plan loss
    cfg = _gaussian_cfg(_tiny_cfg(), {**GAUSSIAN_DECODER, "hidden_size": 32, "n_mixtures": 4})
    batch, g = _batch(3, 5, 56, seed=2), torch.Generator().manual_seed(2)
    aug = {"rgb_static": {"shifts": torch.randint(0, 5, (15, 2), generator=g), "factors": sample_jitter_factors(15, g)}}
    eps, results, draws = torch.randn((3, 16), generator=g), {}, None
    for device in ("cpu", "cuda"):
        module = PlayLMPModule(cfg, device=device)
        state = module.init_state(0)
        draws = draws or _lmp_variant_draws(module, g, 3, 5)
        _, m = module.make_train_step()(state, batch, aug_draws=_to_device(aug, device), eps=eps.to(device),
                                        draws=_to_device(draws, device))
        results[device] = {k: float(v) for k, v in m.items()}
    worst_a = max(close(f"(a) {k}", results["cuda"][k], results["cpu"][k]) for k in results["cpu"]
                  if k != "total_loss")
    # the total is a difference of two near-equal action losses: rtol 1e-4 of those terms
    scale = max(abs(results["cpu"]["action_loss"]), abs(results["cpu"]["random_plan_action_loss"]))
    _check(abs(results["cuda"]["total_loss"] - results["cpu"]["total_loss"]) <= 1e-4 * scale,
           f"reference_variants (a) total_loss: {results['cuda']['total_loss']} vs {results['cpu']['total_loss']}")
    line_a = (f"(a) Play-LMP + Gaussian LSTM + random-plan loss: action_loss {results['cuda']['action_loss']:.6f} vs "
              f"{results['cpu']['action_loss']:.6f}, random_plan_action_loss "
              f"{results['cuda']['random_plan_action_loss']:.6f}, grad_norm {results['cuda']['grad_norm']:.6f} vs "
              f"{results['cpu']['grad_norm']:.6f}, largest relative difference {worst_a:.3g}")

    # (b) visual CQL: D2RL actor, DenseNet critics, VIB
    cfg, results, norms, weights = _tiny_cql_variant_cfg(), {}, {}, None
    for device in ("cpu", "cuda"):
        module = CQLModule(cfg, device=device)
        state = module.init_state(0)
        if weights is None:
            weights = {k: v.clone() for k, v in module.net.state_dict().items()}
            rs = np.random.RandomState(4)
            img = lambda: rs.randint(0, 256, (4, 48, 48, 3), dtype=np.uint8)  # noqa: E731
            goal = img()
            cql_batch = {"observations": {"observation": {"rgb_static": img()}, "goal": {"rgb_static": goal}},
                         "next_observations": {"observation": {"rgb_static": img()}, "goal": {"rgb_static": goal}},
                         "actions": rs.uniform(-1, 1, (4, 7)).astype(np.float32),
                         "rewards": np.asarray([1, 0, 0, 0], np.float32), "terminals": np.asarray([1, 0, 0, 0], np.float32)}
            g = torch.Generator().manual_seed(4)
            cql_draws = {**_flat_draws(module, g, 4), "vib": _vib_draws(module, g, 4)}
        module.net.load_state_dict(weights)
        norms[device] = _grad_norms(state)
        _, m = module.make_train_step()(state, cql_batch, {"bc_phase": 0.0}, draws=_to_device(cql_draws, device))
        results[device] = {k: float(v) for k, v in m.items()}
    _check({"q1_vib_loss", "q2_vib_loss"} <= set(results["cuda"]), "reference_variants (b): no VIB loss")
    worst_b = max([close(f"(b) {k}", results["cuda"][k], results["cpu"][k]) for k in results["cpu"]]
                  + [close(f"(b) {k} grad norm", norms["cuda"][k], norms["cpu"][k]) for k in norms["cpu"]])
    line_b = (f"(b) CQL D2RL/DenseNet/VIB: {len(results['cpu'])} metrics and {len(norms['cpu'])} group grad norms, "
              f"q1_vib_loss {results['cuda']['q1_vib_loss']:.6f} vs {results['cpu']['q1_vib_loss']:.6f}, largest "
              f"relative difference {worst_b:.3g}")

    # (c) each new encoder, train mode, forward and backward, running statistics
    lines = []
    x = torch.rand((4, 3, 64, 64), generator=torch.Generator().manual_seed(5)) * 2 - 1
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(5)
        encoders = {**_variant_encoders(64), "VectorEncoder": VectorEncoder(8, hidden=(16,), in_features=12)}
    for name, enc in encoders.items():
        inp = x if name != "VectorEncoder" else x[:, 0, 0, :12].contiguous()
        out = {}
        for device in ("cpu", "cuda"):
            net = copy.deepcopy(enc).to(device).train()
            y = net(inp.to(device))
            w = torch.linspace(-1, 1, y.numel(), device=device).reshape(y.shape)
            (y * w).sum().backward()
            grads = [p.grad for p in net.parameters() if p.grad is not None]
            out[device] = {
                "y": y.detach().cpu(), "grad_norm": float(torch.linalg.vector_norm(torch.stack(
                    [torch.linalg.vector_norm(gr) for gr in grads]))),
                "stats": {k: v.cpu() for k, v in net.state_dict().items() if k.endswith(("running_mean", "running_var"))},
            }
        err = float((out["cuda"]["y"] - out["cpu"]["y"]).abs().max())
        _check(err <= 1e-4 * max(float(out["cpu"]["y"].abs().max()), 1.0), f"reference_variants (c) {name}: output {err}")
        close(f"(c) {name} grad norm", out["cuda"]["grad_norm"], out["cpu"]["grad_norm"])
        stats = max([float((out["cuda"]["stats"][k] - v).abs().max()) for k, v in out["cpu"]["stats"].items()] or [0.0])
        _check(stats <= 1e-4, f"reference_variants (c) {name}: running statistics differ by {stats}")
        lines.append(f"{name} out {err:.2g}, stats {stats:.2g} ({len(out['cpu']['stats'])})")
    line_d = _reference_bf16_decoder(close)
    print("[reference_variants] tiny float32, cuda vs cpu from the same weights, batch and draws (rtol 1e-4): "
          f"{line_a}; {line_b}; (c) train-mode forward+backward, largest abs diff: " + ", ".join(lines)
          + f"; {line_d}", flush=True)


def _reference_bf16_decoder(close) -> str:
    """(d) the bf16_matmul ReLU-RNN decoder, forward and backward, on the
    card (the recurrence's ``torch.mm(..., out_dtype=float32)`` and its
    hand-written backward, cuBLAS's bf16 GEMMs) against the CPU (the bf16
    operands upcast), from the same weights and batch: loss and gradient
    norm within rtol 1e-4; the output and each gradient as far from the
    float32 decoder's (bf16_matmul off, on the CPU) as the CPU's bf16 path
    is, within 2e-2 of its scale. Two bf16 paths that sum in different
    orders round the cotangents differently at each of the 16 steps, so
    they differ elementwise by as much as each differs from float32."""
    from tacorl_tpu_torch.networks.action_decoder import ActionDecoderLogistic

    g = torch.Generator().manual_seed(6)
    b, t = 8, 16
    plan, emb = torch.randn((b, 16), generator=g), torch.randn((b, t, 32), generator=g)
    actions = torch.rand((b, t, 7), generator=g) * 2 - 1
    kw = dict(state_dim=32, latent_plan_dim=16, hidden_size=256, num_layers=2, n_mixtures=5)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(6)
        dec = ActionDecoderLogistic(**kw, bf16_matmul=True)
    f32 = ActionDecoderLogistic(**kw)
    f32.load_state_dict(dec.state_dict())
    out = {}
    for tag, net, device in (("cpu", dec, "cpu"), ("cuda", dec, "cuda"), ("f32", f32, "cpu")):
        net = copy.deepcopy(net).to(device)
        means = net(plan.to(device), emb.to(device))[2]
        loss = net.loss(plan.to(device), emb.to(device), actions.to(device))
        loss.backward()
        grads = {n: p.grad.cpu() for n, p in net.named_parameters() if p.grad is not None}
        out[tag] = {"means": means.detach().cpu(), "loss": float(loss.detach()), "grads": grads, "grad_norm": float(
            torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(gr) for gr in grads.values()])))}
    _check(out["cuda"]["means"].dtype == torch.float32 and "rnn.weight_hh_l1" in out["cuda"]["grads"],
           "reference_variants (d): no float32 output or no recurrent gradient")
    worst = max(close("(d) bf16 decoder loss", out["cuda"]["loss"], out["cpu"]["loss"]),
                close("(d) bf16 decoder grad norm", out["cuda"]["grad_norm"], out["cpu"]["grad_norm"]))
    tensors = {tag: {"means": o["means"], **o["grads"]} for tag, o in out.items()}
    rel = {}
    for name, ref in tensors["f32"].items():
        scale = max(float(ref.abs().max()), 1e-12)
        card, cpu = ((tensors[k][name] - ref).abs().max() / scale for k in ("cuda", "cpu"))
        diff = float((tensors["cuda"][name] - tensors["cpu"][name]).abs().max()) / scale
        rel[name] = (float(card), float(cpu), diff)
        _check(torch.isfinite(tensors["cuda"][name]).all() and card <= cpu + 2e-2,
               f"reference_variants (d) bf16 decoder {name}: {float(card):.3g} of its scale from float32 on the "
               f"card, {float(cpu):.3g} on the CPU")
    name = max(rel, key=lambda k: rel[k][2])
    graph = _bf16_decoder_graph()
    return (f"(d) bf16_matmul ReLU-RNN decoder (2x256, batch {b} x {t}) forward+backward: loss "
            f"{out['cuda']['loss']:.6f} vs {out['cpu']['loss']:.6f}, grad norm {out['cuda']['grad_norm']:.6f} vs "
            f"{out['cpu']['grad_norm']:.6f}, largest relative difference {worst:.3g}; largest elementwise card-CPU "
            f"difference {rel[name][2]:.3g} of its scale ({name}: {rel[name][0]:.3g} from float32 on the card, "
            f"{rel[name][1]:.3g} on the CPU); largest distance from float32 on the card "
            f"{max(v[0] for v in rel.values()):.3g}, on the CPU {max(v[1] for v in rel.values()):.3g}; {graph}")


def _bf16_decoder_graph() -> str:
    """A tiny Play-LMP step with the bf16_matmul decoder (2x64), K=4 steps
    captured and replayed through core/graphs.py:StepGraph, against an
    eager twin with capturable Adam: metrics within rtol 1e-4, parameters
    within 2.5 lr a step."""
    from tacorl_tpu_torch.core.graphs import seed_generators
    from tacorl_tpu_torch.core.optimizers import set_capturable
    from tacorl_tpu_torch.data.loader import tree_map

    cfg, k, seed = _tiny_cfg(), 4, 3
    cfg["action_decoder"] = {"hidden_size": 64, "num_layers": 2, "n_mixtures": 4, "bf16_matmul": True}
    parts = [_batch(3, 5, 56, seed=i) for i in range(k)]
    stacked = {"states": {"rgb_static": torch.from_numpy(np.stack([p["states"]["rgb_static"] for p in parts])).cuda()},
               "actions": torch.from_numpy(np.stack([p["actions"] for p in parts])).cuda()}
    twin = PlayLMPModule(cfg, device="cuda")
    twin_state, twin_step = twin.init_state(0), twin.make_train_step()
    set_capturable(twin_state.optimizer, True)
    for i in range(k):
        seed_generators(twin, twin.device, seed, i)
        twin_state, twin_m = twin_step(twin_state, tree_map(lambda x: x[i], stacked))
    graphed = PlayLMPModule(cfg, device="cuda")
    g_state, scanned = graphed.init_state(0), graphed.make_scanned_train_step()
    g_state, g_m = scanned(g_state, stacked, seed=seed)
    torch.cuda.synchronize()
    _check(graphed.net.action_decoder.rnn.bf16_matmul and scanned.graph.captures == 1
           and scanned.graph.replays == k, f"reference_variants (d) graph: {scanned.graph.captures} captures, "
           f"{scanned.graph.replays} replays")
    row_err = max(abs(float(g_m[key]) - float(v)) / max(abs(float(v)), 1e-6) for key, v in twin_m.items())
    param_err = max(float((v - twin.net.state_dict()[key]).abs().max()) for key, v in graphed.net.state_dict().items())
    _check(np.isfinite(float(g_m["total_loss"])) and row_err <= 1e-4 and param_err <= 2.5 * cfg["lr"] * k,
           f"reference_variants (d) graph: metrics {row_err}, parameters {param_err} from the eager twin")
    return (f"the bf16 decoder in a tiny Play-LMP step, K={k} through StepGraph (1 capture, {k} replays) against "
            f"an eager twin with capturable Adam: metrics within {row_err:.3g}, parameters within {param_err:.3g} "
            f"(atol {2.5 * cfg['lr'] * k:.3g})")


def _stacked_batch(k: int, seed: int) -> dict:
    """K production Play-LMP batches stacked (K, 64, 16, ...), made on the
    card."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    return {"states": {"rgb_static": torch.randint(0, 256, (k, BATCH, WINDOW, RAW_HW, RAW_HW, 3), generator=g,
                                                   device="cuda", dtype=torch.uint8)},
            "actions": torch.rand((k, BATCH, WINDOW, 7), generator=g, device="cuda") * 2 - 1}


def _gaussian_stage1(card: str) -> dict:
    """The production Play-LMP step with gaussian.yaml's decoder and the
    random-plan loss: 12 eager steps, then a K=4 graphed chunk against an
    eager twin with capturable Adam, its replays traced."""
    from torch.profiler import ProfilerActivity, profile

    from tacorl_tpu_torch.core.graphs import seed_generators
    from tacorl_tpu_torch.core.optimizers import set_capturable
    from tacorl_tpu_torch.data.loader import tree_map

    cfg = _gaussian_cfg(PRODUCTION_CFG, GAUSSIAN_DECODER)
    module = PlayLMPModule(cfg, device="cuda")
    state, step = module.init_state(0), module.make_train_step()
    batch = tree_map(lambda x: x[0], _stacked_batch(1, 0))
    before = {k: v.detach().clone() for k, v in module.net.state_dict().items()}
    jitter_normalize.launches, times, losses = 0, [], []
    for _ in range(SLICE_STEPS):
        t0 = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append({k: float(v) for k, v in m.items()})
    eager_launches = jitter_normalize.launches
    _check(all(np.isfinite(v) for r in losses for v in r.values()), f"slice_variants/gaussian: non-finite {losses[-1]}")
    _check(eager_launches == SLICE_STEPS, f"slice_variants/gaussian: {eager_launches} launches in {SLICE_STEPS} steps")
    changed = sum(not torch.equal(before[k], v) for k, v in module.net.state_dict().items())
    _check(changed > 0, "slice_variants/gaussian: no parameter changed")
    ms = statistics.median(times[SLICE_WARMUP:])
    lstm = module.net.action_decoder.rnn
    del module, state, step, before
    torch.cuda.empty_cache()

    stacked, seed = _stacked_batch(VARIANT_K, 1), 7
    twin = PlayLMPModule(cfg, device="cuda")
    twin_state, twin_step = twin.init_state(0), twin.make_train_step()
    set_capturable(twin_state.optimizer, True)
    for i in range(2 * VARIANT_K):
        seed_generators(twin, twin.device, seed, i)
        twin_state, twin_m = twin_step(twin_state, tree_map(lambda x: x[i % VARIANT_K], stacked))
    twin_m = {k: float(v) for k, v in twin_m.items()}
    twin_params = {k: v.detach().clone() for k, v in twin.net.state_dict().items()}
    del twin, twin_state, twin_step
    torch.cuda.empty_cache()
    graphed = PlayLMPModule(cfg, device="cuda")
    g_state, scanned = graphed.init_state(0), graphed.make_scanned_train_step()
    g_state, _ = scanned(g_state, stacked, seed=seed)  # capture, then K replays
    torch.cuda.synchronize()
    jitter_normalize.launches = 0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        g_state, g_m = scanned(g_state, stacked, seed=seed)
        torch.cuda.synchronize()
    from torch.autograd import DeviceType

    events = prof.key_averages()
    names = {e.key for e in events if e.device_type == DeviceType.CPU}
    replay_launches = sum(e.count for e in events if e.device_type == DeviceType.CUDA and e.key not in names
                          and "jitter_normalize_kernel" in e.key and "shift_" not in e.key)
    graph = scanned.graph
    _check(graph.captures == 1 and graph.replays == 2 * VARIANT_K and g_state.step == 2 * VARIANT_K,
           f"slice_variants/gaussian graph: {graph.captures} captures, {graph.replays} replays")
    _check(jitter_normalize.launches == 0 and replay_launches == VARIANT_K,
           f"slice_variants/gaussian graph: {replay_launches} jitter launches traced in {VARIANT_K} replays, "
           f"{jitter_normalize.launches} eager")
    row_err = max(abs(float(g_m[k]) - v) / max(abs(v), 1e-6) for k, v in twin_m.items() if k != "total_loss")
    _check(row_err <= 1e-4, f"slice_variants/gaussian graph: metrics differ from the eager twin by {row_err}")
    param_err = max(float((v - twin_params[k]).abs().max()) for k, v in graphed.net.state_dict().items())
    _check(param_err <= 2.5 * cfg["lr"] * 2 * VARIANT_K, f"slice_variants/gaussian graph: params differ by {param_err}")
    bitwise = param_err == 0.0 and all(float(g_m[k]) == v for k, v in twin_m.items())
    replay_ms = _replay_ms(graph)
    print(
        f"[slice_variants/gaussian] production Play-LMP step with gaussian.yaml's decoder ({type(lstm).__name__} "
        f"2x2048, 10 mixtures) and the random-plan loss, batch {BATCH} x window {WINDOW}, {RAW_HW}x{RAW_HW} uint8: "
        f"{SLICE_STEPS} steps, median {ms:.3f} ms/step ({1e3 / ms:.2f} steps/s) over steps {SLICE_WARMUP + 1}-"
        f"{SLICE_STEPS}, first {times[0]:.1f} ms | action_loss {losses[0]['action_loss']:.4f} -> "
        f"{losses[-1]['action_loss']:.4f}, random_plan_action_loss {losses[-1]['random_plan_action_loss']:.4f} | "
        f"{changed} tensors changed | jitter_normalize {eager_launches} launches in {SLICE_STEPS} eager steps | "
        f"K={VARIANT_K} through StepGraph: cuDNN's LSTM captured ({graph.captures} capture, {graph.replays} "
        f"replays), {replay_launches} jitter_normalize launches in the device trace of {VARIANT_K} replays (0 "
        f"eager); against an eager twin with capturable Adam after {2 * VARIANT_K} steps: "
        f"{'bit for bit' if bitwise else 'not bit for bit'}, metrics within {row_err:.3g}, parameters within "
        f"{param_err:.3g} (atol {2.5 * cfg['lr'] * 2 * VARIANT_K:.3g}) | a replay {replay_ms:.3f} ms on the device | "
        f"{card}",
        flush=True,
    )
    del graphed, g_state, scanned, stacked
    torch.cuda.empty_cache()
    return {"eager": eager_launches, "graph": replay_launches, "ms": ms, "replay_ms": replay_ms}


def _cql_variant(card: str) -> int:
    """experiment=cql_fake's module at its composed widths with a D2RL actor,
    DenseNet critics and VIB: 12 steps on device-resident batches."""
    cfg = _flat_module_cfg(["experiment=cql_fake", "networks/policy=d2rl", "networks/q_network=densenet",
                            "module.with_vib=true", "module.critic_encoder.networks.rgb_static.vib=true"])
    module = CQLModule(cfg, device="cuda")
    state, step = module.init_state(0), module.make_train_step()
    batch = _to_device(_flat_batch(module, seed=9), "cuda")
    before = {k: v.detach().clone() for k, v in module.net.state_dict().items()}
    jitter_normalize.launches, times, rows = 0, [], []
    for _ in range(SLICE_STEPS):
        t0 = time.perf_counter()
        state, m = step(state, batch, {"bc_phase": 0.0})
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        rows.append({k: float(v) for k, v in m.items()})
    launches = jitter_normalize.launches
    _check(all(np.isfinite(v) for r in rows for v in r.values()), f"slice_variants/cql: non-finite {rows[-1]}")
    _check(launches == CQL_LAUNCHES_PER_STEP * SLICE_STEPS, f"slice_variants/cql: {launches} jitter launches")
    _check("q1_vib_loss" in rows[-1], "slice_variants/cql: no VIB loss")
    changed = sum(not torch.equal(before[k], v) for k, v in module.net.state_dict().items())
    _check(changed > 0, "slice_variants/cql: no parameter changed")
    ms = statistics.median(times[SLICE_WARMUP:])
    q = module.net.q1.critic.Q
    print(
        f"[slice_variants/cql] experiment=cql_fake's widths with networks/policy=d2rl, networks/q_network=densenet "
        f"({type(q).__name__}, trunk {q.trunk_dim} wide) and VIB (coefficient {module.vib_coefficient}), batch "
        f"{FLAT_BATCH} at {FLAT_HW}x{FLAT_HW}: {SLICE_STEPS} steps, median {ms:.3f} ms/step over steps "
        f"{SLICE_WARMUP + 1}-{SLICE_STEPS} | q1_loss {rows[0]['q1_loss']:.4f} -> {rows[-1]['q1_loss']:.4f}, "
        f"q1_vib_loss {rows[-1]['q1_vib_loss']:.5f} | {changed} tensors changed | jitter_normalize {launches} "
        f"launches ({CQL_LAUNCHES_PER_STEP} a step) | {card}",
        flush=True,
    )
    del module, state, step
    torch.cuda.empty_cache()
    return launches


def _depth_variant(card: str) -> dict:
    """depth_static through DeviceTransforms (configs/transforms/rl.yaml's
    depth_static, gamma noise on) at the production window batch."""
    from tacorl_tpu_torch.config import load_yaml
    from tacorl_tpu_torch.data.transforms import DeviceTransforms

    cfg = {"depth_static": {**load_yaml(f"{CONFIG_DIR}/transforms/rl.yaml")["depth_static"], "gamma_noise": True}}
    g = torch.Generator(device="cuda").manual_seed(3)
    depth = 3.0 + 4.0 * torch.rand((BATCH, WINDOW, RAW_HW, RAW_HW), generator=g, device="cuda")
    transforms = DeviceTransforms(cfg, device="cuda")
    jitter_normalize.launches = shift_jitter_normalize.launches = 0
    out = {}
    for train in (True, False):
        out[train] = transforms({"depth_static": depth}, train=train, generator=g)["depth_static"]
        ms = _time_ms(lambda: transforms({"depth_static": depth}, train=train, generator=g), reps=10, warmup=2)
        x = out[train]
        _check(x.shape == (BATCH, WINDOW, 3, 128, 128) and bool(torch.isfinite(x).all())
               and x.min().item() >= -1.0 and x.max().item() <= 1.0, f"slice_variants/depth train={train}")
        out[f"ms_{train}"] = ms
    launches = jitter_normalize.launches + shift_jitter_normalize.launches
    _check(launches == 0, f"slice_variants/depth: {launches} kernel launches")
    print(
        f"[slice_variants/depth] depth_static float32 {tuple(depth.shape)} -> {tuple(out[True].shape)} (planar, the "
        f"encoder's layout; the JAX package's is (..., 128, 128, 3)), finite, in [-1, 1]: train (resize, DrQ shift, "
        f"gamma noise, jet colormap) {out['ms_True']:.3f} ms, eval {out['ms_False']:.3f} ms a call | kernel "
        f"launches 0 | {card}",
        flush=True,
    )
    return {"jitter_normalize": jitter_normalize.launches, "shift_jitter_normalize": shift_jitter_normalize.launches}


def _encoder_timings(card: str) -> None:
    """ms per forward + backward of each new encoder at (1024, 3, 128, 128)
    in its default bfloat16 convolutions (VectorEncoder on (1024, 39)
    vectors), and of DeepSpatialEncoder / ResNet18Encoder in eval mode."""
    from tacorl_tpu_torch.networks.encoders import VectorEncoder

    x = torch.rand((ENCODER_N, 3, ENCODER_HW, ENCODER_HW), device="cuda") * 2 - 1
    torch.manual_seed(0)
    encoders = {**_variant_encoders(ENCODER_HW, "bfloat16"), "VectorEncoder": VectorEncoder(32, hidden=(256,), in_features=39)}
    lines = []
    for name, enc in encoders.items():
        enc = enc.cuda()
        inp = x if name != "VectorEncoder" else torch.randn((ENCODER_N, 39), device="cuda")
        modes = ("train", "eval") if name in ("DeepSpatialEncoder", "ResNet18Encoder") else ("train",)
        for mode in modes:
            enc.train(mode == "train")

            def fwd_bwd():
                enc.zero_grad(set_to_none=True)
                enc(inp).float().square().mean().backward()

            ms = _time_ms(fwd_bwd, reps=10, warmup=2)
            lines.append(f"{name}{' (eval)' if mode == 'eval' else ''} {ms:.3f}")
        del enc
        torch.cuda.empty_cache()
    print(f"[slice_variants/encoders] ms per forward+backward at ({ENCODER_N}, 3, {ENCODER_HW}, {ENCODER_HW}), "
          f"bf16 convolutions (VectorEncoder at ({ENCODER_N}, 39)): " + ", ".join(lines) + f" | {card}", flush=True)


def phase_slice_variants(card: str) -> dict:
    """The new options at production widths: the Gaussian stage-1 step (and
    its graphed chunk), visual CQL with D2RL/DenseNet and VIB, the depth
    transforms, the encoders' times."""
    t0 = time.perf_counter()
    out = {"gaussian": _gaussian_stage1(card), "cql": _cql_variant(card), "depth": _depth_variant(card)}
    _encoder_timings(card)
    print(f"[slice_variants] took {time.perf_counter() - t0:.1f} s | {card}", flush=True)
    return out


def _loss_drop(tag: str, rows, key: str) -> tuple:
    values = [r[key] for r in rows if key in r]
    _check(len(values) == TRAIN_VARIANT_STEPS and all(np.isfinite(values)), f"{tag}: {len(values)} {key} rows")
    first = statistics.mean(values[:TRAIN_VARIANT_WINDOW])
    last = statistics.mean(values[-TRAIN_VARIANT_WINDOW:])
    _check(last < first, f"{tag}: mean {key} of the last {TRAIN_VARIANT_WINDOW} steps {last} >= first {first}")
    return first, last


def phase_train_variants(card: str, root: str, flat_data: str, flat_pct: float) -> dict:
    """train.main on the card for 200 steps each: play_lmp_fake with the
    Gaussian decoder, cql_fake with a D2RL actor and DenseNet critics; then
    ``tacorl_tpu_torch.evaluate.main`` on the Gaussian run's checkpoint for
    2 short-horizon rollouts (the LSTM carry through a rollout)."""
    from tacorl_tpu_torch import evaluate, train

    t0 = time.perf_counter()
    # both on phase 21's packed flagship set (an unpacked expert-play set's
    # per-frame reads made the loader take about 1 s a batch); no validation
    # and one save at the stop, so the run's time is its steps'
    common = [f"trainer.max_steps={TRAIN_VARIANT_STEPS}", "trainer.log_every_n_steps=1", "~callbacks.rollout",
              "trainer.val_every_n_epochs=1000", "trainer.ckpt_every_n_epochs=1000",
              "ckpt_monitor=validation/total_loss", "ckpt_mode=min"]
    launches, lines = {}, []
    for tag, experiment, extra, data, key in (
        ("gaussian", "play_lmp_fake", ["networks/action_decoder=gaussian"], flat_data, "train/action_loss"),
        ("cql_d2rl_densenet", "cql_fake", ["networks/policy=d2rl", "networks/q_network=densenet",
                                           f"datamodule.train_percentage={flat_pct}"], flat_data, "train/q1_loss"),
    ):
        run = f"{root}/{tag}"
        jitter_normalize.launches = 0
        t1 = time.perf_counter()
        trainer = train.main([f"experiment={experiment}", f"data_dir={data}", f"run_dir={run}", *common, *extra])
        wall = time.perf_counter() - t1
        _check(trainer.device.type == "cuda" and trainer.global_step == TRAIN_VARIANT_STEPS,
               f"train_variants/{tag}: {trainer.global_step} steps on {trainer.device}")
        first, last = _loss_drop(f"train_variants/{tag}", _metrics_rows(run), key)
        launches[tag] = jitter_normalize.launches
        lines.append(f"{tag} ({experiment} {' '.join(e for e in extra if '/' in e)}): {TRAIN_VARIANT_STEPS} "
                     f"steps in {wall:.1f} s, mean {key} first {TRAIN_VARIANT_WINDOW} {first:.4f} -> last "
                     f"{TRAIN_VARIANT_WINDOW} {last:.4f}, jitter_normalize {launches[tag]} launches")
        del trainer
        torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        t1 = time.perf_counter()
        results = evaluate.main([
            f"module_path={root}/gaussian", "epoch=-1", "eval_type=short_horizon", f"data_dir={flat_data}/validation",
            "min_seq_len=1", "max_seq_len=400", "max_rollouts=2", "plan_duration=4", "env.max_episode_steps=24",
            f"filename={tmp}/best.json",
        ])
        eval_s = time.perf_counter() - t1
    _check(bool(results) and all(np.isfinite(r["accuracy"]) for r in results.values()),
           f"train_variants: evaluate results {results}")
    print(f"[train_variants] " + "; ".join(lines) + f" | evaluate epoch=-1 short_horizon on the Gaussian run, 2 "
          f"rollouts, in {eval_s:.1f} s: " + ", ".join(f"{t} {r['accuracy']:.2f}" for t, r in results.items())
          + f" | the phase took {time.perf_counter() - t0:.1f} s | {card}", flush=True)
    return launches


# -- data-parallel training: the process group, the gradient all-reduce in the step graph ----------

DDP_STAGES = {"play_lmp_for_rl": 1, "tacorl": 2}  # the stages and their jitter_normalize launches a step
DDP_STEPS = 12  # train_ddp (b): one epoch of 12 steps at two ranks
DDP_TIMED = (4, 12)  # (b)'s ms/step over steps 5-12 (a sync at both ends, epoch 1)
DDP_TIMEOUT_S = 300  # each spawn of ranks
# (b)'s rows after the first step against one rank's. On an H100 the sound
# run drifts up to 2e-3 (float32 sums in another order, carried on by Adam;
# one gripper prediction of 960 flipped); with rank 1 fed rank 0's rows the
# rows part by 2e-2 to 6e-1 from step 2 on, and with the gradient
# all-reduce skipped after the first step by 1.6e-2 at step 7 of stage 1
# and from step 4 of stage 2 (that fault also parts the ranks' weights)
DDP_ROW_RTOL = 1e-2


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _nccl_kernels(probe) -> int:
    """NCCL's kernels in the device trace of the steps in SCAN_TRACED."""
    from torch.autograd import DeviceType

    events = probe.prof.key_averages()
    ranges = {e.key for e in events if e.device_type == DeviceType.CPU}
    return sum(e.count for e in events if e.device_type == DeviceType.CUDA and e.key not in ranges
               and "nccl" in e.key.lower())


def _ddp_child(spec_path: str) -> int:
    """One rank of a train_ddp run (``python3 chip_smoke.py --ddp-child
    <spec>``): each stage of the spec through train.main, then what the
    parent holds, in ``<out>/rank<r>.json`` (and rank 0's final weights)."""
    import torch.distributed as dist

    from tacorl_tpu_torch import train
    from tacorl_tpu_torch.parallel import mesh

    spec = json.loads(Path(spec_path).read_text())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rank, out = int(os.environ["RANK"]), Path(spec["out"])
    if spec["backend"] == "gloo":  # every rank on the one card (no LOCAL_RANK): train.main keeps this group
        dist.init_process_group("gloo", init_method=f"file://{spec['rendezvous']}", rank=rank,
                                world_size=int(os.environ["WORLD_SIZE"]))
    results = {}
    for stage in spec["stages"]:
        if spec["backend"] == "nccl":
            os.environ["MASTER_PORT"] = str(_free_port())  # train.main makes and leaves a group a stage
        probe = _ScanProbe(trace=stage["trace"], timed=stage["timed"])
        jitter_normalize.launches, all_reduce_mean.calls = 0, 0
        trainer = train.main(stage["args"], callbacks=[probe])
        r = {"step": trainer.global_step, "launches": jitter_normalize.launches, "collectives": all_reduce_mean.calls,
             "ms": probe.ms_per_step(), "writes": [trainer.sink.is_main, trainer.ckpt.is_main],
             "groups": len(getattr(trainer.state.optimizer, "groups", [None])),
             "graph": [trainer.step_graph.captures, trainer.step_graph.replays] if trainer.step_graph else None}
        if stage["trace"]:
            traced = _traced_steps(probe)
            r.update(traced_steps=traced["steps"], traced_jitter=traced["jitter"], nccl=_nccl_kernels(probe),
                     eager_launches=probe.eager_launches, eager_collectives=probe.eager_collectives)
        if stage["kernel_leaves"]:
            batch = trainer._current_batch
            r["frames"] = [list(batch[leaf]["rgb_static"].shape[:-3]) for leaf in stage["kernel_leaves"]]
            r["kernel_err"] = _shard_kernel_check(f"train_ddp/{stage['name']}", probe.module, batch,
                                                  stage["kernel_leaves"])
        if stage["save_params"]:
            torch.save(_params(trainer), out / f"{stage['name']}_params_rank{rank}.pt")
        results[stage["name"]] = r
        del trainer
        torch.cuda.empty_cache()
    if spec["backend"] == "gloo":
        mesh.destroy_distributed()
    (out / f"rank{rank}.json").write_text(json.dumps(results))
    return 0


def _shard_kernel_check(tag: str, module, batch, leaves) -> float:
    """jitter_normalize against its plain version on a rank's own frames (the
    last batch it trained on), resized and shifted to 128x128 bf16 with the
    transform's ranges."""
    cfg = module.transforms.cfg["rgb_static"]
    g = torch.Generator(device="cuda").manual_seed(17)
    pad, size = int(cfg["pad"]), tuple(cfg["size"])
    worst = 0.0
    for leaf in leaves:
        frames = batch[leaf]["rgb_static"]
        frames = frames.reshape((-1,) + tuple(frames.shape[-3:])).movedim(-1, -3).contiguous()
        n = frames.shape[0]
        shifts = torch.randint(0, 2 * pad + 1, (n, 2), generator=g, device="cuda")
        x = image_aug.resize_shift(frames, shifts, size, pad, dtype=torch.bfloat16).contiguous()
        # the transform's ranges, its defaults where the config names none
        f = sample_jitter_factors(n, g, brightness=cfg.get("brightness", 0.1), contrast=cfg.get("contrast", 0.1),
                                  hue=cfg.get("hue", 0.02), prob=cfg.get("jitter_prob", 1.0))
        worst = max(worst, _compare(jitter_normalize(x, f), jitter_normalize_reference(x, f), BF16_ATOL,
                                    f"{tag}: jitter_normalize vs plain on a rank's {leaf} frames"))
    return worst


def _spawn_ranks(tag: str, spec: dict, world: int, env_of, child_flag: str = "--ddp-child") -> list:
    """``world`` ranks of this script in ``--ddp-child`` mode, with the
    launcher's environment (``env_of(rank)`` adds to it); waits for all of
    them, ends them all if one fails or the wait times out, and returns each
    rank's results."""
    out = Path(spec["out"])
    out.mkdir(parents=True, exist_ok=True)
    (out / "spec.json").write_text(json.dumps(spec))
    base = {k: v for k, v in os.environ.items() if k not in ("LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    procs, logs = [], []
    try:
        for r in range(world):
            logs.append(open(out / f"rank{r}.log", "w"))
            env = dict(base, WORLD_SIZE=str(world), RANK=str(r), **env_of(r))
            procs.append(subprocess.Popen([sys.executable, str(Path(__file__).resolve()), child_flag,
                                           str(out / "spec.json")], env=env, stdout=logs[-1],
                                          stderr=subprocess.STDOUT))
        deadline = time.time() + DDP_TIMEOUT_S
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.time()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    failed = [r for r, p in enumerate(procs) if p.returncode != 0]
    if failed:
        tails = "\n".join(f"--- rank {r}:\n" + (out / f"rank{r}.log").read_text()[-3000:] for r in failed)
        raise RuntimeError(f"{tag}: rank(s) {failed} failed (exit codes {[p.returncode for p in procs]})\n{tails}")
    return [json.loads((out / f"rank{r}.json").read_text()) for r in range(world)]


def _rows_without_time(run_dir) -> list:
    return [{k: v for k, v in row.items() if k != "time"} for row in _metrics_rows(run_dir)]


def _ddp_one_rank(card: str, root: str, scan: dict) -> dict:
    """(a) One rank under the launcher's environment, NCCL: both stages as
    phase 31's graphed runs (K = 4), held bit for bit against them."""
    stages = [{"name": e, "args": [a for a in scan[e]["args"] if not a.startswith("run_dir=")]
               + [f"run_dir={root}/w1_{e}"], "trace": True, "timed": list(SCAN_TIMED), "kernel_leaves": [],
               "save_params": True} for e in DDP_STAGES]
    t0 = time.perf_counter()
    res = _spawn_ranks("train_ddp (a)", {"backend": "nccl", "stages": stages, "out": f"{root}/w1"}, 1,
                       lambda r: {"LOCAL_RANK": "0", "MASTER_ADDR": "127.0.0.1"})[0]
    wall = time.perf_counter() - t0
    lines = []
    for e, lps in DDP_STAGES.items():
        r, tag = res[e], f"train_ddp/{e} (a)"
        got_rows, want_rows = _rows_without_time(f"{root}/w1_{e}"), _rows_without_time(scan[e]["dir"])
        _check(got_rows == want_rows, f"{tag}: the one-rank NCCL run's rows are not phase 31's graphed run's")
        params = torch.load(f"{root}/w1/{e}_params_rank0.pt", weights_only=True)
        _check(params.keys() == scan[e]["params"].keys(), f"{tag}: other weights than phase 31's")
        differ = [k for k, v in params.items() if not torch.equal(v, scan[e]["params"][k])]
        _check(not differ, f"{tag}: {len(differ)} weights not phase 31's bit for bit, e.g. {differ[:3]}, by up "
               f"to {max((params[k] - scan[e]['params'][k]).abs().max().item() for k in differ) if differ else 0}")
        _check(r["graph"] == [1, TRAIN_STEPS], f"{tag}: captures and replays {r['graph']}")
        _check(r["traced_jitter"] == lps * r["traced_steps"] and r["eager_launches"] == 0,
               f"{tag}: {r['traced_jitter']} jitter_normalize launches in the trace of {r['traced_steps']} replays")
        # Python issues a step's all-reduces in the two warm-up steps and the
        # capture only; after that each replay runs them from the graph. The
        # rest: one metric sync a logging step, one a validation pass
        per_step, rest = divmod(r["collectives"] - TRAIN_STEPS // SCAN_LOG_EVERY - 2, WARMUP_STEPS + 1)
        _check(rest == 0 and per_step >= (1 if e == "play_lmp_for_rl" else r["groups"]),
               f"{tag}: {r['collectives']} all-reduces from Python")
        _check(r["eager_collectives"] == 1, f"{tag}: {r['eager_collectives']} from Python over steps 5-12")
        lines.append(f"{e}: {len(got_rows)} rows and every weight bit-equal to phase 31's graphed run; "
                     f"{per_step} gradient all-reduce(s) a step captured in the graph ({r['collectives']} from "
                     f"Python in the whole run: {WARMUP_STEPS} warm-up steps and the capture, "
                     f"{TRAIN_STEPS // SCAN_LOG_EVERY} logging steps, 2 validation passes); in the device trace "
                     f"of the replays of steps {SCAN_TRACED[0] + 1}-{SCAN_TRACED[1]}: {r['nccl']} NCCL kernels, "
                     f"{r['traced_jitter']} jitter_normalize launches; {r['ms']:.3f} ms/step over steps "
                     f"{SCAN_TIMED[0] + 1}-{SCAN_TIMED[1]} (phase 31: {scan[e]['ms']:.3f})")
    print(f"[train_ddp] (a) one rank, NCCL, under the launcher's environment, K={SCAN_K}: " + "; ".join(lines)
          + f" | both stages {wall:.1f} s | {card}", flush=True)
    return res


def _ddp_two_ranks(card: str, root: str, scan: dict) -> tuple:
    """(b) Two ranks sharing the one card over gloo, eager (gloo collectives
    cannot be captured), one epoch of each stage on the global batch of 64,
    held against one rank of the same batches run here, every step logged:
    the first step's row within rtol 1e-4 (both start from the same
    weights), every later row within DDP_ROW_RTOL (float32 sums in another
    order, which Adam carries from step to step), the two ranks' weights
    after the epoch bit-equal (one all-reduced gradient, one update) and
    within atol 2.5 lr a step of one rank's. Stage 1's posterior dropout
    is off in both: dropout draws per rank (ROADMAP Queue 3)."""
    drop = ("run_dir=", "trainer.steps_per_call=", "trainer.max_steps=")
    args = {e: [a for a in scan[e]["args"] if not a.startswith(drop)]
            + ["trainer.steps_per_call=1", f"trainer.max_steps={DDP_STEPS}", "trainer.log_every_n_steps=1"]
            + (["module.plan_recognition.dropout_p=0"] if e == "play_lmp_for_rl" else []) for e in DDP_STAGES}
    stages = [{"name": e, "args": args[e] + [f"run_dir={root}/w2_{e}"], "trace": False, "timed": list(DDP_TIMED),
               "kernel_leaves": ["states"] + (["goal"] if e == "tacorl" else []), "save_params": True}
              for e in DDP_STAGES]
    t0 = time.perf_counter()
    res = _spawn_ranks("train_ddp (b)", {"backend": "gloo", "rendezvous": f"{root}/w2/rendezvous",
                                         "stages": stages, "out": f"{root}/w2"}, 2, lambda r: {})
    wall = time.perf_counter() - t0
    from tacorl_tpu_torch import train

    one_ms, lines = {}, []
    for e, lps in DDP_STAGES.items():
        tag = f"train_ddp/{e} (b)"
        probe = _ScanProbe(timed=DDP_TIMED)
        one = train.main(args[e] + [f"run_dir={root}/w2one_{e}"], callbacks=[probe])
        one_ms[e], one_params, lr = probe.ms_per_step(), _params(one), _max_lr(probe.module.cfg)
        del one
        for rank, rr in enumerate(res):
            r = rr[e]
            _check(r["step"] == DDP_STEPS and r["launches"] == lps * DDP_STEPS,
                   f"{tag} rank {rank}: {r['launches']} jitter_normalize launches in {r['step']} steps")
            _check(r["frames"][0] == [64 // 2, 16] and r["writes"] == [rank == 0] * 2,
                   f"{tag} rank {rank}: frames {r['frames']}, writes {r['writes']}")
        rows = _metrics_rows(f"{root}/w2_{e}")
        keys = [(row["step"], tuple(sorted(row))) for row in rows]
        _check(len(keys) == len(set(keys)), f"{tag}: a row written twice")
        first, drift = _hold_ddp_rows(tag, f"{root}/w2_{e}", f"{root}/w2one_{e}")
        params, params1 = (torch.load(f"{root}/w2/{e}_params_rank{r}.pt", weights_only=True) for r in range(2))
        apart = [k for k, v in params.items() if not torch.equal(v, params1[k])]
        _check(not apart, f"{tag}: the ranks' weights differ after {DDP_STEPS} steps: {len(apart)} tensors, e.g. "
               f"{apart[:3]}")
        param_err = _hold_params(tag, params, one_params, lr, DDP_STEPS)
        err = max(r[e]["kernel_err"] for r in res)
        lines.append(f"{e}: the first step's row within {first:.3g} of one rank's (rtol 1e-4), later rows "
                     f"within {max(drift.values()):.3g} (rtol {DDP_ROW_RTOL:g}; steps {_drift_line(drift)}), the "
                     f"ranks' weights bit-equal, within {param_err:.3g} of one rank's at step {DDP_STEPS} (atol "
                     f"{2.5 * lr * DDP_STEPS:.3g}); each rank "
                     f"{res[0][e]['launches']} jitter_normalize launches in {DDP_STEPS} steps on its "
                     f"{'x'.join(map(str, res[0][e]['frames'][0]))} frames, vs plain on its frames max abs err "
                     f"{err:.3g} (atol {BF16_ATOL}); rank 0 alone wrote; {res[0][e]['ms']:.3f} ms/step over steps "
                     f"{DDP_TIMED[0] + 1}-{DDP_TIMED[1]} (one rank: {one_ms[e]:.3f})")
        torch.cuda.empty_cache()
    print(f"[train_ddp] (b) two ranks on the one card, gloo, eager, a global batch of 64 (32 a rank): "
          + "; ".join(lines) + f" | the two ranks' stages {wall:.1f} s | {card}", flush=True)
    return res, one_ms


def _hold_ddp_rows(tag: str, got_dir: str, want_dir: str) -> tuple:
    """Each train and validation row of ``got_dir`` against the row of the
    same step and keys in ``want_dir``: the first step's within rtol 1e-4,
    every later step's within DDP_ROW_RTOL. Returns the first step's
    largest relative difference and each later step's."""
    def kind(row):
        return tuple(sorted(k for k in row if k not in ("step", "time")))

    want = {(r["step"], kind(r)): r for r in _metrics_rows(want_dir)}
    got = [r for r in _metrics_rows(got_dir) if any(k.startswith(("train/", "validation/")) for k in r)]
    errs = {}
    for row in got:
        ref = want.get((row["step"], kind(row)))
        _check(ref is not None, f"{tag}: the one-rank run logged no row like step {row['step']}'s")
        err, key = max((abs(row[k] - ref[k]) / max(abs(ref[k]), 1e-6), k) for k in kind(row))
        errs[row["step"]] = max(err, errs.get(row["step"], 0.0))
        rtol = 1e-4 if row["step"] == 1 else DDP_ROW_RTOL
        _check(err <= rtol, f"{tag}: {key} at step {row['step']} differs from one rank's by {err:.3g} (rtol "
               f"{rtol:g}): {row[key]} vs {ref[key]}")
    _check(min(errs) == 1 and len(errs) > 1, f"{tag}: rows at steps {sorted(errs)}")
    return errs.pop(1), errs


def _drift_line(drift: dict) -> str:
    return ", ".join(f"{s}: {e:.2g}" for s, e in sorted(drift.items()))


def phase_train_ddp(card: str, root: str, scan: dict) -> dict:
    """Data-parallel training through ``python -m tacorl_tpu_torch.train``'s
    entry under a launcher's environment: (a) one rank over NCCL, K = 4,
    bit-equal to phase 31's graphed runs, the gradient all-reduce captured
    in the step graph; (b) two ranks on the one card over gloo, eager, held
    to one rank of the same global batch. NCCL refuses two ranks on one
    card; results/torch_r12_ddp/run.sh runs NCCL at 2 and 4 cards."""
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    one = _ddp_one_rank(card, root, scan)
    two, two_ref = _ddp_two_ranks(card, root, scan)
    print(f"[train_ddp] ms/step, stage 1 / stage 2: (a) one NCCL rank K={SCAN_K} "
          f"{one['play_lmp_for_rl']['ms']:.3f} / {one['tacorl']['ms']:.3f}, phase 31 graphed "
          f"{scan['play_lmp_for_rl']['ms']:.3f} / {scan['tacorl']['ms']:.3f}; (b) two gloo ranks eager "
          f"{two[0]['play_lmp_for_rl']['ms']:.3f} / {two[0]['tacorl']['ms']:.3f}, one rank eager "
          f"{two_ref['play_lmp_for_rl']:.3f} / {two_ref['tacorl']:.3f} | the phase took "
          f"{time.perf_counter() - t0:.1f} s | {card}", flush=True)
    return {
        "launches": {
            **{f"train_ddp/nccl_w1/{e}/steps_{SCAN_TRACED[0] + 1}-{SCAN_TRACED[1]}": one[e]["traced_jitter"]
               for e in DDP_STAGES},
            **{f"train_ddp/gloo_w2/{e}/rank{r}": two[r][e]["launches"] for e in DDP_STAGES for r in range(2)},
        },
        "max_abs_err": max(r[e]["kernel_err"] for r in two for e in DDP_STAGES),
    }


# -- the JAX package's remaining tools on the card ---------------------------------------

TOOL_FRAMES = 1024  # the main path's frames: batch 64 x window 16
TOOL_CPU_FRAMES = 128  # the CPU runs the route on the first frames (it is per image)
TOOL_GRAFT_STEPS = 4  # one logged row at TRAIN_LOG_EVERY
TOOL_TRACE_STEPS = 4
TOOL_REAL_STEPS, TOOL_REAL_PLAN = 10, 5
TOOL_LOSS_RTOL = 1e-4


def _tool_xla_route(card: str) -> dict:
    """(a) The XLA rgb route (``use_pallas: false``) on the main path's 1,024
    frames of 200x200 uint8 -> 128x128 on the card against its CPU run on the
    same draws (float32, atol 2e-5), and its time beside the fused route's."""
    from tacorl_tpu_torch.data.transforms import DeviceTransforms

    rs = np.random.RandomState(5)
    frames = torch.from_numpy(rs.randint(0, 256, (TOOL_FRAMES, RAW_HW, RAW_HW, 3), dtype=np.uint8))
    planar = frames.movedim(-1, -3)
    g = torch.Generator().manual_seed(5)
    shifts = torch.randint(0, 2 * PAD + 1, (TOOL_FRAMES, 2), generator=g)
    draws = image_aug.sample_color_jitter(TOOL_FRAMES, g, prob=0.5)
    dev = {k: v.cuda() for k, v in draws.items()}
    card_out = image_aug.augment_rgb_train(planar.cuda(), shifts.cuda(), (128, 128), PAD, prob=0.5, draws=dev)
    n = TOOL_CPU_FRAMES
    cpu_out = image_aug.augment_rgb_train(planar[:n], shifts[:n], (128, 128), PAD, prob=0.5,
                                          draws={k: v[:n] for k, v in draws.items()})
    err = float((card_out[:n].cpu() - cpu_out).abs().max())
    _check(card_out.shape == (TOOL_FRAMES, 3, 128, 128) and bool(torch.isfinite(card_out).all()),
           "tooling (a): XLA route output")
    _check(err <= F32_ATOL, f"tooling (a): XLA route on the card vs the CPU: max abs err {err}")
    batch = frames.reshape(BATCH, WINDOW, RAW_HW, RAW_HW, 3).cuda()
    rgb = dict(PRODUCTION_CFG["transforms"]["rgb_static"])
    routes = {
        "xla": DeviceTransforms({"rgb_static": {**rgb, "use_pallas": False}}, device="cuda"),
        "fused": DeviceTransforms({"rgb_static": rgb}, device="cuda"),
        "fused_f32": DeviceTransforms({"rgb_static": {**rgb, "aug_dtype": "float32"}}, device="cuda"),
    }
    gen = torch.Generator(device="cuda").manual_seed(0)
    ms = {k: _time_ms(lambda t=t: t({"rgb_static": batch}, generator=gen), reps=10) for k, t in routes.items()}
    print(f"[tooling] (a) XLA rgb route (use_pallas: false) on {TOOL_FRAMES} frames {RAW_HW}x{RAW_HW} uint8 -> "
          f"128x128 float32: the card's first {n} frames vs the CPU's on the same draws, max abs err {err:.3g} "
          f"(atol {F32_ATOL}) | DeviceTransforms on (64, 16, 200, 200, 3): XLA route {ms['xla']:.3f} ms, fused "
          f"route {ms['fused']:.3f} ms (bf16, the CUDA kernel), fused float32 {ms['fused_f32']:.3f} ms | {card}",
          flush=True)
    return {"err": err, **ms}


def _lightning_lmp(root: str):
    """A Lightning-format checkpoint of the production Play-LMP (seed-0
    weights, the decoder's recurrent biases nonzero), its module config,
    and the module the checkpoint holds as it is."""
    cfg = {"_target_": LMP_TARGET, **copy.deepcopy(PRODUCTION_CFG)}
    module = PlayLMPModule(cfg, device="cuda")
    module.init_state(0)
    g = torch.Generator().manual_seed(7)
    sd = {k: v.detach().cpu().clone() for k, v in module.net.state_dict().items()}
    for key in [k for k in sd if k.startswith("action_decoder.rnn.bias_")]:
        sd[key] = 0.05 * torch.randn(sd[key].shape, generator=g)
    module.net.load_state_dict(sd)
    torch.save({"epoch": 0, "global_step": 0, "state_dict": sd}, f"{root}/play_lmp.ckpt")
    with open(f"{root}/module.yaml", "w") as f:
        json.dump({"module": cfg}, f)  # YAML reads JSON
    return f"{root}/play_lmp.ckpt", f"{root}/module.yaml", module


def _eval_loss(module, batch, eps) -> dict:
    module.net.eval()
    with torch.no_grad():
        states = module.transforms(batch["states"], train=False)
        actions = torch.as_tensor(batch["actions"]).cuda()
        _, metrics, _ = module.net.compute_loss(states, actions, 1e-3, eps=eps)
    return {k: float(v) for k, v in metrics.items()}


def _tool_convert(card: str, root: str, train_data: str) -> dict:
    """(b) A Lightning checkpoint of the production Play-LMP converted by
    ``python -m tacorl_tpu_torch.convert_checkpoint``: the forward loss on
    one batch against the unconverted module's, stage 2 grafted from it for
    a few steps (kernel 1 counted), and ``evaluate`` scoring it."""
    from tacorl_tpu_torch import convert_checkpoint, evaluate, train

    ckpt, module_cfg, source = _lightning_lmp(root)
    out = f"{root}/converted"
    t0 = time.perf_counter()
    module, _ = convert_checkpoint.main(["--ckpt", ckpt, "--module-config", module_cfg, "--out", out])
    convert_s = time.perf_counter() - t0
    sd = module.net.state_dict()
    _check(float(sd["action_decoder.rnn.bias_hh_l0"].abs().max()) == 0.0, "tooling (b): bias_hh not folded")
    batch = _batch(8, WINDOW, RAW_HW, seed=3)
    eps = torch.randn((8, PRODUCTION_CFG["latent_plan_dim"]), generator=torch.Generator().manual_seed(3)).cuda()
    want, got = _eval_loss(source, batch, eps), _eval_loss(module, batch, eps)
    for key in ("total_loss", "kl_loss", "action_loss"):
        _check(abs(got[key] - want[key]) <= TOOL_LOSS_RTOL * abs(want[key]),
               f"tooling (b): {key} converted {got[key]} vs unconverted {want[key]}")
    del source, module
    torch.cuda.empty_cache()

    probe = _TrainProbe(measure=False)
    jitter_normalize.launches = 0
    graft_dir = f"{root}/graft"
    trainer = train.main(_train_args("tacorl", train_data, graft_dir, TOOL_GRAFT_STEPS, f"play_lmp_dir={out}"),
                         callbacks=[probe])
    graft_launches = jitter_normalize.launches
    _check(trainer.global_step == TOOL_GRAFT_STEPS and all(n == 2 for n in probe.step_launches),
           f"tooling (b): stage 2 launches a step {probe.step_launches}")
    lmp_sd = torch.load(f"{out}/ckpts/0/state.pt", map_location="cuda", weights_only=True)["net"]
    frozen = trainer.state.net.plan_recognition.state_dict()
    _check(all(torch.equal(frozen[k], lmp_sd[f"plan_recognition.{k}"]) for k in frozen),
           "tooling (b): the grafted posterior is not the converted one")
    rows = [r for r in _metrics_rows(graft_dir) if "train/q1_loss" in r]
    del trainer
    torch.cuda.empty_cache()

    val = f"{root}/val"
    generate_expert_play(val, n_train_episodes=0, n_val_episodes=2, image_hw=ROLLOUT_HW, seed=2)
    jitter_normalize.launches = 0
    results = evaluate.main([
        f"module_path={out}", "eval_type=long_horizon", f"data_dir={val}/validation", "min_seq_len=1",
        "max_seq_len=400", "max_rollouts=2", "lh_tasks_per_rollout=2", "plan_duration=5",
        "env.max_episode_steps=20", f"env.image_hw={ROLLOUT_HW}", f"filename={root}/lh.json",
    ])
    _check(results["num_rollouts"] == 2, f"tooling (b): evaluate scored {results['num_rollouts']} episodes")
    print(f"[tooling] (b) Lightning checkpoint of the production Play-LMP converted in {convert_s:.1f} s: "
          f"recurrent biases folded, forward loss converted vs unconverted on one batch: total "
          f"{got['total_loss']:.6f} vs {want['total_loss']:.6f}, kl {got['kl_loss']:.6f} vs {want['kl_loss']:.6f} "
          f"(rtol {TOOL_LOSS_RTOL}) | experiment=tacorl grafted from it: {TOOL_GRAFT_STEPS} steps, q1_loss "
          f"{rows[-1]['train/q1_loss']:.4f}, jitter_normalize launches {graft_launches} (2 a step) | evaluate "
          f"long_horizon: {results['num_rollouts']} episodes, avg_len {results['avg_len']:.2f} | {card}",
          flush=True)
    return {"launches": graft_launches, "converted": out}


def _tool_tsne(card: str, root: str) -> dict:
    """(c) One stage-1 validation with the t-SNE plan plot, named in the
    config as the JAX package names it, on a set that carries state_info."""
    from tacorl_tpu_torch import train
    from tacorl_tpu_torch.callbacks.tsne_plot import TSNEPlotCallback

    generate_expert_play(f"{root}/play", n_train_episodes=2, n_val_episodes=3, image_hw=64, seed=4)
    jitter_normalize.launches = 0
    trainer = train.main([
        "experiment=play_lmp_fake", f"data_dir={root}/play", f"run_dir={root}/run", "trainer.max_steps=2",
        "callbacks.rollout.every_n_epochs=100",
        "+callbacks.tsne._target_=tacorl_tpu.callbacks.tsne_plot.TSNEPlotCallback",
        "+callbacks.tsne.task_differ._target_=tacorl_tpu.envs.fake_calvin.FakeTasks",
    ])
    cb = next(c for c in trainer.callbacks if isinstance(c, TSNEPlotCallback))
    last = cb.last
    _check(bool(last) and last["device"].startswith("cuda"), f"tooling (c): t-SNE ran on {last.get('device')}")
    _check(Path(last["path"]).is_file() and np.isfinite(last["kl"]), f"tooling (c): t-SNE plot {last}")
    print(f"[tooling] (c) play_lmp_fake validation with TSNEPlotCallback: exact t-SNE of {last['n']} sampled plans "
          f"on {last['device']} in {last['ms']:.1f} ms, final KL {last['kl']:.4f}, 600x600 PNG written | "
          f"jitter_normalize launches {jitter_normalize.launches} (2 train steps) | {card}", flush=True)
    del trainer
    return {"launches": jitter_normalize.launches}


def _tool_trace(card: str, root: str) -> dict:
    """(d) ``utils/profiling.trace`` around four production stage-1 steps:
    the trace file names the jitter_normalize kernel."""
    from tacorl_tpu_torch.utils.profiling import trace

    module, state, step, batch = _production_step()
    state, _ = step(state, batch)
    torch.cuda.synchronize()
    jitter_normalize.launches = 0
    with trace(f"{root}/profile", steps_context="stage1_steps"):
        for _ in range(TOOL_TRACE_STEPS):
            state, metrics = step(state, batch)
    launches = jitter_normalize.launches
    files = list(Path(f"{root}/profile").glob("*.pt.trace.json"))
    _check(len(files) == 1, f"tooling (d): trace files {files}")
    events = json.loads(files[0].read_text())["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel" and "jitter_normalize" in e.get("name", "")
               and "shift_" not in e["name"]]
    span = [e for e in events if e.get("name") == "stage1_steps"]
    _check(bool(span), "tooling (d): the span is not in the trace")
    _check(len(kernels) == TOOL_TRACE_STEPS == launches, f"tooling (d): {len(kernels)} jitter_normalize kernels "
           f"in the trace, {launches} launches; the kernels at "
           f"{[round(e['ts'] - span[0]['ts']) for e in kernels]} us from the span's start, the span "
           f"{round(span[0].get('dur', 0))} us, {sum(e.get('cat') == 'kernel' for e in events)} kernels in all")
    print(f"[tooling] (d) profiling.trace around {TOOL_TRACE_STEPS} production stage-1 steps: "
          f"{files[0].stat().st_size / 1e6:.1f} MB trace, {len(kernels)} jitter_normalize kernels in it "
          f"({kernels[0]['name'][:48]}...), {launches} launches, total_loss {float(metrics['total_loss']):.4f} | "
          f"{card}", flush=True)
    del module, state, step, batch
    torch.cuda.empty_cache()
    return {"launches": launches}


class _StandInRobot:
    """An in-process stand-in for robot_io's RobotEnv: a camera of seeded
    200x200 frames, the robot's 15-wide state, and every action kept."""

    def __init__(self, robot=None, **kwargs):
        rs = np.random.RandomState(0)
        self.steps, self.resets = [], []
        self.robot = type("Robot", (), {"get_state": staticmethod(lambda: np.zeros(15))})()
        self.camera_manager = type("Cameras", (), {"get_images": staticmethod(
            lambda: {"rgb_static": rs.randint(0, 256, (ROLLOUT_HW, ROLLOUT_HW, 3)).astype(np.uint8)})})()

    def reset(self, **kwargs):
        self.resets.append(kwargs)

    def step(self, action):
        self.steps.append(action)
        return None, 0.0, False, {}


@contextlib.contextmanager
def _robot_io_stand_in():
    import types

    made = []

    class RobotEnv(_StandInRobot):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    names = ("robot_io", "robot_io.envs", "robot_io.envs.robot_env")
    saved = {n: sys.modules.get(n) for n in names}
    mods = {n: types.ModuleType(n) for n in names}
    mods["robot_io"].envs, mods["robot_io.envs"].robot_env = mods["robot_io.envs"], mods["robot_io.envs.robot_env"]
    mods["robot_io.envs.robot_env"].RobotEnv = RobotEnv
    sys.modules.update(mods)
    try:
        yield made
    finally:
        for n, m in saved.items():
            if m is None:
                sys.modules.pop(n, None)
            else:
                sys.modules[n] = m


def _tool_real_world(card: str, root: str, converted: str) -> dict:
    """(e) RealWorldEnv over the robot_io stand-in, then one
    ``evaluate_real_world`` rollout of the converted checkpoint on the card."""
    from tacorl_tpu_torch import evaluate_real_world
    from tacorl_tpu_torch.envs.real_world import MAX_REL_ORN, MAX_REL_POS, RealWorldEnv

    with _robot_io_stand_in() as made:
        env = RealWorldEnv(modalities=["rgb_static"])
        obs = env.reset(goal={"rgb_static": np.zeros((ROLLOUT_HW, ROLLOUT_HW, 3), np.uint8)},
                        robot_obs=np.r_[0.1, 0.2, 0.3, 0.0, 0.0, 0.0, np.zeros(8), 1.0])
        env.step(np.array([2.0, 0, 0, 1.0, 0, 0, -0.5]))
        motion = made[0].steps[0]["motion"]
        _check(obs["observation"]["rgb_static"].shape == (ROLLOUT_HW, ROLLOUT_HW, 3)
               and made[0].resets[0]["gripper_state"] == "open"
               and np.allclose(motion[0], [MAX_REL_POS, 0, 0]) and np.allclose(motion[1], [MAX_REL_ORN, 0, 0])
               and motion[2] == -1, "tooling (e): RealWorldEnv")
        import cv2

        goal = f"{root}/goal.png"
        cv2.imwrite(goal, np.random.RandomState(1).randint(0, 256, (ROLLOUT_HW, ROLLOUT_HW, 3)).astype(np.uint8))
        jitter_normalize.launches = 0
        t0 = time.perf_counter()
        out = evaluate_real_world.main([f"module_path={converted}", f"img_path={goal}",
                                        f"plan_duration={TOOL_REAL_PLAN}",
                                        f"env.max_episode_steps={TOOL_REAL_STEPS}"])
        wall = time.perf_counter() - t0
        sent = np.array([np.r_[m["motion"][0], m["motion"][1], m["motion"][2]] for m in made[1].steps])
    _check(out["episode_length"] == TOOL_REAL_STEPS == len(sent) and np.isfinite(sent).all()
           and np.abs(sent[:, :3]).max() <= MAX_REL_POS and np.abs(sent[:, 3:6]).max() <= MAX_REL_ORN,
           f"tooling (e): evaluate_real_world {out}, actions {sent.shape}")
    print(f"[tooling] (e) RealWorldEnv over an in-process robot_io stand-in: reset, scaling and gripper as the "
          f"reference's | evaluate_real_world of the converted Play-LMP on the card: {out['episode_length']} "
          f"robot actions in {wall:.1f} s (plan_duration {TOOL_REAL_PLAN}), largest |rel pos| "
          f"{np.abs(sent[:, :3]).max():.4f} <= {MAX_REL_POS}, jitter_normalize launches "
          f"{jitter_normalize.launches} | {card}", flush=True)
    return {"launches": jitter_normalize.launches}


TOOL_GRAPH_STEPS, TOOL_GRAPH_K = 10, 2  # play_lmp_fake on 8 episodes: 6 steps an epoch, a val pass between


def _tool_graph_after_validation(card: str, root: str) -> dict:
    """(f) The repair of the kl_loss spike of results/torch_r12_ddp/ run
    J: play_lmp_fake (biRNN posterior) at K = 2 as CUDA-graph replays
    across a validation pass, whose rollout callback builds an agent that
    repacks the RNN weights into new buffers (``flatten_parameters``),
    against the eager run with the graph's Adam mode: every row within
    rtol 1e-4, the step graph captured again after the move."""
    from tacorl_tpu_torch import train

    generate_expert_play(f"{root}/play", 8, 2, seed=3)
    common = ["experiment=play_lmp_fake", f"data_dir={root}/play", "seed=42", f"trainer.max_steps={TOOL_GRAPH_STEPS}",
              "trainer.log_every_n_steps=1", "callbacks.rollout.every_n_epochs=100"]
    train.main(common + [f"run_dir={root}/eager"], callbacks=[_Capturable()])
    graphed = train.main(common + [f"run_dir={root}/graphed", f"trainer.steps_per_call={TOOL_GRAPH_K}"])
    graph = graphed.step_graph
    held, worst = _hold_rows("tooling (f)", f"{root}/graphed", f"{root}/eager")
    kl = [r["train/kl_loss"] for r in _metrics_rows(f"{root}/graphed") if "train/kl_loss" in r]
    print(f"[tooling] (f) play_lmp_fake at K={TOOL_GRAPH_K} (graph replays) across a validation pass against the "
          f"eager run: {held} rows within rtol 1e-4 (largest {worst:.3g}), kl_loss {[round(v, 4) for v in kl]}, "
          f"step graph captures {graph.captures} (again after the validation moved the RNN weights), replays "
          f"{graph.replays} | {card}", flush=True)
    del graphed
    torch.cuda.empty_cache()


def phase_tooling(card: str, root: str, train_data: str) -> dict:
    """The JAX package's remaining tools on the card: (a) the XLA rgb route,
    (b) Lightning checkpoint conversion, a graft and evaluate from it, (c)
    the t-SNE plan plot, (d) profiling.trace, (e) the real-robot env and
    evaluate_real_world; and (f) a graphed run across a validation pass.
    Returns kernel 1's launches by path."""
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    for sub in ("b", "c", "d", "e", "f"):
        Path(f"{root}/{sub}").mkdir(parents=True)
    _tool_xla_route(card)
    convert = _tool_convert(card, f"{root}/b", train_data)
    tsne = _tool_tsne(card, f"{root}/c")
    traced = _tool_trace(card, f"{root}/d")
    real = _tool_real_world(card, f"{root}/e", convert["converted"])
    _tool_graph_after_validation(card, f"{root}/f")
    print(f"[tooling] the phase took {time.perf_counter() - t0:.1f} s | {card}", flush=True)
    return {
        f"tooling/graft_tacorl/{TOOL_GRAFT_STEPS}_steps": convert["launches"],
        "tooling/tsne_validation": tsne["launches"],
        f"tooling/trace/{TOOL_TRACE_STEPS}_steps": traced["launches"],
        "tooling/evaluate_real_world": real["launches"],
    }


# -- tensor parallelism: the (dp, mp) mesh and shard_params_by_rule on the card -----------

TP_STEPS = 8
TP_TIMED = (2, 8)  # ms/step over steps 3-8 (a sync after every step)
TP_WORLD = 2  # (dp, mp) = (1, 2): two gloo ranks sharing the card


def _tp_batch(g: int) -> dict:
    """The production batch of step ``g``, drawn on the card from a seed
    (the same on every rank and in the one-rank run)."""
    gen = torch.Generator(device="cuda").manual_seed(1000 + g)
    frames = torch.randint(0, 255, (BATCH, WINDOW, RAW_HW, RAW_HW, 3), generator=gen, device="cuda",
                           dtype=torch.uint8)
    actions = torch.randn((BATCH, WINDOW, 7), generator=gen, device="cuda").clamp(-1, 1)
    return {"states": {"rgb_static": frames}, "actions": actions, "idx": torch.arange(BATCH, device="cuda")}


def _tp_run(module, state, m) -> dict:
    """TP_STEPS eager steps of the production Play-LMP on ``m``'s dp rows
    (the trainer's per-step seeding), then the val step's loss on batch
    100; each row averaged over dp."""
    from tacorl_tpu_torch.core.graphs import seed_generators
    from tacorl_tpu_torch.parallel import mesh

    shard = mesh.batch_sharding(m)
    step, rows, ms = module.make_train_step(), [], []
    for g in range(TP_STEPS):
        batch = mesh.shard_batch(_tp_batch(g), m)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        seed_generators(module, module.device, 0, g)
        with mesh.sharded_draws(shard):
            state, metrics = step(state, batch, module.step_scalars())
        rows.append({k: float(v) for k, v in mesh.sync_metrics(metrics).items()})  # waits for the step
        ms.append((time.perf_counter() - t0) * 1e3)
    return {"rows": rows, "ms": statistics.median(ms[TP_TIMED[0]:TP_TIMED[1]]), "batch": batch,
            "val": _tp_val(module, state, m)}


def _tp_val(module, state, m) -> float:
    from tacorl_tpu_torch.core.graphs import seed_generators
    from tacorl_tpu_torch.parallel import mesh

    seed_generators(module, module.device, 1, 0)
    with mesh.sharded_draws(mesh.batch_sharding(m)):
        metrics, _ = module.make_val_step()(state, mesh.shard_batch(_tp_batch(100), m), module.step_scalars())
    return float(mesh.sync_metrics({"loss": metrics["total_loss"]})["loss"])


def _tp_child(spec_path: str) -> int:
    """One rank of phase train_tp (``python3 chip_smoke.py --tp-child
    <spec>``): the production Play-LMP on a (1, 2) mesh, the four rules
    sharding it, TP_STEPS eager steps, its checkpoint (gathered: the
    unsharded layout); writes what the parent holds to
    ``<out>/rank<r>.json`` and its replicated weights beside it."""
    import torch.distributed as dist

    from tacorl_tpu_torch.parallel import mesh
    from tacorl_tpu_torch.parallel.tensor_parallel import PLAY_LMP_RULES, shard_of, shard_params_by_rule

    spec = json.loads(Path(spec_path).read_text())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rank, out = int(os.environ["RANK"]), Path(spec["out"])
    dist.init_process_group("gloo", init_method=f"file://{spec['rendezvous']}", rank=rank,
                            world_size=int(os.environ["WORLD_SIZE"]))
    m = mesh.create_mesh(dp=1, mp=TP_WORLD)
    module = PlayLMPModule(PRODUCTION_CFG, device="cuda")
    state = module.init_state(0)
    plan = shard_params_by_rule(state.net, m, PLAY_LMP_RULES, optimizer=state.optimizer)
    mesh.replicate(state)
    jitter_normalize.launches = 0
    run = _tp_run(module, state, m)
    launches = jitter_normalize.launches
    err = _shard_kernel_check("train_tp", module, {"states": run["batch"]["states"]}, ["states"])
    CheckpointManager(spec["ckpt"], config={"module": {"_target_": LMP_TARGET, **PRODUCTION_CFG}}).save(TP_STEPS, state)
    torch.save({k: p.detach().cpu() for k, p in state.net.named_parameters() if shard_of(p) is None},
               out / f"replicated_rank{rank}.pt")
    shards = {k: list(p.shape) for k, p in state.net.named_parameters() if shard_of(p) is not None}
    (out / f"rank{rank}.json").write_text(json.dumps({
        "rows": run["rows"], "ms": run["ms"], "val": run["val"], "launches": launches, "kernel_err": err,
        "sharded": sorted(plan), "shards": shards, "mp_index": m.mp_index}))
    mesh.destroy_distributed()
    return 0


def phase_train_tp(card: str, root: str) -> dict:
    """Tensor parallelism: (a) the production Play-LMP at (dp, mp) = (1, 2),
    two gloo ranks sharing the card (NCCL refuses two ranks on one card),
    eager, the JAX dry run's four rules sharding the posterior's fc and
    linear1 and the decoder's heads, TP_STEPS steps held against one
    rank's mp = 1 run of the same weights and batches: the first row
    within rtol 1e-4, later rows within DDP_ROW_RTOL, the replicated
    weights bit-equal on the two ranks, the gathered weights within atol
    2.5 lr a step; (b) the run's checkpoint (the unsharded layout) loaded
    at mp = 1: the same val loss at rtol 1e-4; (c) dryrun_multichip(2) on
    the card. Returns kernel 1's launches a rank and its error on a rank's
    frames."""
    from tacorl_tpu_torch.dryrun import dryrun_multichip

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    out = Path(root)
    spec = {"rendezvous": str(out / "rendezvous"), "out": str(out), "ckpt": str(out / "ckpt")}
    res = _spawn_ranks("train_tp (a)", spec, TP_WORLD, lambda r: {}, child_flag="--tp-child")
    wall = time.perf_counter() - t0
    module = PlayLMPModule(PRODUCTION_CFG, device="cuda")
    state = module.init_state(0)
    jitter_normalize.launches = 0
    one = _tp_run(module, state, None)
    one_launches = jitter_normalize.launches
    one_params = {k: v.detach().cpu() for k, v in state.net.state_dict().items()}
    del module, state
    torch.cuda.empty_cache()
    tag, lr = "train_tp (a)", PRODUCTION_CFG["lr"]
    errs = []
    for g, (row, ref) in enumerate(zip(res[0]["rows"], one["rows"])):
        _check(set(row) == set(ref), f"{tag}: other metrics than one rank's at step {g + 1}")
        err, key = max((abs(row[k] - ref[k]) / max(abs(ref[k]), 1e-6), k) for k in ref)
        rtol = 1e-4 if g == 0 else DDP_ROW_RTOL
        _check(err <= rtol, f"{tag}: {key} at step {g + 1} differs from one rank's by {err:.3g} (rtol {rtol:g}): "
               f"{row[key]} vs {ref[key]}")
        errs.append(err)
    _check(res[0]["rows"] == res[1]["rows"], f"{tag}: the two ranks logged other rows")
    for r, rr in enumerate(res):
        _check(rr["launches"] == TP_STEPS == one_launches,
               f"{tag} rank {r}: {rr['launches']} jitter_normalize launches in {TP_STEPS} steps (one rank: "
               f"{one_launches})")
        _check(len(rr["sharded"]) == 6 and rr["mp_index"] == r, f"{tag} rank {r}: sharded {rr['sharded']}")
    rep = [torch.load(out / f"replicated_rank{r}.pt", weights_only=True) for r in range(TP_WORLD)]
    apart = [k for k, v in rep[0].items() if not torch.equal(v, rep[1][k])]
    _check(not apart and len(rep[0]) > 0, f"{tag}: the replicated weights differ on the two ranks: {apart[:3]}")
    saved = CheckpointManager(spec["ckpt"]).restore()
    _check({k: tuple(v.shape) for k, v in saved["net"].items()} == {k: tuple(v.shape) for k, v in one_params.items()},
           f"{tag}: the checkpoint's tensors are not the unsharded layout")
    param_err = _hold_params(tag, saved["net"], one_params, lr, TP_STEPS)
    # (b) the checkpoint at mp = 1
    module, loaded = load_module_from_checkpoint(spec["ckpt"], device="cuda")
    val1 = _tp_val(module, loaded, None)
    val_err = abs(val1 - res[0]["val"]) / abs(res[0]["val"])
    _check(val_err <= 1e-4, f"train_tp (b): the mp = 2 checkpoint at mp = 1 gives val loss {val1} against "
           f"{res[0]['val']} at mp = 2")
    del module, loaded
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    dry = dryrun_multichip(2)
    dry_s = time.perf_counter() - t1
    _check(dry["mesh"] == {"dp": 1, "mp": 2} and len(dry["sharded"]) == 5, f"train_tp (c): {dry['mesh']}")
    err = max(r["kernel_err"] for r in res)
    print(f"[train_tp] (a) the production Play-LMP at (dp, mp) = (1, 2), two gloo ranks on the one card, "
          f"eager, {TP_STEPS} steps, {len(res[0]['sharded'])} leaves sharded column-parallel ("
          + ", ".join(f"{k} {v}" for k, v in res[0]["shards"].items()) + f"): the first row within {errs[0]:.3g} "
          f"of one rank's mp = 1 run (rtol 1e-4), later rows within {max(errs[1:]):.3g} (rtol {DDP_ROW_RTOL:g}; "
          + ", ".join(f"{g + 2}: {e:.2g}" for g, e in enumerate(errs[1:])) + f"), the replicated weights "
          f"({len(rep[0])} tensors) bit-equal on the two ranks, the gathered weights within {param_err:.3g} of "
          f"one rank's at step {TP_STEPS} (atol {2.5 * lr * TP_STEPS:.3g}); each rank {res[0]['launches']} "
          f"jitter_normalize launches in {TP_STEPS} steps, vs plain on a rank's frames max abs err {err:.3g} "
          f"(atol {BF16_ATOL}); ms/step over steps {TP_TIMED[0] + 1}-{TP_TIMED[1]}: mp = 2 {res[0]['ms']:.3f} "
          f"(rank 1 {res[1]['ms']:.3f}), mp = 1 one rank {one['ms']:.3f} | the ranks {wall:.1f} s | {card}",
          flush=True)
    print(f"[train_tp] (b) the mp = 2 checkpoint loaded at mp = 1: val loss {val1:.6f} against {res[0]['val']:.6f} "
          f"at mp = 2 (relative {val_err:.3g}, rtol 1e-4) | {card}", flush=True)
    print(f"[train_tp] (c) dryrun_multichip(2) on the card: {dry['backend']} ranks, mesh {dry['mesh']}, loss "
          f"{dry['play_lmp']['total_loss']:.4f}, the RL families' steps finite, in {dry_s:.1f} s | the phase took "
          f"{time.perf_counter() - t0:.1f} s | {card}", flush=True)
    return {"launches": {f"train_tp/gloo_mp2/rank{r}": rr["launches"] for r, rr in enumerate(res)},
            "max_abs_err": err, "ms": res[0]["ms"], "one_ms": one["ms"]}


# -- the visual hierarchy's recipes across rollouts, graphed ------------------------------

HIER_K, HIER_EPOCHS, HIER_BATCHES = 8, 3, 16  # stage 2: 3 epochs of 16 batches of 32, 2 chunks each
HIER_TRACED = (8, 16)  # kernel 1 counted in the device trace of the replays of steps 9-16
HIER_NO_MOVE = 1  # after this epoch's firing the weights are put back where the graph reads them
# results/torch_r15_visual/run.sh: stage 1 and stage 2 of the archived recipes
HIER_LMP = ("experiment=play_lmp_fake", "seed=42", "datamodule.batch_size=32", "datamodule.val_percentage=0.2",
            "trainer.steps_per_call=16")
HIER_RL = ("experiment=tacorl_fake", "seed=42", "callbacks.rollout_lh.every_n_epochs=4",
           "datamodule.dataset.goal_sampling_prob=0.4",
           "datamodule.dataset.goal_strategy_prob.geometric=0.7",
           "datamodule.dataset.goal_strategy_prob.similar_robot_obs=0.3")


class _ReplayTrace(Callback):
    """torch.profiler over the chunks that end after ``start`` up to
    ``stop``, and the wrapper's own launches over the same span. The
    profiler warms up and settles at the window's edges as
    ``utils/profiling.py:trace`` does: its device trace can lose its first
    kernel records (ROADMAP Queue 3)."""

    def __init__(self, start: int, stop: int):
        self.start, self.stop = start, stop
        self.prof = None

    def on_train_batch_end(self, trainer, module, metrics, step):
        from torch.profiler import ProfilerActivity, profile

        from tacorl_tpu_torch.utils.profiling import WARMUP_KERNELS, _settle

        if step == self.stop:
            _settle()
            self.prof.__exit__(None, None, None)
            self.eager_launches = jitter_normalize.launches - self.eager_launches
        if step == self.start:
            torch.cuda.synchronize()
            self.eager_launches = jitter_normalize.launches
            self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            self.prof.__enter__()
            warm = torch.zeros(1, device="cuda")
            for _ in range(WARMUP_KERNELS):
                warm.add_(1)
            _settle()


class _NoMoveFiring(Callback):
    """After the firings of epoch ``epoch``, puts every parameter and buffer
    of the net that a rollout agent's ``flatten_parameters()`` moved back
    into the storage it held when that epoch's last chunk trained, with its
    values: the path of the full stage-2 run's epochs 0 and 4, where
    ``rollout``'s agent moved the RNN weights and ``rollout_lh``'s moved
    them back (results/torch_r16_stage2_hold/). The graph then replays
    across a firing after which no parameter moved. Runs after the rollout
    callbacks (``train.main`` appends it); the eager twin runs it too, so
    both runs move the same values through the same storage."""

    def __init__(self, epoch: int):
        self.epoch, self.kept, self.moved = epoch, [], None

    @staticmethod
    def _tensors(trainer):
        net = trainer.state.net
        return list(net.parameters()) + list(net.buffers())

    def on_train_batch_end(self, trainer, module, metrics, step):
        self.kept = [t.data for t in self._tensors(trainer)]  # holds the storage the graph reads

    @torch.no_grad()
    def on_validation_end(self, trainer, module, metrics, outputs, epoch):
        if epoch != self.epoch:
            return
        tensors = self._tensors(trainer)
        self.moved = sum(t.data_ptr() != k.data_ptr() for t, k in zip(tensors, self.kept))
        for t, k in zip(tensors, self.kept):
            if t.data_ptr() != k.data_ptr():
                k.copy_(t.data)
                t.data = k
        graph = trainer.step_graph
        if graph is not None:
            from tacorl_tpu_torch.core.graphs import _addresses

            _check(_addresses(trainer.state) == graph.addresses,
                   f"train_hierarchy: the weights are not back at the capture's addresses after epoch {epoch}")


def _hierarchy_data(root: str) -> tuple:
    """The flagship recipe at 10 train and 4 validation episodes
    (``make_flagship_data``); returns its root and the train_percentage
    that makes an epoch HIER_BATCHES batches of 32."""
    from tacorl_tpu_torch import make_flagship_data
    from tacorl_tpu_torch.data.datamodule import BasicDataModule
    from tacorl_tpu_torch.train import CONFIG_DIR

    make_flagship_data.main(f"{root}/play", n_train_episodes=10, n_val_episodes=4)
    cfg = compose(CONFIG_DIR, "train", [*HIER_RL, f"data_dir={root}/play", "play_lmp_dir=unused"])
    dm_cfg = {k: v for k, v in cfg["datamodule"].items() if k != "_target_"}
    dm = BasicDataModule(**dm_cfg)
    dm.setup()
    n = len(dm.train_dataset)
    _check(n >= HIER_BATCHES * 32, f"train_hierarchy: {n} windows")
    return f"{root}/play", (HIER_BATCHES * 32 + 0.5) / n


def phase_train_hierarchy(card: str, root: str) -> dict:
    """The visual hierarchy's recipes (results/torch_r15_visual/run.sh) on
    a cut flagship set: play_lmp_fake for one chunk of 16 graph replays,
    then tacorl_fake grafted from it at K = 8 for 3 epochs (2 BC epochs,
    then CQL), ``rollout`` firing after every epoch and ``rollout_lh``
    after the first, against the eager run with capturable Adam: every row
    within rtol 1e-4, the weights within atol 2.5 lr a step; the step
    graph's captures, and a replay across a firing after which no parameter
    moved (``_NoMoveFiring`` after epoch 1, so the CQL epoch 2 replays the
    graph captured before it); kernel 1 twice a replayed step in the device trace
    of steps 9-16, and against its plain version on the graphed run's own
    frames. Returns kernel 1's launches and its error."""
    from tacorl_tpu_torch import train

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    data, pct = _hierarchy_data(root)
    cut = [f"data_dir={data}", f"datamodule.train_percentage={pct}"]
    lmp = train.main([*HIER_LMP, *cut, f"run_dir={root}/lmp", f"trainer.max_steps={HIER_BATCHES}", "~callbacks.rollout"])
    _check(lmp.step_graph.replays == HIER_BATCHES, f"train_hierarchy: stage 1 {lmp.step_graph.replays} replays")
    del lmp
    common = [*HIER_RL, *cut, f"play_lmp_dir={root}/lmp", f"trainer.max_epochs={HIER_EPOCHS}",
              f"trainer.log_every_n_steps={HIER_K}", "callbacks.rollout.num_rollouts_per_task=1",
              "callbacks.rollout_lh.num_rollouts=2"]
    t1 = time.perf_counter()
    eager = train.main(common + [f"run_dir={root}/eager"], callbacks=[_Capturable(), _NoMoveFiring(HIER_NO_MOVE)])
    eager_s, eager_params = time.perf_counter() - t1, _params(eager)
    del eager
    torch.cuda.empty_cache()
    probe, no_move = _ReplayTrace(*HIER_TRACED), _NoMoveFiring(HIER_NO_MOVE)
    t1 = time.perf_counter()
    with _logged() as lines:
        graphed = train.main(common + [f"run_dir={root}/graphed", f"trainer.steps_per_call={HIER_K}"],
                             callbacks=[probe, no_move])
    graphed_s = time.perf_counter() - t1
    tag, graph = "train_hierarchy", graphed.step_graph
    steps = HIER_EPOCHS * HIER_BATCHES
    _check(graphed.global_step == steps == graph.replays, f"{tag}: {graph.replays} replays in {graphed.global_step} steps")
    held, worst = _hold_rows(tag, f"{root}/graphed", f"{root}/eager")
    lr = _max_lr(graph.module.cfg)
    param_err = _hold_params(tag, _params(graphed), eager_params, lr, steps)
    rows = _metrics_rows(f"{root}/graphed")
    evals = [(r["step"], r["val_accuracy"]) for r in rows if "val_accuracy" in r]
    lh = [r["step"] for r in rows if "LH_2_accuracy" in r]
    _check([s for s, _ in evals] == [HIER_BATCHES * (e + 1) for e in range(HIER_EPOCHS)] and lh == [HIER_BATCHES],
           f"{tag}: rollouts at {evals}, rollout_lh at {lh}")
    epoch_lines = [m for m in lines if re.match(r"epoch \d+: ", m)]
    captures = [int(re.search(r"captures (\d+)", m).group(1)) for m in epoch_lines]
    _check(len(captures) == HIER_EPOCHS and captures[0] == 1 and captures[-1] == graph.captures
           and captures == sorted(captures), f"{tag}: captures at the epoch ends {captures}, {graph.captures} in all")
    # the CQL epoch after HIER_NO_MOVE's firing replayed the graph captured before it
    _check(no_move.moved is not None and captures[HIER_NO_MOVE + 1] == captures[HIER_NO_MOVE],
           f"{tag}: epoch {HIER_NO_MOVE + 1} captured again across the firing that moved nothing: {captures}")
    want_lh = [{k: v for k, v in r.items() if k != "time"} for r in _metrics_rows(f"{root}/eager") if "LH_2_accuracy" in r]
    _check([{k: v for k, v in r.items() if k != "time"} for r in rows if "LH_2_accuracy" in r] == want_lh,
           f"{tag}: rollout_lh rows differ from the eager run's: {want_lh}")
    traced = _jitter_in_trace(probe.prof.key_averages())
    n_traced = HIER_TRACED[1] - HIER_TRACED[0]
    _check(probe.eager_launches == 0 and traced == 2 * n_traced,
           f"{tag}: {traced} jitter_normalize launches in the trace of {n_traced} replays, {probe.eager_launches} eager")
    err = _scan_kernel_check(tag, graphed, ("states", "goal"))
    loss = [round(r["train/action_loss"], 4) for r in rows if "train/action_loss" in r]
    print(f"[{tag}] play_lmp_fake (16 replays) -> tacorl_fake grafted from it at K={HIER_K} on the cut flagship set "
          f"({HIER_EPOCHS} epochs of {HIER_BATCHES} batches of 32, bc_epochs 2), rollout after every epoch "
          f"(val_accuracy {evals}), rollout_lh after epoch 0 | against the eager run with capturable Adam: {held} "
          f"rows within rtol 1e-4 (largest {worst:.3g}), weights at step {steps} within {param_err:.3g} (atol "
          f"{2.5 * lr * steps:.3g}) | step graph captures at the epoch ends {captures}, {graph.replays} replays; "
          f"after epoch {HIER_NO_MOVE}'s firing {no_move.moved} tensors put back at the capture's addresses, and "
          f"epoch {HIER_NO_MOVE + 1} (CQL) replayed across it | "
          f"train/action_loss {loss} | jitter_normalize {traced} launches in the device trace of the replays of "
          f"steps {HIER_TRACED[0] + 1}-{HIER_TRACED[1]} (2 a step; the wrapper counted {probe.eager_launches} there), "
          f"vs plain on the graphed run's frames max abs err {err:.3g} (atol {BF16_ATOL}) | train.main eager "
          f"{eager_s:.1f} s, graphed {graphed_s:.1f} s | the phase took {time.perf_counter() - t0:.1f} s | {card}",
          flush=True)
    del graphed
    torch.cuda.empty_cache()
    return {"launches": {f"train_hierarchy/tacorl_fake/steps_{HIER_TRACED[0] + 1}-{HIER_TRACED[1]}": traced},
            "max_abs_err": err}


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
    launches_tacorl, tacorl_ms, run_tacorl, trained = phase_slice_tacorl(card)
    phase_profile(
        run_tacorl, tacorl_ms, tag="profile_tacorl", stages=("tacorl/", "cql/")
    )
    del run_tacorl
    phase_reference_rollout()
    with tempfile.TemporaryDirectory() as tmp:
        data_dir = _expert_validation(tmp)
        rollout = phase_rollout(card, data_dir)
        torch.cuda.empty_cache()
        rollout_tacorl = phase_rollout_tacorl(card, data_dir, *trained)
    del trained
    torch.cuda.empty_cache()
    phase_reference_train()
    # the runs of phases 16-30 stay until phase 28 scores them and phase 31
    # repeats them at K > 1
    with tempfile.TemporaryDirectory() as tmp:
        train_data = _train_data(tmp)
        launches_train = phase_train(card, train_data, f"{tmp}/lmp", step_ms)
        phase_train_resume(card, train_data, f"{tmp}/lmp")
        launches_train_tacorl = phase_train_tacorl(card, train_data, f"{tmp}/lmp", f"{tmp}/tacorl", tacorl_ms)
        with tempfile.TemporaryDirectory() as tmp2:
            phase_train_callback(card, tmp2)
        phase_reference_cql()
        flat_data, pct = _flat_train_data(tmp)
        launches_cql = phase_train_cql(card, flat_data, pct, f"{tmp}/cql")
        launches_cql_state = phase_train_cql_state(card, flat_data, pct, f"{tmp}/cql_state")
        phase_reference_d4rl()
        Path(f"{tmp}/d4rl").mkdir()
        launches_d4rl, d4rl_runs = phase_train_d4rl(card, f"{tmp}/d4rl")
        rollout_d4rl = phase_rollout_d4rl(card, d4rl_runs)
        phase_reference_ril()
        launches_ril = phase_train_ril(card, train_data, flat_data, pct, tmp)
        rollout_ril = phase_rollout_ril(card, flat_data, tmp)
        phase_reference_online()
        launches_online, online_kernel = phase_train_online(card, f"{tmp}/online")
        # the eager runs of phases 16, 18, 24, 27 and 30 are the references
        scan = phase_train_scan(card, f"{tmp}/scan", flat_data, pct)
        phase_reference_variants()
        variants = phase_slice_variants(card)
        launches_variants = phase_train_variants(card, f"{tmp}/variants", flat_data, pct)
        ddp = phase_train_ddp(card, f"{tmp}/ddp", scan)
        tooling = phase_tooling(card, f"{tmp}/tooling", train_data)
        Path(f"{tmp}/tp").mkdir()
        tp = phase_train_tp(card, f"{tmp}/tp")
        Path(f"{tmp}/hierarchy").mkdir()
        hierarchy = phase_train_hierarchy(card, f"{tmp}/hierarchy")
    kernel["launches"] = launches_tacorl
    kernel["launches_by_path"] = {
        "slice": launches_lmp, "slice_tacorl": launches_tacorl,
        "rollout": rollout["jitter_normalize"], "rollout_tacorl": rollout_tacorl["jitter_normalize"],
        "train": launches_train, "train_tacorl": launches_train_tacorl,
        "train_cql": launches_cql, "train_cql_state": launches_cql_state,
        "train_d4rl": launches_d4rl["jitter_normalize"], "rollout_d4rl": rollout_d4rl["jitter_normalize"],
        "train_ril": launches_ril["ril"]["jitter_normalize"],
        "train_ril_state": launches_ril["ril_fake_state"]["jitter_normalize"],
        "rollout_ril": rollout_ril["jitter_normalize"],
        **{f"train_online/{e}": n["jitter_normalize"] for e, n in launches_online.items()},
        # counted in the device trace of the run's own graph replays of steps 5-12
        **{f"train_scan/{e}/steps_{SCAN_TRACED[0] + 1}-{SCAN_TRACED[1]}": v["launches"]
           for e, v in scan.items()},
        "slice_variants/gaussian": variants["gaussian"]["eager"],
        # counted in the device trace of K replays of the graphed Gaussian step
        f"slice_variants/gaussian_graph/{VARIANT_K}_replays": variants["gaussian"]["graph"],
        "slice_variants/cql": variants["cql"], "slice_variants/depth": variants["depth"]["jitter_normalize"],
        **{f"train_variants/{e}": n for e, n in launches_variants.items()},
        # (a) counted in the device trace of the rank's graph replays of steps 5-12; (b) by the wrapper, a rank's
        **ddp["launches"],
        **tooling,
        # by the wrapper, a rank's, in the TP_STEPS steps of the (1, 2) mesh
        **tp["launches"],
        # counted in the device trace of the graphed stage-2 run's replays of steps 9-16
        **hierarchy["launches"],
    }
    kernel["max_abs_err_train_ddp"] = ddp["max_abs_err"]
    kernel["max_abs_err_train_tp"] = tp["max_abs_err"]
    kernel["max_abs_err_train_hierarchy"] = hierarchy["max_abs_err"]
    kernel["max_abs_err_train_scan"] = max(v["kernel_err"] for v in scan.values())
    first = online_kernel[ONLINE_VISUAL[0]]
    kernel.update(
        max_abs_err_online_n256=max(k[256] for k in online_kernel.values()),
        max_abs_err_online_n1=max(k[1] for k in online_kernel.values()),
        ms_n1=first["ms_n1"], plain_ms_n1=first["plain_ms_n1"], bound_ms_n1=first["bound_ms_n1"],
        bound_by_n1=first["bound_by_n1"], geometry_n1=first["geometry_n1"],
    )
    shift["launches_by_path"] = {
        "augment": shift["launches"], "rollout": rollout["shift_jitter_normalize"],
        "rollout_tacorl": rollout_tacorl["shift_jitter_normalize"],
        "train_d4rl": launches_d4rl["shift_jitter_normalize"],
        "rollout_d4rl": rollout_d4rl["shift_jitter_normalize"],
        "train_ril": launches_ril["ril"]["shift_jitter_normalize"],
        "train_ril_state": launches_ril["ril_fake_state"]["shift_jitter_normalize"],
        "rollout_ril": rollout_ril["shift_jitter_normalize"],
        **{f"train_online/{e}": n["shift_jitter_normalize"] for e, n in launches_online.items()},
        "slice_variants/depth": variants["depth"]["shift_jitter_normalize"],
    }
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
    if sys.argv[1:2] == ["--ddp-child"]:
        sys.exit(_ddp_child(sys.argv[2]))
    if sys.argv[1:2] == ["--tp-child"]:
        sys.exit(_tp_child(sys.argv[2]))
    sys.exit(main())
