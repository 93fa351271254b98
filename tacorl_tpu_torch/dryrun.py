"""The multi-rank dry run (port of ``__graft_entry__.py:dryrun_multichip``
and ``_dryrun_rl_families``): one training step of the tiny Play-LMP on a
``(dp, mp)`` mesh of ``n`` ranks, mp = 2 when ``n`` is even and > 1, with
the JAX package's four model-parallel rules (``PLAY_LMP_RULES``: the
posterior's ``fc`` and ``linear1``, the decoder's three mixture heads,
column-parallel) and the batch dp-sharded; then one dp-sharded step each
of CQL, RIL, online SAC and TACO-RL, replicated over mp, TACO-RL's grafted
frozen encoder checked unchanged.

The ranks are processes (``torch.multiprocessing``, a file store):
gloo on the CPU (``device="cpu"``), NCCL over ``n`` cards, and gloo ranks
sharing one card when the host has fewer than ``n`` (NCCL refuses two
ranks on one card). Rank 0's results come back to the caller, which prints
``dryrun_multichip OK: mesh=... loss=... grad_norm=...`` and a line a
family, as the JAX function does; a failed check raises.

    python -m tacorl_tpu_torch.dryrun --n-devices 4 [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import math
import tempfile
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as multiprocessing

from tacorl_tpu_torch.core.checkpoint import CheckpointManager
from tacorl_tpu_torch.core.graphs import seed_generators
from tacorl_tpu_torch.parallel import mesh as mesh_lib
from tacorl_tpu_torch.parallel.tensor_parallel import PLAY_LMP_RULES, shard_of, shard_params_by_rule
from tacorl_tpu_torch.utils import resolve_device

__all__ = ["dryrun_multichip", "main"]

ENCODER = "tacorl_tpu.networks.encoders.LMPVisionEncoder"


# -- the JAX dry run's modules and batches, in the port --------------------------------


def _module(device, tiny: bool = True):
    """``__graft_entry__._module``: the Play-LMP at tiny or production
    widths."""
    from tacorl_tpu_torch.modules.play_lmp import PlayLMPModule

    if tiny:
        enc = {"latent_dim": 16, "hidden_dim": 32}
        pr = {"num_heads": 4, "num_layers": 1, "encoder_hidden_size": 32, "fc_hidden_size": 32,
              "max_position_embeddings": 8}
        ad = {"hidden_size": 32, "num_layers": 1, "n_mixtures": 4}
        size, pad = [48, 48], 2
    else:
        enc = {"latent_dim": 32, "hidden_dim": 256}
        pr = {"num_heads": 8, "num_layers": 2, "encoder_hidden_size": 2048, "fc_hidden_size": 4096,
              "max_position_embeddings": 16}
        ad = {"hidden_size": 2048, "num_layers": 2, "n_mixtures": 10, "bf16_matmul": False}
        size, pad = [128, 128], 6
    cfg = {
        "lr": 1e-4,
        "kl_beta": 1e-3,
        "latent_plan_dim": 16,
        "plan_proposal_obs_modalities": ["rgb_static"],
        "plan_proposal_goal_modalities": ["rgb_static"],
        "plan_recognition_modalities": ["rgb_static"],
        "action_decoder_modalities": ["rgb_static"],
        "perceptual_encoder": {"networks": {"rgb_static": {"_target_": ENCODER, **enc}}},
        "goal_encoder": {"hidden_size": 32 if tiny else 256},
        "plan_recognition": pr,
        "plan_proposal": {"policy": {"num_layers": 2, "hidden_dim": 32 if tiny else 256}},
        "action_decoder": ad,
        "transforms": {"rgb_static": {"kind": "rgb", "size": size, "pad": pad,
                                      **({} if tiny else {"aug_dtype": "bfloat16"})}},
    }
    return PlayLMPModule(cfg, device=device)


def _batch(b: int, t: int, hw: int, seed: int = 0) -> dict:
    rs = np.random.RandomState(seed)
    return {
        "states": {"rgb_static": rs.randint(0, 255, (b, t, hw, hw, 3), dtype=np.uint8)},
        "actions": np.clip(rs.randn(b, t, 7), -1, 1).astype(np.float32),
        "idx": np.arange(b, dtype=np.int64),
        "window_size": np.full((b,), t, dtype=np.int64),
    }


def _encoder(latent_dim: int = 8, hidden_dim: int = 16) -> dict:
    return {"networks": {"rgb_static": {"_target_": ENCODER, "latent_dim": latent_dim, "hidden_dim": hidden_dim}}}


TINY_RGB = {"rgb_static": {"kind": "rgb", "size": [48, 48], "pad": 2}}


def _cql_module(device):
    from tacorl_tpu_torch.modules.cql import CQLModule

    return CQLModule({
        "action_dim": 7, "actor_lr": 1e-3, "critic_lr": 1e-3,
        "obs_modalities": ["rgb_static"], "goal_modalities": ["rgb_static"],
        "actor_encoder": _encoder(), "critic_encoder": _encoder(), "goal_encoder": {"hidden_size": 16},
        "policy": {"num_layers": 2, "hidden_dim": 16, "discrete_gripper": True},
        "q_network": {"num_layers": 2, "hidden_dim": 16},
        "n_action_samples": 3, "with_lagrange": True, "reward_scale": 10.0, "bc_epochs": 0,
        "transforms": TINY_RGB,
    }, device=device)


def _cql_batch(b: int, hw: int = 48, seed: int = 0) -> dict:
    rs = np.random.RandomState(seed)

    def img():
        return rs.randint(0, 255, (b, hw, hw, 3), dtype=np.uint8)

    obs = {"observation": {"rgb_static": img()}, "goal": {"rgb_static": img()}}
    return {
        "observations": obs,
        "actions": np.clip(rs.randn(b, 7), -1, 1).astype(np.float32),
        "next_observations": {"observation": {"rgb_static": img()}, "goal": obs["goal"]},
        "rewards": (rs.rand(b) > 0.8).astype(np.float32),
        "terminals": (rs.rand(b) > 0.8).astype(np.float32),
    }


def _tacorl_module(device, lmp_dir: str):
    """A tiny Play-LMP saved to ``lmp_dir`` (every rank calls the save, rank
    0 writes), then TACO-RL grafted from it."""
    from tacorl_tpu_torch.modules.tacorl import TACORLModule

    lmp = _module(device)
    lmp_cfg = {"_target_": "tacorl_tpu.modules.play_lmp.PlayLMPModule", **lmp.cfg}
    CheckpointManager(lmp_dir, config={"module": lmp_cfg}).save(0, lmp.init_state(0))
    return TACORLModule({
        "play_lmp_dir": str(lmp_dir), "finetune_action_decoder": True, "action_decoder_lr": 1e-3,
        "actor_lr": 1e-3, "critic_lr": 1e-3, "n_action_samples": 3, "with_lagrange": True,
        "reward_scale": 10.0, "q_network": {"num_layers": 2, "hidden_dim": 16}, "transforms": TINY_RGB,
    }, device=device)


def _ril_module(device):
    from tacorl_tpu_torch.modules.ril import RILModule

    return RILModule({
        "lr": 1e-3, "action_dim": 7,
        "high_level_policy_modalities": ["rgb_static"], "low_level_policy_modalities": ["rgb_static"],
        "perceptual_encoder": _encoder(), "goal_encoder": {"out_features": 8, "hidden_size": 16},
        "high_level_policy": {"num_layers": 2, "hidden_dim": 16},
        "low_level_policy": {"num_layers": 2, "hidden_dim": 16},
        "transforms": TINY_RGB,
    }, device=device)


def _ril_batch(b: int, hw: int = 48, seed: int = 7) -> dict:
    rs = np.random.RandomState(seed)

    def img():
        return rs.randint(0, 255, (b, hw, hw, 3), dtype=np.uint8)

    return {
        "obs": {"rgb_static": img()},
        "low_level_goal": {"rgb_static": img()},
        "low_level_action": np.clip(rs.randn(b, 7), -1, 1).astype(np.float32),
        "high_level_goal": {"rgb_static": img()},
        "high_level_action": {"rgb_static": img()},
    }


def _sac_module_and_batch(device, b: int):
    """Online SAC with its env attached and its buffer warm-filled; the
    batch is one global sample of it."""
    from tacorl_tpu_torch.envs.fake_calvin import FakeCalvinEnv
    from tacorl_tpu_torch.modules.sac import SACModule

    module = SACModule({
        "action_dim": 7, "actor_lr": 1e-3, "critic_lr": 1e-3,
        "obs_modalities": ["rgb_static"], "goal_modalities": ["rgb_static"],
        "actor_encoder": _encoder(), "critic_encoder": _encoder(), "goal_encoder": {"hidden_size": 16},
        "policy": {"num_layers": 2, "hidden_dim": 16}, "q_network": {"num_layers": 2, "hidden_dim": 16},
        "warm_start_steps": max(2 * b, 16), "replay_buffer_size": 1000, "transforms": TINY_RGB,
    }, device=device)
    module.attach_env(FakeCalvinEnv(image_hw=48, max_episode_steps=10))
    module.populate(None)
    return module, module.replay_buffer.sample(b, np.random.default_rng(0))


# -- one rank --------------------------------------------------------------------------


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return torch.as_tensor(tree).to(device)


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"dryrun_multichip: {msg}")


def _step(module, state, batch, mesh, device, seed: int, keys) -> Dict[str, float]:
    """One train step of ``module`` on this rank's dp rows of ``batch``;
    the step's metrics averaged over dp, ``keys`` checked finite."""
    local = _to(mesh_lib.shard_batch(batch, mesh), device)
    seed_generators(module, device, seed, int(state.step))
    step0 = int(state.step)
    with mesh_lib.sharded_draws(mesh_lib.batch_sharding(mesh)):
        state, metrics = module.make_train_step()(state, local, module.step_scalars())
    _check(int(state.step) == step0 + 1, f"{module.name}: the step count did not move")
    metrics = {k: float(v) for k, v in mesh_lib.sync_metrics(metrics).items()}
    for key in keys:
        _check(math.isfinite(metrics[key]), f"{module.name}: {key} = {metrics[key]}")
    return metrics


def _replicated_agree(net, mesh) -> int:
    """The parameters no rule sharded, bit-equal on every rank of this
    rank's mp group; returns how many were compared."""
    whole = [p.detach().reshape(-1) for p in net.parameters() if shard_of(p) is None]
    flat = torch.cat(whole)
    parts = [torch.empty_like(flat) for _ in range(mesh.mp)]
    dist.all_gather(parts, flat, group=mesh.mp_group)
    _check(all(torch.equal(parts[0], x) for x in parts), "the mp ranks of a row hold other replicated weights")
    return len(whole)


def _rank(r: int, n: int, backend: str, device_kind: str, root: str) -> None:
    if device_kind == "cpu":
        torch.set_num_threads(1)  # n ranks share the host's cores
        device = torch.device("cpu")
    else:
        device = resolve_device(torch.device("cuda", r if backend == "nccl" else 0))
        torch.cuda.set_device(device)
    kwargs = {"device_id": device} if backend == "nccl" else {}
    dist.init_process_group(backend, init_method=f"file://{root}/rendezvous", rank=r, world_size=n,
                            timeout=mesh_lib.GROUP_TIMEOUT, **kwargs)
    try:
        mp = 2 if n % 2 == 0 and n > 1 else 1
        mesh = mesh_lib.create_mesh(mp=mp)
        _check(mesh.dp * mesh.mp == n, f"mesh {mesh.shape} of {n} ranks")
        module = _module(device)
        state = module.init_state(0)
        sharded = []
        if mp > 1:
            plan = shard_params_by_rule(state.net, mesh, PLAY_LMP_RULES, optimizer=state.optimizer)
            sharded = sorted(plan)
        mesh_lib.replicate(state)
        out = {"mesh": mesh.shape, "sharded": sharded, "backend": backend}
        out["play_lmp"] = _step(module, state, _batch(2 * n, 8, 48), mesh, device, 0, ("total_loss", "grad_norm"))
        out["replicated_compared"] = _replicated_agree(state.net, mesh) if mp > 1 else 0
        del module, state
        out.update(_rl_families(mesh, device, n, Path(root) / "lmp"))
        if r == 0:
            (Path(root) / "result.json").write_text(json.dumps(out))
    finally:
        mesh_lib.destroy_distributed()


def _rl_families(mesh, device, n: int, lmp_dir: Path) -> Dict[str, dict]:
    """One dp-sharded step of CQL, RIL, online SAC and TACO-RL, replicated
    over mp."""

    def run(module, batch, keys=("q1_loss", "actor_loss")):
        state = module.init_state(1)
        mesh_lib.replicate(state)
        return module, state, _step(module, state, batch, mesh, device, 1, keys)

    out = {"cql": run(_cql_module(device), _cql_batch(2 * n))[2]}
    out["ril"] = run(_ril_module(device), _ril_batch(2 * n), ("total_loss", "low_level_loss", "high_level_loss"))[2]
    sac, sac_batch = _sac_module_and_batch(device, 2 * n)
    out["sac"] = run(sac, sac_batch)[2]
    module = _tacorl_module(device, str(lmp_dir))
    batch = _batch(2 * n, 8, 48, seed=3)
    batch["goal"] = {"rgb_static": np.random.RandomState(5).randint(0, 255, (2 * n, 48, 48, 3), dtype=np.uint8)}
    batch["disp"] = np.asarray([1, 2, -1, 3] * ((2 * n + 3) // 4))[: 2 * n]
    from tacorl_tpu_torch.modules.tacorl import FROZEN

    state = module.init_state(1)
    mesh_lib.replicate(state)
    before = {k: v.clone() for k, v in state.net.state_dict().items() if k.split(".")[0] in FROZEN}
    out["tacorl"] = _step(module, state, batch, mesh, device, 1, ("q1_loss", "actor_loss"))
    after = state.net.state_dict()
    moved = [k for k, v in before.items() if not torch.equal(v, after[k])]
    _check(not moved, f"tacorl: the grafted frozen weights moved: {moved[:3]}")
    out["tacorl"]["frozen_checked"] = len(before)
    return out


# -- the entry point -------------------------------------------------------------------


def dryrun_multichip(n_devices: int, device: str = "cuda", root: Optional[str] = None) -> dict:
    """The dry run over ``n_devices`` ranks; prints rank 0's lines and
    returns its results. ``device="cpu"``: gloo ranks on the CPU; "cuda":
    NCCL over ``n_devices`` cards, or gloo ranks sharing the first card
    when there are fewer (without a card it raises)."""
    n = int(n_devices)
    kind = torch.device(device).type
    if kind == "cuda":
        resolve_device("cuda")
        backend = "nccl" if torch.cuda.device_count() >= n else "gloo"
    else:
        backend = "gloo"
    with tempfile.TemporaryDirectory(dir=root) as tmp:
        multiprocessing.spawn(_rank, args=(n, backend, kind, tmp), nprocs=n, join=True)
        out = json.loads((Path(tmp) / "result.json").read_text())
    lmp = out["play_lmp"]
    print(f"dryrun_multichip OK: mesh={out['mesh']} loss={lmp['total_loss']:.4f} "
          f"grad_norm={lmp['grad_norm']:.4f} ({backend}, {len(out['sharded'])} sharded leaves)", flush=True)
    for tag, key in (("cql", "q1_loss"), ("ril", "total_loss"), ("sac", "q1_loss"), ("tacorl", "q1_loss")):
        print(f"dryrun_multichip {tag} OK: {key}={out[tag][key]:.4f}", flush=True)
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--n-devices", type=int, required=True)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    dryrun_multichip(args.n_devices, args.device)
    return 0


if __name__ == "__main__":
    # the ranks run this module's functions by their import path
    from tacorl_tpu_torch.dryrun import main as _main

    raise SystemExit(_main())
