"""Play-LMP over a frozen R3M ResNet-18 (``experiment=play_lmp_r3m``) on
the CPU at a tiny backbone (width 8, 32x32 frames), float32 throughout:

  * the port's stage-1 step through ``tacorl_tpu_torch.train.main``
    against the benchmark's plain reference
    (``perfbench/reference/play_lmp_r3m.py``) from the same seeded weights
    and batches: each step's loss (rtol 1e-5 of the largest), the first
    gradients as Adam got them (rtol 1e-4, atol 1e-6) and every parameter
    after three steps (1 % of the largest move, Adam's sign noise on a
    near-zero gradient);
  * the backbone's leaves and BatchNorm buffers unchanged after the steps,
    with no Adam state and no gradient;
  * two gloo ranks through ``train.main``: the flat all-reduce buffer of
    the gradients holds the trained leaves alone;
  * a kill and resume bit-equal to an uninterrupted run, the BatchNorm
    statistics (set away from their init) restored from the checkpoint;
  * the backbone is R3M's trunk: no ``backbone.fc``, the 512 pooled
    features go to ``head1``; R3M's ImageNet normalisation of the frames;
  * the backbone's span and frame counter in the program's recorder."""

import json

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from perfbench import data
from perfbench.reference import play_lmp_r3m as reference
from tacorl_tpu_torch import train
from tacorl_tpu_torch.callbacks.base import Callback
from tacorl_tpu_torch.core.checkpoint import CheckpointManager
from tacorl_tpu_torch.core.trainer import Trainer
from tacorl_tpu_torch.data.loader import DataLoader
from tacorl_tpu_torch.modules.play_lmp import PlayLMPModule
from tacorl_tpu_torch.networks.resnet import IMAGENET_MEAN, IMAGENET_STD, R3MEncoder
from tacorl_tpu_torch.utils import profiling
from tests import torch_ddp_child as child
from tests.torch_threads import share_cores

share_cores()  # the xdist workers share the cores

SEED, STEPS, BATCH = 20221018, 3, 8
DATASET = {"image_hw": 56, "episodes": 2, "episode_len": 40, "val_episodes": 1, "val_episode_len": 24}
ENCODER = "module.perceptual_encoder.networks.rgb_static"
OVERRIDES = [
    f"{ENCODER}.latent_dim=16", f"{ENCODER}.hidden_dim=32", f"+{ENCODER}.width=8",
    f"+{ENCODER}.compute_dtype=float32",
    "module.goal_encoder.hidden_size=32",
    "module.plan_recognition.num_heads=4", "module.plan_recognition.num_layers=1",
    "module.plan_recognition.encoder_hidden_size=32", "module.plan_recognition.fc_hidden_size=32",
    "module.plan_proposal.policy.hidden_dim=32",
    "module.action_decoder.hidden_size=32", "module.action_decoder.num_layers=1",
    "module.action_decoder.n_mixtures=4",
    "transforms.rgb_static.size=[32,32]", "transforms.rgb_static.pad=2",
    "transforms.rgb_static.aug_dtype=float32",
    "datamodule.dataset.min_window_size=4", "datamodule.dataset.max_window_size=8",
]
# the reference's sizes at those widths (perfbench/configs/play_lmp_r3m_calvin.json's keys)
SIZES = {
    **json.loads((data.ROOT / "perfbench" / "configs" / "play_lmp_r3m_calvin.json").read_text())["sizes"],
    "batch_size": BATCH, "min_window_size": 4, "max_window_size": 8, "image_hw": 56,
    "augment": {"size": [32, 32], "pad": 2, "brightness": 0.1, "contrast": 0.1, "hue": 0.02, "jitter_prob": 1.0},
    "latent_dim": 16, "encoder_hidden_dim": 32, "goal_hidden_size": 32,
    "num_heads": 4, "num_layers": 1, "encoder_hidden_size": 32, "fc_hidden_size": 32,
    "prior_hidden_dim": 32, "decoder_hidden_size": 32, "decoder_num_layers": 1, "n_mixtures": 4,
    "backbone_widths": [8, 16, 32, 64], "backbone_features": 64,
}
BACKBONE = "perceptual_encoder.networks.rgb_static.backbone."
CPU = torch.device("cpu")


def _argv(store, run_dir, max_steps=STEPS, extra=()):
    return [
        "experiment=play_lmp_r3m", f"data_dir={store}", f"run_dir={run_dir}", f"seed={SEED}",
        f"+datamodule.seed={SEED}", f"datamodule.batch_size={BATCH}", "trainer.steps_per_call=1",
        f"trainer.max_steps={max_steps}", "trainer.val_every_n_epochs=1000000",
        "trainer.ckpt_every_n_epochs=1000000", "+device=cpu", *OVERRIDES, *extra,
    ]


class _Copies(Callback):
    """Loads the reference's weights at fit start; keeps each step's loss,
    the first moments after step 1 and the net after the last step."""

    def __init__(self, weights):
        self.weights, self.losses, self.moments = weights, [], None

    def on_fit_start(self, trainer, module):
        net = trainer.state.net
        with torch.no_grad():
            net.load_state_dict(self.weights, strict=True)
        self.optimizer = trainer.state.optimizer

    def on_train_batch_end(self, trainer, module, metrics, step):
        self.losses.append(float(metrics["total_loss"]))
        if step == 1:
            state = self.optimizer.state
            self.moments = {n: state[p]["exp_avg"].clone() for n, p in trainer.state.net.named_parameters()
                            if p in state}
            self.beta1 = self.optimizer.param_groups[0]["betas"][0]


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    return data.ensure_store(DATASET, cache=tmp_path_factory.mktemp("r3m_data"))


@pytest.fixture(scope="module")
def run(store, tmp_path_factory):
    weights = reference.weights(SIZES, SEED, CPU)["full"]
    copies = _Copies(weights)
    trainer = train.main(_argv(store, tmp_path_factory.mktemp("r3m_run")), callbacks=[copies])
    ref = reference.train_steps(weights, reference.batches(store, SIZES, SEED, STEPS, CPU), SIZES, SEED, 0)
    return trainer, copies, ref, weights


def test_the_step_through_train_main_agrees_with_the_reference(run):
    trainer, copies, ref, weights = run
    assert trainer.global_step == STEPS and trainer.step_graph is None
    want = ref["losses"]["total_loss"]
    scale = float(want.abs().max())
    for i, v in enumerate(want):
        assert copies.losses[i] == pytest.approx(float(v), abs=1e-5 * scale), i
    assert set(copies.moments) == set(ref["grads"])
    for n, g in ref["grads"].items():
        torch.testing.assert_close(copies.moments[n] / (1 - copies.beta1), g, rtol=1e-4, atol=1e-6, msg=n)
    params = dict(trainer.state.net.named_parameters())
    for n, p in ref["params"].items():
        moved = float((p - weights[n]).abs().max())
        torch.testing.assert_close(params[n].detach(), p, rtol=0, atol=1e-2 * moved + 1e-9, msg=n)


def test_the_backbone_stays_as_loaded_with_no_gradient_or_adam_state(run):
    trainer, _, _, weights = run
    net, optimizer = trainer.state.net, trainer.state.optimizer
    backbone = {n: t for n, t in net.state_dict().items() if n.startswith(BACKBONE)}
    assert any(n.endswith("running_var") for n in backbone) and len(backbone) == sum(
        1 for n in weights if n.startswith(BACKBONE))
    assert all(torch.equal(t, weights[n]) for n, t in backbone.items())
    frozen = [p for n, p in net.named_parameters() if n.startswith(BACKBONE)]
    trained = {id(p) for group in optimizer.param_groups for p in group["params"]}
    assert frozen and all(not p.requires_grad and p.grad is None and id(p) not in trained for p in frozen)
    assert all(p not in optimizer.state for p in frozen)
    assert len(optimizer.state) == sum(1 for p in net.parameters() if p.requires_grad)
    assert not net.perceptual_encoder.networks["rgb_static"].backbone.training


# -- two ranks -------------------------------------------------------------------------


def _reduced_sizes_job(rank, root):
    """One rank of ``train.main`` for two steps; records the size of every
    all-reduce it makes."""
    spec = torch.load(root / "spec.pt", weights_only=False)
    sizes, original = [], dist.all_reduce

    def recording(tensor, *args, **kwargs):
        sizes.append(tensor.numel())
        return original(tensor, *args, **kwargs)

    dist.all_reduce = recording
    try:
        trainer = train.main(spec["argv"])
    finally:
        dist.all_reduce = original
    net = trainer.state.net
    torch.save({"sizes": sizes, "backbone": {n: t for n, t in net.state_dict().items() if n.startswith(BACKBONE)},
                "trained": sum(p.numel() for p in net.parameters() if p.requires_grad),
                "frozen": sum(p.numel() for n, p in net.named_parameters() if n.startswith(BACKBONE))},
               root / f"rank_{rank}.pt")


def run_reduced_sizes_job(rank: int, world: int, root: str) -> None:
    child._run(_reduced_sizes_job, rank, world, root)


def test_the_backbone_is_not_in_the_flat_all_reduce_buffer(store, tmp_path):
    torch.save({"argv": _argv(store, tmp_path / "run", max_steps=2)}, tmp_path / "spec.pt")
    mp.spawn(run_reduced_sizes_job, args=(2, str(tmp_path)), nprocs=2, join=True)
    ranks = [torch.load(tmp_path / f"rank_{r}.pt", weights_only=False) for r in range(2)]
    for r in ranks:
        # one flat float32 buffer a step, of the trained leaves' gradients
        assert r["sizes"].count(r["trained"]) == 2 and max(r["sizes"]) == r["trained"], r["sizes"]
        assert r["frozen"] > 0 and r["trained"] + r["frozen"] not in r["sizes"]
    assert all(torch.equal(t, ranks[1]["backbone"][n]) for n, t in ranks[0]["backbone"].items())


# -- kill and resume -----------------------------------------------------------------


def _module_cfg():
    return {
        "lr": 1e-4, "kl_beta": 1e-3, "latent_plan_dim": 16,
        "plan_proposal_obs_modalities": ["rgb_static"], "plan_proposal_goal_modalities": ["rgb_static"],
        "plan_recognition_modalities": ["rgb_static"], "action_decoder_modalities": ["rgb_static"],
        "perceptual_encoder": {"networks": {"rgb_static": {
            "_target_": "tacorl_tpu.networks.resnet.R3MEncoder", "latent_dim": 16, "hidden_dim": 32, "width": 8,
            "compute_dtype": None, "r3m_trunk": True}}},
        "goal_encoder": {"hidden_size": 32},
        "plan_recognition": {"num_heads": 4, "num_layers": 1, "encoder_hidden_size": 32, "fc_hidden_size": 32,
                             "max_position_embeddings": 8, "dropout_p": 0.1},
        "plan_proposal": {"policy": {"num_layers": 2, "hidden_dim": 32}},
        "action_decoder": {"hidden_size": 32, "num_layers": 1, "n_mixtures": 4},
        "transforms": {"rgb_static": {"kind": "rgb", "size": [32, 32], "pad": 2, "use_pallas": True}},
    }


class _ConstantWindows:
    """Every index samples the same window, so a resumed run, which starts
    its loader at epoch 0 again, sees what an uninterrupted run sees."""

    def __init__(self):
        rs = np.random.RandomState(4)
        self.item = {"states": {"rgb_static": rs.randint(0, 256, (5, 40, 40, 3), dtype=np.uint8)},
                     "actions": np.clip(rs.randn(5, 7), -1, 1).astype(np.float32)}

    def __len__(self):
        return 16

    def sample(self, idx, rng):
        return self.item


class _ConstantDataModule:
    def setup(self):
        self.train_dataset = _ConstantWindows()

    def train_loader(self):
        return DataLoader(self.train_dataset, batch_size=4, seed=0)

    def val_loader(self):
        return None


class _MovedStatistics(Callback):
    """A fresh run's backbone BatchNorm statistics and gains away from
    their init (as a loaded checkpoint's are); a resumed run keeps the
    checkpoint's."""

    def on_fit_start(self, trainer, module):
        if trainer.global_step:
            return
        gen = torch.Generator().manual_seed(9)
        with torch.no_grad():
            for n, t in trainer.state.net.state_dict().items():
                if n.startswith(BACKBONE) and t.dim() == 1:
                    t.copy_(0.5 + torch.rand(t.shape, generator=gen))


def _fit(run_dir, max_steps):
    trainer = Trainer(max_steps=max_steps, ckpt_manager=CheckpointManager(run_dir), seed=3, device="cpu",
                      log_every_n_steps=100, callbacks=[_MovedStatistics()])
    return trainer.fit(PlayLMPModule(_module_cfg(), device="cpu"), _ConstantDataModule())


def test_kill_and_resume_is_bit_equal_with_the_statistics_in_the_checkpoint(tmp_path):
    whole = _fit(tmp_path / "whole", 4)
    _fit(tmp_path / "killed", 2)
    saved = torch.load(tmp_path / "killed" / "ckpts" / "2" / "state.pt", weights_only=False)["net"]
    resumed = _fit(tmp_path / "killed", 4)
    assert whole.step == resumed.step == 4
    a, b = whole.net.state_dict(), resumed.net.state_dict()
    assert set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in a)
    stats = [k for k in a if k.startswith(BACKBONE) and k.endswith(("running_mean", "running_var"))]
    assert stats and all(torch.equal(saved[k], b[k]) and not torch.equal(b[k], torch.ones_like(b[k]))
                         and not torch.equal(b[k], torch.zeros_like(b[k])) for k in stats)
    opt_a, opt_b = whole.optimizer.state_dict()["state"], resumed.optimizer.state_dict()["state"]
    assert len(opt_a) == len(opt_b) and all(torch.equal(opt_a[i]["exp_avg_sq"], opt_b[i]["exp_avg_sq"]) for i in opt_a)


# -- the trunk -------------------------------------------------------------------------


def test_the_backbone_is_r3ms_trunk():
    enc = R3MEncoder(r3m_trunk=True, compute_dtype=None)
    assert enc.backbone.fc is None and enc.backbone.latent_dim == 512 and enc.head1.in_features == 512
    assert not any(k.startswith("backbone.fc") for k in enc.state_dict())
    # the JAX package's layout stays the default
    assert R3MEncoder().backbone.fc.in_features == 512
    seen = {}
    enc.head1.register_forward_hook(lambda m, inp, out: seen.update(x=inp[0]))
    enc.backbone.layer4.register_forward_hook(lambda m, inp, out: seen.update(last=out))
    enc.backbone.conv1.register_forward_hook(lambda m, inp, out: seen.update(first=inp[0]))
    x = torch.rand(2, 3, 64, 64) * 2 - 1
    enc.train()(x)
    torch.testing.assert_close(seen["x"], seen["last"].mean(dim=(2, 3)), rtol=0, atol=0)
    # R3M's preprocessing: frames in [-1, 1] back to [0, 1], ImageNet's mean and std
    mean, std = torch.tensor(IMAGENET_MEAN).view(1, 3, 1, 1), torch.tensor(IMAGENET_STD).view(1, 3, 1, 1)
    torch.testing.assert_close(seen["first"], ((x + 1) / 2 - mean) / std, rtol=1e-6, atol=1e-6)


def test_the_backbone_span_and_frame_counter_are_recorded():
    enc = R3MEncoder(latent_dim=4, hidden_dim=8, width=8, compute_dtype=None, r3m_trunk=True)
    profiling.record(True)
    try:
        enc(torch.rand(5, 3, 32, 32))
    finally:
        profiling.record(False)
    assert [s[0] for s in profiling.RECORDER.spans] == ["encoder/backbone"]
    assert [(c[0], c[1]) for c in profiling.RECORDER.counts] == [("encoder/backbone_frames", 5)]
