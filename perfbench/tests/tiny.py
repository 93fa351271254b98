"""A tiny Play-LMP cell for CPU tests: the production configuration's
keys at small widths, the program's overrides that match them, and
float32 augmentation and convolutions so that program and reference agree
to float32 rounding."""

import copy

from perfbench import harness

SIZES = {
    "batch_size": 8, "min_window_size": 4, "max_window_size": 8, "image_hw": 56,
    "augment": {"size": [48, 48], "pad": 2, "brightness": 0.1, "contrast": 0.1, "hue": 0.02, "jitter_prob": 1.0},
    "latent_dim": 16, "encoder_hidden_dim": 32, "goal_hidden_size": 32,
    "num_heads": 4, "num_layers": 1, "encoder_hidden_size": 32, "fc_hidden_size": 32,
    "prior_hidden_dim": 32, "decoder_hidden_size": 32, "decoder_num_layers": 1, "n_mixtures": 4,
}
OVERRIDES = [
    "module.perceptual_encoder.networks.rgb_static.latent_dim=16",
    "module.perceptual_encoder.networks.rgb_static.hidden_dim=32",
    "+module.perceptual_encoder.networks.rgb_static.compute_dtype=float32",
    "module.goal_encoder.hidden_size=32",
    "module.plan_recognition.num_heads=4", "module.plan_recognition.num_layers=1",
    "module.plan_recognition.encoder_hidden_size=32", "module.plan_recognition.fc_hidden_size=32",
    "module.plan_proposal.policy.hidden_dim=32",
    "module.action_decoder.hidden_size=32", "module.action_decoder.num_layers=1",
    "module.action_decoder.n_mixtures=4",
    "transforms.rgb_static.size=[48,48]", "transforms.rgb_static.pad=2",
    "transforms.rgb_static.aug_dtype=float32",
    "datamodule.dataset.min_window_size=4", "datamodule.dataset.max_window_size=8",
]
DATASET = {"image_hw": 56, "episodes": 2, "episode_len": 40, "val_episodes": 1, "val_episode_len": 24}


def lmp_cell(**workload_changes):
    """(workload, configuration) of the production stage-1 cell, cut to the
    tiny sizes."""
    workload, config = harness.cell("lmp_k16_b64")
    workload, config = copy.deepcopy(workload), copy.deepcopy(config)
    config["sizes"] = {**config["sizes"], **SIZES}
    config["dataset"] = dict(DATASET)
    config["overrides"] = list(config["overrides"]) + OVERRIDES
    config["kernels"] = {"jitter_normalize": [[8 * 8, 3, 48, 48]]}
    workload.update({"batch_size": 8, "warm_chunks": 4, "trace_chunks": 3, **workload_changes})
    return workload, config


TACORL_SIZES = {**SIZES, "q_hidden_dim": 16}
TACORL_OVERRIDES = OVERRIDES + ["module.q_network.hidden_dim=16", "+datamodule.dataset.num_nn=8"]


def tacorl_cell(**workload_changes):
    """(workload, configuration) of the production stage-2 cell, cut to the
    tiny sizes; the graft's stage-1 configuration cut alike."""
    workload, config = harness.cell("tacorl_k8_b64")
    workload, config = copy.deepcopy(workload), copy.deepcopy(config)
    config["sizes"] = {**config["sizes"], **TACORL_SIZES,
                       "goals": {**config["sizes"]["goals"], "num_nn": 8}}
    config["dataset"] = dict(DATASET)
    config["overrides"] = list(config["overrides"]) + TACORL_OVERRIDES
    config["graft"] = {**config["graft"], "overrides": list(config["graft"]["overrides"]) + OVERRIDES}
    config["kernels"] = {"jitter_normalize": [[8 * 8, 3, 48, 48], [8, 3, 48, 48]]}
    workload.update({"batch_size": 8, "warm_chunks": 4, "trace_chunks": 3, **workload_changes})
    return workload, config
