"""Two gloo ranks through ``tacorl_tpu_torch.train.main`` on the CPU
(spawned by ``torch.multiprocessing``, joined through a file store; the
ranks import only ``tacorl_tpu_torch``: tests/torch_ddp_child.py):
experiment=play_lmp_fake at tiny widths with its rollout monitor, on a
global batch of 8, for an epoch at K = 1 and K = 2. Held:

  * K = 2 against K = 1 (bit-equal), and against one rank on the global
    batch: the first step's metrics within rtol 1e-5, every later step's
    within rtol 1e-2, the weights after the run within atol 2.5 lr a step;
  * only rank 0 wrote the metrics, the checkpoints and the config;
  * a kill-and-resume at two ranks against an uninterrupted two-rank run
    (Play-LMP with dropout on, on a data module whose every batch is the
    same, as tests/test_torch_trainer.py holds one rank);
  * the rollout callbacks' rank shards: disjoint, covering every index,
    padded to equal counts, and their metrics the mean over the ranks;
  * experiment=sac_online_fake at tiny widths on a global batch of 8: both
    ranks play one env stream and keep one buffer (rank 0 writes its
    files), each takes its rows of every global sample; held against one
    rank as the offline run is."""

import json

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from tacorl_tpu_torch import train
from tacorl_tpu_torch.core.checkpoint import CheckpointManager
from tacorl_tpu_torch.data.expert_play import generate_expert_play
from tests import test_torch_play_lmp as lmp
from tests import torch_ddp_child as child
from tests.torch_threads import share_cores

share_cores()  # the xdist workers share the cores

WORLD = 2
ONLINE = [
    "+device=cpu", "experiment=sac_online_fake", "module.goal_encoder.hidden_size=16",
    "module.policy.hidden_dim=16", "module.q_network.hidden_dim=16", "module.warm_start_steps=16",
    "datamodule.batch_size=8", "datamodule.steps_per_epoch=3", "trainer.log_every_n_steps=1",
    "callbacks.rollout.num_rollouts=2", "env.max_episode_steps=8", "trainer.max_epochs=2",
]
TINY = [
    "+device=cpu", "experiment=play_lmp_fake", "trainer.max_epochs=1", "trainer.log_every_n_steps=1",
    "datamodule.batch_size=8", "module.plan_recognition.hidden_size=16",
    "module.action_decoder.hidden_size=16", "module.perceptual_encoder.networks.rgb_static.hidden_dim=16",
    "callbacks.rollout.num_rollouts_per_task=2", "env.max_episode_steps=4",
]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("ddp_train")
    data = root / "play"
    generate_expert_play(data, n_train_episodes=2, n_val_episodes=2, seed=3)
    args = TINY + [f"data_dir={data}"]
    batch = lmp._batch(4)
    cfg = lmp._cfg()
    cfg["plan_recognition"]["dropout_p"] = 0.1
    torch.save({
        "runs": {"k1": args + [f"run_dir={root / 'k1'}"],
                 "k2": args + [f"run_dir={root / 'k2'}", "trainer.steps_per_call=2"],
                 "sac": _online(root / "sac")},
        "constant_cfg": cfg,
        "constant_item": {"states": {"rgb_static": batch["states"]["rgb_static"][0]},
                          "actions": batch["actions"][0]},
    }, root / "train.pt")
    mp.spawn(child.run_train_job, args=(WORLD, str(root)), nprocs=WORLD, join=True)
    ranks = [torch.load(root / f"train_{r}.pt", weights_only=False) for r in range(WORLD)]
    one = train.main(args + [f"run_dir={root / 'one'}"])
    sac = train.main(_online(root / "sac_one"))
    return {"root": root, "ranks": ranks, "one": one, "sac": sac}


def _online(run_dir):
    return ONLINE + [f"run_dir={run_dir}", f"module.replay_buffer_path={run_dir}/rb"]


def _rows(run_dir):
    return [json.loads(line) for line in (run_dir / "metrics.jsonl").read_text().splitlines()]


def _by_step(rows, prefix="train/"):
    return {r["step"]: {k: v for k, v in r.items() if k.startswith(prefix)}
            for r in rows if any(k.startswith(prefix) for k in r)}


@pytest.mark.parametrize("name", ["k1", "k2", "sac"])
def test_the_ranks_trained_alike(runs, name):
    """The same steps, weights and monitored metrics on both ranks."""
    a, b = (r[name] for r in runs["ranks"])
    assert a["step"] == b["step"] > 0
    assert a["val"] == b["val"] and "val_accuracy" in a["val"]
    assert all(torch.equal(v, b["sd"][k]) for k, v in a["sd"].items())


def test_k2_equals_k1(runs):
    """On the CPU a chunk of K steps is the eager step K times: bit-equal."""
    k1, k2 = runs["ranks"][0]["k1"], runs["ranks"][0]["k2"]
    assert all(torch.equal(v, k2["sd"][k]) for k, v in k1["sd"].items())
    rows1, rows2 = _by_step(_rows(runs["root"] / "k1")), _by_step(_rows(runs["root"] / "k2"))
    assert set(rows2) <= set(rows1) and len(rows2) >= 2
    assert all(rows2[s] == rows1[s] for s in rows2)


def _step_metric(key: str) -> bool:
    """A train or validation step's metric (not a rollout's: the rollout
    manager's draws run on from episode to episode within a rank, so a
    rank's episodes are not those episodes of the one-rank run)."""
    return key.startswith("train/") or (key.startswith("validation/") and key.count("/") == 1)


@pytest.mark.parametrize("name, one", [("k1", "one"), ("sac", "sac_one")])
def test_two_ranks_match_one_rank_on_the_global_batch(runs, name, one):
    """The first step's metrics within rtol 1e-5 (both start from the same
    weights), the weights after the run within atol 2.5 lr a step. Later
    rows drift apart as Adam carries the two sums' float32 rounding on
    (6e-4 relative by step 7 on the CPU): they are held within rtol 1e-2,
    which a rank fed the other rank's rows, or a skipped gradient
    all-reduce, exceeds."""
    got, want = _rows(runs["root"] / name), _rows(runs["root"] / one)
    assert [r["step"] for r in got] == [r["step"] for r in want]
    for g, w in zip(got, want):
        assert set(g) == set(w)
    first = [k for k in want[0] if _step_metric(k)]
    assert want[0]["step"] == 1 and first
    for k in first:
        # rtol 1e-5: float32 sums taken in another order
        np.testing.assert_allclose(got[0][k], want[0][k], rtol=1e-5, atol=1e-7, err_msg=k)
    later = [(g, w, k) for g, w in zip(got[1:], want[1:]) for k in w if _step_metric(k)]
    assert later
    for g, w, k in later:
        np.testing.assert_allclose(g[k], w[k], rtol=1e-2, atol=1e-6, err_msg=f"{k} at step {w['step']}")
    module = json.loads((runs["root"] / one / "config.json").read_text())["module"]
    lr = max(float(v) for k, v in module.items() if k == "lr" or k.endswith("_lr"))
    trainer = runs["one" if name == "k1" else "sac"]
    assert runs["ranks"][0][name]["step"] == trainer.global_step
    for k, v in trainer.state.net.state_dict().items():
        np.testing.assert_allclose(runs["ranks"][0][name]["sd"][k].numpy(), v.numpy(),
                                   atol=2.5 * lr * trainer.global_step, rtol=0, err_msg=k)


def test_only_rank_zero_writes(runs):
    a, b = runs["ranks"]
    assert a["k1"]["writes"] == (True, True) and b["k1"]["writes"] == (False, False)
    for name, one in (("k1", "one"), ("k2", "one"), ("sac", "sac_one")):
        run = runs["root"] / name
        steps = [(r["step"], tuple(sorted(r))) for r in _rows(run)]
        assert len(steps) == len(set(steps))  # no row written twice
        assert CheckpointManager(run).all_steps() == CheckpointManager(runs["root"] / one).all_steps()
        assert (run / "config.json").is_file()
    # the replay buffer's files: rank 0's, as many as one rank writes
    files = sorted(p.name for p in (runs["root"] / "sac" / "rb").iterdir())
    assert files and files == sorted(p.name for p in (runs["root"] / "sac_one" / "rb").iterdir())


def test_kill_and_resume_equals_an_uninterrupted_run(runs):
    for rank in runs["ranks"]:
        whole, resumed = rank["whole"], rank["resumed"]
        assert whole["step"] == resumed["step"] == 4
        assert all(torch.equal(v, resumed["sd"][k]) for k, v in whole["sd"].items())
        assert all(torch.equal(a, b) for a, b in zip(whole["exp_avg_sq"], resumed["exp_avg_sq"]))
    # dropout draws per rank: the two ranks' masks differ, the weights do not
    a, b = (r["whole"]["sd"] for r in runs["ranks"])
    assert all(torch.equal(v, b[k]) for k, v in a.items())


def test_rollout_shards_are_disjoint_cover_and_average(runs):
    shards = [r["rollout"] for r in runs["ranks"]]
    assert shards[0]["goals"] == [0, 2, 4, 6, 8] and shards[1]["goals"] == [1, 3, 5, 7, 9]
    # 5 goals pad to 6: every rank evaluates 3, the last wraps around
    assert shards[0]["padded"] == [0, 2, 4] and shards[1]["padded"] == [1, 3, 0]
    for s in shards:
        assert s["logged"] == s["monitor"] == {"val_accuracy": 0.5, "val_episode_return": 1.0}
