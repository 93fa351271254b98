"""``python -m tacorl_tpu_torch.make_flagship_data`` against
scripts/make_flagship_data.py at a small episode count: the packed
memmaps and the ``*.json`` span tables of both splits, bit for bit."""

from scripts import make_flagship_data as jax_script
from tacorl_tpu_torch import make_flagship_data
from tests.test_torch_envs import _dir_contents, assert_same


def test_packed_flagship_data_matches_the_jax_script(tmp_path, monkeypatch):
    # the JAX script fixes 400 / 40 episodes; both run 2 / 1 here
    generate = jax_script.generate_expert_play
    monkeypatch.setattr(
        jax_script, "generate_expert_play",
        lambda *a, **kw: generate(*a, **{**kw, "n_train_episodes": 2, "n_val_episodes": 1}),
    )
    jax_script.main(tmp_path / "jax")
    out = make_flagship_data.main(tmp_path / "port", n_train_episodes=2, n_val_episodes=1)
    assert out == tmp_path / "port"
    got, want = _dir_contents(tmp_path / "port"), _dir_contents(tmp_path / "jax")
    assert {"training/start_end_tasks.json", "validation/start_end_tasks.json"} <= set(got)
    assert any(k.startswith("training/") and not k.endswith(".json") for k in got)
    assert_same(got, want)
