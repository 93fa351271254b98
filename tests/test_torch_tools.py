"""The port's tools held against the JAX package's on the CPU:
``utils/profiling.py`` (``StepTimer`` under a patched clock, ``trace``
writing a trace file, ``start_server`` refused with its ROADMAP entry) and
``utils/visualize_frames.py`` (the decoded frames of the dumped video equal
the JAX dump's, exactly)."""

import json

import numpy as np
import pytest
import torch

from tacorl_tpu.utils import profiling as jax_profiling
from tacorl_tpu.utils.visualize_frames import dump_episode_video as jax_dump
from tacorl_tpu_torch.data.expert_play import generate_expert_play
from tacorl_tpu_torch.utils import profiling
from tacorl_tpu_torch.utils.visualize_frames import dump_episode_video


class _Clock:
    """A perf_counter that returns the given times, one a call."""

    def __init__(self, times):
        self.times = iter(times)

    def __call__(self):
        return next(self.times)


@pytest.mark.parametrize("window", [1, 3])
def test_step_timer_matches_jax_under_one_clock(monkeypatch, window):
    rs = np.random.RandomState(window)
    times = np.cumsum(rs.uniform(0.01, 0.2, 12)).tolist()
    rates = {}
    for name, module in (("port", profiling), ("jax", jax_profiling)):
        monkeypatch.setattr(module.time, "perf_counter", _Clock(times))
        timer = module.StepTimer(window=window)
        rates[name] = ([timer.tick() for _ in times], timer.steps_per_sec)
    assert rates["port"] == rates["jax"]
    assert rates["port"][0][0] is None and rates["port"][1] > 0


def test_trace_writes_a_trace_file_naming_the_span(tmp_path):
    with profiling.trace(tmp_path / "profile", steps_context="train_steps") as prof:
        x = torch.randn(64, 64)
        for _ in range(3):
            x = torch.tanh(x @ x)
    files = list((tmp_path / "profile").glob("*.pt.trace.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    assert "train_steps" in names and "aten::mm" in names
    assert any(row.key == "train_steps" for row in prof.key_averages())


def test_start_server_raises_naming_its_roadmap_entry():
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 3, 'no live profiling server'"):
        profiling.start_server(9999)


@pytest.fixture(scope="module")
def play_set(tmp_path_factory):
    root = tmp_path_factory.mktemp("play")
    generate_expert_play(root, n_train_episodes=1, n_val_episodes=1, tasks_per_episode=2,
                         idle_steps=(2, 3), seed=4, image_hw=32)
    return root / "training"


def _decode(path):
    import cv2

    cap = cv2.VideoCapture(str(path))
    frames = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        frames.append(frame)
    cap.release()
    return np.stack(frames)


@pytest.mark.parametrize("span", [None, (3, 9)], ids=["first_episode", "span"])
def test_dump_episode_video_decodes_to_the_jax_frames(play_set, tmp_path, span):
    start, end = span or (None, None)
    got = dump_episode_video(play_set, tmp_path / "port.mp4", start, end, fps=10)
    want = jax_dump(play_set, tmp_path / "jax.mp4", start, end, fps=10)
    frames = _decode(got)
    np.testing.assert_array_equal(frames, _decode(want))
    n = (end - start + 1) if span else None
    assert frames.shape[1:] == (32, 32, 3) and (n is None or len(frames) == n)
