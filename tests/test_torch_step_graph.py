"""``core/graphs.py:StepGraph``'s decision to capture again, on the CPU.

A CUDA graph reads and writes the net's parameters at the addresses it was
captured with. An eager step between replays can move them: on the card a
validation pass made cuDNN repack the biRNN posterior's weights into a new
buffer, and the replays that followed updated memory the net no longer
read (``play_lmp_fake``'s unweighted ``kl_loss`` jumped from 0.86 to 5e+06
at K = 2, ROADMAP Queue 3). StepGraph now captures again when a parameter
or buffer moved. The card's stream and graph calls are stood in for by
objects that run nothing: what is checked is when StepGraph captures."""

import contextlib
from types import SimpleNamespace

import torch

from tacorl_tpu_torch.core import graphs
from tacorl_tpu_torch.core.train_state import TrainState


class _Stream:
    def wait_stream(self, other):
        pass


class _Graph:
    def register_generator_state(self, generator):
        pass

    def replay(self):
        pass


def _cpu_stand_ins(monkeypatch):
    monkeypatch.setattr(torch.cuda, "Stream", lambda device=None: _Stream())
    monkeypatch.setattr(torch.cuda, "stream", lambda stream: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: _Stream())
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _Graph)
    monkeypatch.setattr(torch.cuda, "graph", lambda graph, **kw: contextlib.nullcontext())


def _graph_and_state():
    torch.manual_seed(0)
    net = torch.nn.Sequential(torch.nn.Linear(3, 4), torch.nn.BatchNorm1d(4))
    state = TrainState(step=0, net=net, optimizer=torch.optim.SGD(net.parameters(), lr=0.1))
    module = SimpleNamespace(device=torch.device("cpu"), generator=torch.Generator())

    def step(state, batch, scalars, **draws):
        state.optimizer.zero_grad()
        loss = state.net(batch["x"]).square().mean()
        loss.backward()
        state.optimizer.step()
        return state, {"loss": loss.detach()}

    return graphs.StepGraph(module, step), state, {"x": torch.randn(5, 3)}


def test_a_moved_parameter_or_buffer_captures_the_step_again(monkeypatch):
    _cpu_stand_ins(monkeypatch)
    graph, state, batch = _graph_and_state()
    for index in range(3):
        graph(state, batch, {}, None, seed=0, index=index)
    assert (graph.captures, graph.replays) == (1, 3)
    # what cuDNN's repack does to an RNN's weights: the same values, a new buffer
    with torch.no_grad():
        state.net[0].weight.data = state.net[0].weight.data.clone()
    graph(state, batch, {}, None, seed=0, index=3)
    assert (graph.captures, graph.replays) == (2, 4)
    graph(state, batch, {}, None, seed=0, index=4)
    assert graph.captures == 2
    state.net[1].running_mean.data = state.net[1].running_mean.data.clone()
    graph(state, batch, {}, None, seed=0, index=5)
    assert graph.captures == 3 and state.step == 6


def test_values_changed_in_place_replay_the_captured_step(monkeypatch):
    """In-place changes (a resume's load_state_dict, the trainer's copies)
    keep the addresses: the captured step replays."""
    _cpu_stand_ins(monkeypatch)
    graph, state, batch = _graph_and_state()
    graph(state, batch, {}, None, seed=0, index=0)
    state.net.load_state_dict({k: v + 1 for k, v in state.net.state_dict().items()})
    graph(state, batch, {}, None, seed=0, index=1)
    assert (graph.captures, graph.replays) == (1, 2)
    graph.release()
    assert graph.addresses is None
    graph(state, batch, {}, None, seed=0, index=2)
    assert graph.captures == 2
