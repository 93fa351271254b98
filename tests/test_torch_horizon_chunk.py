"""What the K-step dispatch hands the callbacks, held against the JAX
package on the CPU, and the CPU-checkable parts of the step-graph helpers:

  * the uncertainty-gated horizon's MC-dropout std on a stacked (K, B, ...)
    chunk of vector observations equals the JAX callback's on the same
    chunk for the same masks; on image observations the JAX callback fails
    (TypeError) and the port raises ``CHUNK_FAULT``, also through
    ``train.main`` on ``experiment=cql_fake`` at ``steps_per_call=2``;
  * ``set_capturable`` round trips an optimizer's state dict between the
    eager and the capturable mode (a K = 1 checkpoint resumes at K > 1 and
    back) without changing what the next steps compute;
  * ``flatten``/``unflatten`` and the capture key of ``core/graphs.py``
    (numpy leaves keyed by shape and dtype, as tensors are: chunks of numpy
    draws of one shape capture once);
    ``seeded_init`` (layer inits drawn from the seed, the caller's stream
    untouched).
"""

import jax
import numpy as np
import pytest
import torch

from tacorl_tpu.callbacks.horizon_uncertainty import (
    IncreaseHorizonUncertainty as JaxIncreaseHorizonUncertainty,
)
from tacorl_tpu.modules.cql import CQLModule as JaxCQLModule
from tacorl_tpu.utils import stable_fold
from tacorl_tpu_torch import train
from tacorl_tpu_torch.callbacks.horizon_uncertainty import CHUNK_FAULT, IncreaseHorizonUncertainty
from tacorl_tpu_torch.core.graphs import StepGraph, _addresses, _inputs, _signature, seed_generators, step_seed
from tacorl_tpu_torch.core.optimizers import GroupOptimizer, set_capturable, torch_optimizers
from tacorl_tpu_torch.data.loader import flatten, unflatten
from tacorl_tpu_torch.modules.cql import CQLModule
from tacorl_tpu_torch.utils.convert import cql_state_dict_from_jax
from tests.test_torch_cql import _cfg as image_cfg
from tests.test_torch_cql import _batch as image_batch
from tests.test_torch_cql import np_tree
from tests.test_torch_cql_flat import B, jax_dropout_mask, vector_batch, vector_cfg
from tests.test_torch_horizon_uncertainty import TINY_NETS, tiny_play  # noqa: F401 (a fixture)

K, PASSES = 2, 2


def _stack(batches):
    return jax.tree.map(lambda *xs: np.stack(xs), *batches)


def test_mc_std_on_a_vector_chunk_matches_jax():
    jmod = JaxCQLModule(vector_cfg(dropout=True))
    chunk = _stack([vector_batch(seed=s) for s in range(K)])
    jstate = jmod.init_state(jax.random.key(2), vector_batch(0))
    key = jax.random.key(11)
    want = float(JaxIncreaseHorizonUncertainty(forward_passes=PASSES)._build_mc_fn(jmod)(
        jstate.params, chunk, key
    ))
    # flax draws a (K, B, hidden) mask as the (K * B, hidden) one, reshaped
    masks = [
        jax_dropout_mask(
            jmod, jstate.params[name], jax.random.fold_in(key, i * 2 + stable_fold(name) % 97), K * B
        ).reshape(K, B, -1)
        for i in range(PASSES) for name in ("q1", "q2")
    ]
    pmod = CQLModule(vector_cfg(dropout=True), device="cpu")
    pstate = pmod.init_state(0)
    pmod.net.load_state_dict(cql_state_dict_from_jax(np_tree(jstate.params), np_tree(jstate.aux), ()))
    got = IncreaseHorizonUncertainty(forward_passes=PASSES).mc_std(pmod, pstate.net, chunk, masks=masks)
    assert want > 0
    np.testing.assert_allclose(float(got), want, rtol=1e-5)


def test_an_image_chunk_fails_in_jax_and_raises_in_the_port():
    cfg = image_cfg()
    cfg["q_network"]["with_dropout"] = True
    jmod = JaxCQLModule(cfg)
    chunk = _stack([image_batch(s) for s in range(K)])
    jstate = jmod.init_state(jax.random.key(2), image_batch(0))
    with pytest.raises(TypeError, match="convolution requires lhs and rhs ndim to be equal"):
        JaxIncreaseHorizonUncertainty(forward_passes=PASSES)._build_mc_fn(jmod)(
            jstate.params, chunk, jax.random.key(0)
        )

    class Trainer:
        _current_batch = {k: torch.as_tensor(v) if not isinstance(v, dict) else v for k, v in chunk.items()}
        datamodule = type("DM", (), {"train_dataset": type("DS", (), {
            "goal_strategy_prob": {"increasing_horizon": 1.0}})()})()

    with pytest.raises(NotImplementedError, match="ROADMAP Queue 3"):
        IncreaseHorizonUncertainty().on_train_batch_end(Trainer(), None, {}, K)


def test_train_main_raises_the_chunk_fault_on_images(tiny_play, tmp_path):  # noqa: F811
    with pytest.raises(NotImplementedError) as err:
        train.main([
            "experiment=cql_fake", f"data_dir={tiny_play}", f"run_dir={tmp_path}",
            "callbacks/increase_horizon=uncertainty", "module.q_network.with_dropout=true",
            "trainer.steps_per_call=2", "trainer.max_steps=4", *TINY_NETS,
        ])
    assert str(err.value) == CHUNK_FAULT


# -- optimizer modes ------------------------------------------------------------------------


def _adam_run(switch_at=None, steps=4):
    """Adam on a tiny regression; at ``switch_at`` its state dict is saved
    in capturable mode and loaded into a fresh eager optimizer."""
    torch.manual_seed(0)
    w = torch.nn.Parameter(torch.randn(5, 3))
    opt = torch.optim.Adam([w], lr=1e-2)
    x = torch.randn(8, 5)
    for i in range(steps):
        if i == switch_at:
            set_capturable(opt, True)
            sd = opt.state_dict()
            assert sd["param_groups"][0]["capturable"] and sd["state"][0]["step"].dtype == torch.float32
            opt = torch.optim.Adam([w], lr=1e-2)
            opt.load_state_dict(sd)
            set_capturable(opt, False)
            assert not opt.param_groups[0]["capturable"]
        opt.zero_grad()
        ((x @ w) ** 2).mean().backward()
        opt.step()
    return w.detach(), opt


def test_an_optimizer_state_moves_between_modes_unchanged():
    whole, _ = _adam_run()
    switched, opt = _adam_run(switch_at=2)
    assert torch.equal(whole, switched)
    assert opt.state_dict()["state"][0]["step"].device.type == "cpu"


def test_set_capturable_reaches_every_group():
    params = {n: [torch.nn.Parameter(torch.zeros(2))] for n in ("actor", "q1")}
    opt = GroupOptimizer({n: (p, 1e-3, None) for n, p in params.items()})
    assert len(torch_optimizers(opt)) == 2
    set_capturable(opt, True)
    assert all(g["capturable"] for o in torch_optimizers(opt) for g in o.param_groups)


# -- the graph helpers' host side ---------------------------------------------------------


def test_flatten_round_trips_a_nested_batch():
    tree = {"batch": {"obs": {"rgb": torch.zeros(2, 3)}, "actions": torch.ones(2)}, "draws": {}}
    pairs = flatten(tree)
    assert [p for p, _ in pairs] == [("batch", "obs", "rgb"), ("batch", "actions")]
    back = unflatten(pairs)
    assert back["batch"]["obs"]["rgb"] is tree["batch"]["obs"]["rgb"]


def test_the_capture_key_follows_shapes_and_dtypes():
    a = flatten({"x": torch.zeros(2, 3), "n": 4})
    assert _signature(a) == _signature(flatten({"x": torch.ones(2, 3), "n": 4}))
    assert _signature(a) != _signature(flatten({"x": torch.zeros(3, 3), "n": 4}))
    assert _signature(a) != _signature(flatten({"x": torch.zeros(2, 3, dtype=torch.float64), "n": 4}))
    assert _signature(a) != _signature(flatten({"x": torch.zeros(2, 3), "n": 5}))


def test_numpy_leaves_are_keyed_by_shape_and_dtype():
    a = _signature(_inputs({"x": np.zeros((2, 3), np.float32)}, {"aug": np.zeros(2)}))
    assert a == _signature(_inputs({"x": np.ones((2, 3), np.float32)}, {"aug": np.full(2, 7.0)}))
    assert a != _signature(_inputs({"x": np.ones((3, 3), np.float32)}, {"aug": np.zeros(2)}))
    assert a != _signature(_inputs({"x": np.ones((2, 3), np.float64)}, {"aug": np.zeros(2)}))


def test_chunks_of_numpy_draws_of_one_shape_capture_once(monkeypatch):
    """StepGraph's keying and input copies on the CPU, the capture itself
    (which needs a card) replaced by one that builds the static inputs."""

    def capture(self, state, pairs, scalars, key):
        self.inputs = [x.clone() if torch.is_tensor(x) else None for _, x in pairs]
        self.scalars = {k: torch.zeros(()) for k in scalars}
        self.graph = type("Graph", (), {"replay": lambda graph: None})()
        self.metrics, self.key = {}, key
        self.addresses = _addresses(state)  # where the net's tensors were captured
        self.captures += 1

    monkeypatch.setattr(StepGraph, "_capture", capture)
    module = type("M", (), {"device": torch.device("cpu"), "generator": torch.Generator()})()
    graph, state = StepGraph(module, None), type("S", (), {"step": 0, "net": torch.nn.Linear(3, 2)})()
    rng = np.random.default_rng(0)
    for i in range(3):
        draws = {"aug": rng.random((4, 2)).astype(np.float32)}
        graph(state, {"obs": rng.random((4, 3))}, {"kl_beta": 0.1 * i}, draws, seed=0, index=i)
        assert graph.captures == 1 and graph.replays == i + 1 and state.step == i + 1
        assert torch.equal(graph.inputs[1], torch.as_tensor(draws["aug"]))
        assert float(graph.scalars["kl_beta"]) == np.float32(0.1 * i)
    graph(state, {"obs": rng.random((5, 3))}, {"kl_beta": 0.0}, draws, seed=0, index=3)
    assert graph.captures == 2


def test_seed_generators_seeds_both_generators_from_the_step():
    module = type("M", (), {"generator": torch.Generator()})()
    seed_generators(module, torch.device("cpu"), 3, 7)
    a = (torch.rand(2, generator=module.generator), torch.rand(2))
    module.generator.manual_seed(step_seed(3, 7))
    torch.manual_seed(step_seed(3, 7))
    b = (torch.rand(2, generator=module.generator), torch.rand(2))
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_seeded_init_seeds_the_cpu_generator_and_restores_it():
    from tacorl_tpu_torch.modules.base import seeded_init

    torch.manual_seed(123)
    before = torch.random.get_rng_state()
    with seeded_init(5, torch.device("cpu")):
        a = torch.rand(3)
    assert torch.equal(torch.random.get_rng_state(), before)
    torch.manual_seed(5)
    assert torch.equal(a, torch.rand(3))
