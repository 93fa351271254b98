"""The references against the program on the CPU at tiny widths, element
by element: each step's losses, the first step's gradients as the
optimizers get them (the program's from its Adam moments after one step)
and every parameter after three steps, through the harness's own run of
``tacorl_tpu_torch.train.main`` (float32 augmentation and convolutions,
so that the two agree to float32 rounding). Stage 2 runs in both of its
actor phases: behaviour cloning (the configuration's first ``bc_epochs``
epochs, where the cell's compared steps fall) and CQL's policy improvement
through the critics (``bc_epochs`` 0)."""

import time

import pytest
import torch

from perfbench import compare, harness
from perfbench.reference import tacorl
from perfbench.tests.tiny import lmp_cell, tacorl_cell


def _cql_phase_cell():
    workload, config = tacorl_cell()
    config["sizes"]["bc_epochs"] = 0
    config["overrides"] = list(config["overrides"]) + ["module.bc_epochs=0"]
    return workload, config


def _program_and_reference(tiny_store, cell, name):
    workload, config = cell()
    config["limits"] = {k: 1e-4 for k in config["limits"]}
    r = harness.run(name, 20221018, 0.2, False, time.perf_counter(), device="cpu", workload=workload,
                    config=config, data_cache=tiny_store, metrics=[], evidence=True)
    assert r["correct"], r["checks"]
    e = r["evidence"]
    return e["program"], e["reference"], e["start"]


@pytest.mark.parametrize("cell,name", [(lmp_cell, "lmp_k16_b64"), (tacorl_cell, "tacorl_k8_b64"),
                                       (_cql_phase_cell, "tacorl_k8_b64")],
                         ids=["play_lmp", "tacorl", "tacorl_cql_phase"])
def test_losses_gradients_and_adam_steps_agree(tiny_store, cell, name):
    program, ref, start = _program_and_reference(tiny_store, cell, name)
    for k, values in ref["losses"].items():
        scale = float(values.abs().max())
        for i, v in enumerate(values):
            assert float(program["losses"][i + 1][k]) == pytest.approx(float(v), abs=1e-5 * scale), (k, i)
    assert set(program["moments"]) == set(ref["grads"])
    for n, g in ref["grads"].items():
        torch.testing.assert_close(program["moments"][n] / (1 - program["beta1"]), g, rtol=1e-4, atol=1e-6,
                                   msg=n)
    for n, p in ref["params"].items():
        moved = (p - start[n]).abs().max()
        # Adam moves a leaf with a gradient near round-off by up to lr a step
        # on either side: 1 % of the largest move (3 steps of lr) bounds it
        torch.testing.assert_close(program["params"][n], p, rtol=0, atol=1e-2 * float(moved) + 1e-9, msg=n)


def test_the_cql_phase_trains_the_actor_through_the_critics(tiny_store):
    """In the CQL phase the actor's loss reaches the gradient through both
    critics' minimum: the phases' actor gradients differ, so the case
    above holds the critics' term, which the behaviour-cloning phase
    multiplies by 0."""
    grads = {}
    for cell in (tacorl_cell, _cql_phase_cell):
        workload, config = cell()
        sizes = config["sizes"]
        weights = tacorl.weights(sizes, 7, torch.device("cpu"))["full"]
        batches = tacorl.batches(harness.data.ensure_store(config["dataset"], cache=tiny_store), sizes, 7, 1,
                                 torch.device("cpu"))
        grads[sizes["bc_epochs"]] = tacorl.train_steps(weights, batches, sizes, 7, 0)["grads"]
    actor = [n for n in grads[0] if n.startswith("actor.actor.")]
    assert actor and all(not torch.equal(grads[0][n], grads[5][n]) for n in actor)


@pytest.mark.parametrize("cell", [lmp_cell, tacorl_cell], ids=["play_lmp", "tacorl"])
def test_the_control_trains_every_leaf_the_reference_trains(tiny_store, cell):
    """The control rounds the low-precision ops' operands and not their
    gradients: each leaf the float32 reference moves moves in the control
    too, by about as much."""
    workload, config = cell()
    sizes = config["sizes"]
    reference = harness.importlib.import_module(f"perfbench.reference.{config['reference']}")
    store = harness.data.ensure_store(config["dataset"], cache=tiny_store)
    weights = reference.weights(sizes, 11, torch.device("cpu"))["full"]
    batches = reference.batches(store, sizes, 11, harness.SNAP_STEPS, torch.device("cpu"))
    ref = reference.train_steps(weights, batches, sizes, 11, 0, "f32")
    low = reference.train_steps(weights, batches, sizes, 11, 0, "control")
    for n, g in ref["grads"].items():
        if float(g.abs().max()) > 0:
            moved = compare.norm(ref["params"][n] - weights[n])
            assert compare.norm(low["params"][n] - weights[n]) == pytest.approx(moved, rel=0.5), n
