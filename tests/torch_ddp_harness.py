"""The harness of the data-parallel step tests (tests/test_torch_ddp*.py):
two gloo ranks (spawned by ``torch.multiprocessing``, joined through a
file store; the ranks import only ``tacorl_tpu_torch``:
tests/torch_ddp_child.py) each take their rows of a global batch of 4 for
two steps, held

  * against one port rank on the whole batch, from the same weights: with
    the JAX step's draws given (each rank slices its rows of them) and
    with the module's own draws (each rank draws its rows of the global
    draw, ``parallel.mesh.sharded_draws``);
  * against the JAX step on a ``create_mesh(dp=2)`` mesh of two of the
    test's CPU devices, with those draws.

Rank 1 starts from other weights: the broadcast from rank 0 replaces
them. Tolerances are the parity tests': every metric at rtol 1e-5, the
parameters at atol 2.5 lr a step."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from tacorl_tpu.parallel.mesh import create_mesh, replicated_sharding, shard_batch
from tacorl_tpu_torch.parallel.mesh import BatchShard
from tacorl_tpu_torch.utils.convert import cql_state_dict_from_jax
from tests import test_torch_cql_flat as flat
from tests import test_torch_online_rl as online
from tests import test_torch_play_lmp as lmp
from tests import test_torch_ril as ril
from tests import test_torch_scanned_step as scan
from tests import test_torch_tacorl as taco
from tests import torch_ddp_child as child
from tests.test_torch_cql import actor_draws, np_tree

WORLD, STEPS, B = 2, 2, 4
PATH = {
    "play_lmp": "tacorl_tpu_torch.modules.play_lmp.PlayLMPModule",
    "tacorl": "tacorl_tpu_torch.modules.tacorl.TACORLModule",
    "cql_vector": "tacorl_tpu_torch.modules.cql.CQLModule",
    "ril": "tacorl_tpu_torch.modules.ril.RILModule",
}


def _sac_case():
    """The JAX SAC module on a filled buffer and the port's, from the same
    weights; the batch is one global sample; the draws are the JAX step's
    at each step, its play step's included."""
    cfg = online._cfg("vector", "sac")
    jmod = online.JaxSACModule(cfg)
    jmod.populate(None, steps=8)
    batch = jmod.replay_buffer.sample(B, np.random.default_rng(5))
    jstate = jmod.init_state(jax.random.key(1), batch)
    sd0 = cql_state_dict_from_jax(np_tree(jstate.params), np_tree(jstate.aux), ())
    play_keys = []  # each JAX step's play key, filled as the JAX steps run

    def draws(g):
        d = online.step_draws(scan._key(g), visual=False)
        d["play"] = {"action": actor_draws(play_keys[g], (1,), 7, True)}
        return {"draws": d}

    return dict(jmod=jmod, jstate=jstate, sd0=sd0, batches=[batch] * STEPS, scalars={"bc_phase": 0.0},
                lr=online.LR, draws=draws, cls="tacorl_tpu_torch.modules.sac.SACModule", cfg=cfg, populate=8,
                n=online.N_ACT, play_keys=play_keys,
                convert=lambda s: cql_state_dict_from_jax(np_tree(s.params), np_tree(s.aux), ()))


def _jitted(init_state):
    """A JAX module's ``init_state`` compiled as one program (flax's init
    op by op takes seconds a module on the CPU)."""
    return lambda self, rng, batch: jax.jit(functools.partial(init_state, self))(rng, batch)


def _widen(tree):
    """The parity tests' fixed 3-row leaves (rewards, terminals, disp)
    repeated to the batch of 4."""
    if isinstance(tree, dict):
        return {k: _widen(v) for k, v in tree.items()}
    return np.resize(tree, (B,) + tree.shape[1:]) if tree.shape[0] == 3 else tree


def _jax_steps(case):
    """The JAX steps on a dp=2 mesh: the state replicated, each batch
    sharded over the two devices."""
    mesh = create_mesh(dp=WORLD, mp=1, devices=jax.devices()[:WORLD])
    jmod, jstate = case["jmod"], jax.device_put(case["jstate"], replicated_sharding(mesh))
    step = jmod.make_train_step()
    scalars = {k: jnp.asarray(v, dtype=jnp.float32) for k, v in case["scalars"].items()}
    rows = []
    with scan.interpret_pallas():
        for g, batch in enumerate(case["batches"]):
            if "play_keys" in case:
                case["play_keys"].append(jax.random.split(jmod._play_key)[1])
            jstate, metrics = step(jstate, shard_batch(batch, mesh), jax.random.key(scan.SEED), scalars)
            rows.append({k: float(v) for k, v in metrics.items()})
    return rows, case["convert"](jstate)


def modes(families, drawn):
    """(family, mode) pairs: the JAX step's draws for each family, the
    module's own draws for those in ``drawn``."""
    return [(n, m) for n in families for m in ("given", "drawn") if m == "given" or n in drawn]


def run_families(root, families, drawn):
    """Every family's JAX dp=2 steps, one port rank's and the two ranks',
    with the JAX step's draws and, for the families in ``drawn``, with the
    module's own."""
    by_name = {n: [m for k, m in modes(families, drawn) if k == n] for n in families}
    with pytest.MonkeyPatch.context() as patch:
        for module in (lmp, taco, flat, ril):
            patch.setattr(module, "B", B)  # a batch the two ranks split
        for cls in (scan.JaxPlayLMPModule, scan.JaxTACORLModule, scan.JaxCQLModule, online.JaxSACModule):
            patch.setattr(cls, "init_state", _jitted(cls.init_state))
        specs, want = {}, {}
        for name in families:
            if name == "sac":
                case = _sac_case()
            else:
                case = scan.CASES[name](root / name)
                case["batches"] = [_widen(batch) for batch in case["batches"][:STEPS]]
                if name == "play_lmp":  # the val step hands the rows' indices on
                    for batch in case["batches"]:
                        batch["idx"] = np.arange(B)
                case.update(sd0=case["pmod"].net.state_dict(), cls=PATH[name], cfg=case["pmod"].cfg,
                            n=getattr(case["pmod"], "n_action_samples", 1))
            jax_rows, jax_sd = _jax_steps(case)
            specs[name] = {
                "cls": case["cls"], "cfg": case["cfg"], "sd0": {k: v.clone() for k, v in case["sd0"].items()},
                "batches": case["batches"], "draws": [case["draws"](g) for g in range(STEPS)],
                "scalars": case["scalars"], "n": case["n"], "populate": case.get("populate"),
                "modes": by_name[name],
            }
            want[name] = {"jax_rows": jax_rows, "jax_sd": jax_sd, "lr": case["lr"]}
    torch.save(specs, root / "specs.pt")
    mp.spawn(child.run_steps_job, args=(WORLD, str(root)), nprocs=WORLD, join=True)
    ranks = [torch.load(root / f"steps_{r}.pt", weights_only=False) for r in range(WORLD)]
    one = {(name, mode): child.run_steps(specs[name], mode == "given", BatchShard())
           for name in families for mode in by_name[name]}
    return {"ranks": ranks, "one": one, "want": want, "root": root}


def close_rows(got, want, what):
    assert len(got) == len(want) == STEPS, what
    for g, (a, b) in enumerate(zip(got, want)):
        assert set(a) == set(b), what
        for k in b:
            # rtol 1e-5: float32 sums taken in another order
            np.testing.assert_allclose(a[k], b[k], rtol=1e-5, atol=1e-7, err_msg=f"{what} step {g} {k}")


def close_params(got, want, lr, what):
    assert set(want) <= set(got), what
    for k, w in want.items():
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), atol=2.5 * lr * STEPS, rtol=0, err_msg=f"{what} {k}")


def check_ranks_agree(runs, name, mode):
    """Both ranks' metrics and final weights are the same, and the
    broadcast replaced rank 1's initial weights by rank 0's."""
    a, b = (r[(name, mode)] for r in runs["ranks"])
    assert a["replicated"] and b["replicated"]
    assert a["rows"] == b["rows"]
    for k, v in a["sd"].items():
        assert torch.equal(v, b["sd"][k]), k


def check_one_rank(runs, name, mode):
    """The two ranks' step metrics and, after the steps, their val step's
    (the module's own draws) against one rank's; the weights."""
    got, one = runs["ranks"][0][(name, mode)], runs["one"][(name, mode)]
    close_rows(got["rows"], one["rows"], f"{name}/{mode}")
    assert got["val"] and set(got["val"]) == set(one["val"])
    for k, v in one["val"].items():
        np.testing.assert_allclose(got["val"][k], v, rtol=1e-5, atol=1e-7, err_msg=f"{name}/{mode} val {k}")
    close_params(got["sd"], one["sd"], runs["want"][name]["lr"], f"{name}/{mode}")


def check_jax(runs, name):
    got, want = runs["ranks"][0][(name, "given")], runs["want"][name]
    close_rows(got["rows"], want["jax_rows"], name)
    close_params(got["sd"], want["jax_sd"], want["lr"], name)
