"""The port's scanned K-step dispatch (``make_scanned_train_step``) on the
CPU, where it loops the eager step:

  * K = 3 scanned steps against three single steps seeded as the trainer
    seeds them: bit-equal (Play-LMP with its generator's own draws, and
    with the posterior's dropout on);
  * against the JAX package's ``make_scanned_train_step`` (a ``lax.scan``
    over the stacked batch) from converted weights, with the draws of the
    JAX step at each step of the chunk (its key folded with
    ``state.step``): Play-LMP and TACO-RL here, the others in
    test_torch_scanned_step_cql_ril_d4rl.py. The last step's metrics at
    rtol 1e-5, the params after the chunk at atol 2.5 lr per step;
  * a K = 1 chunk against one step;
  * SAC and CQL-online refuse to scan, as the JAX modules do.

The JAX steps run their Pallas jitter tail in interpret mode."""

import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tacorl_tpu.core.checkpoint import CheckpointManager as JaxCheckpointManager
from tacorl_tpu.modules.cql import CQLModule as JaxCQLModule
from tacorl_tpu.modules.play_lmp import PlayLMPModule as JaxPlayLMPModule
from tacorl_tpu.modules.play_lmp_d4rl import PlayLMPD4RLModule as JaxPlayLMPD4RLModule
from tacorl_tpu.modules.ril import RILModule as JaxRILModule
from tacorl_tpu.modules.sac import SACModule as JaxSACModule
from tacorl_tpu.modules.tacorl import TACORLModule as JaxTACORLModule
from tacorl_tpu.modules.tacorl_d4rl import TACORLD4RLModule as JaxTACORLD4RLModule
from tacorl_tpu.ops import pallas_aug
from tacorl_tpu_torch.core.checkpoint import CheckpointManager
from tacorl_tpu_torch.core.graphs import seed_generators
from tacorl_tpu_torch.modules.cql import CQLModule
from tacorl_tpu_torch.modules.cql_online import CQLOnlineModule
from tacorl_tpu_torch.modules.play_lmp import PlayLMPModule
from tacorl_tpu_torch.modules.play_lmp_d4rl import PlayLMPD4RLModule
from tacorl_tpu_torch.modules.ril import LEAVES, RILModule
from tacorl_tpu_torch.modules.sac import SACModule
from tacorl_tpu_torch.modules.tacorl import TACORLModule
from tacorl_tpu_torch.modules.tacorl_d4rl import TACORLD4RLModule
from tacorl_tpu_torch.utils.convert import (
    cql_state_dict_from_jax,
    play_lmp_d4rl_state_dict_from_jax,
    play_lmp_state_dict_from_jax,
    ril_state_dict_from_jax,
    tacorl_d4rl_state_dict_from_jax,
    tacorl_state_dict_from_jax,
)
from tests import test_torch_cql_flat as flat
from tests import test_torch_d4rl as d4rl
from tests import test_torch_play_lmp as lmp
from tests import test_torch_ril as ril
from tests import test_torch_tacorl as taco
from tests.test_torch_cql import _t, aug_draws, cql_draws, leaf_key, np_tree
from tests.test_torch_trainer import train_draws
from tests.torch_threads import share_cores

share_cores()  # the xdist workers share the cores

K, SEED = 3, 0


@contextlib.contextmanager
def interpret_pallas():
    tail = pallas_aug.pallas_augment_tail
    pallas_aug.pallas_augment_tail = functools.partial(tail, interpret=True)
    try:
        yield
    finally:
        pallas_aug.pallas_augment_tail = tail


def _stack(batches):
    return jax.tree.map(lambda *xs: np.stack(xs), *batches)


def _key(step):
    """The JAX train step's key at ``step``: the scan's key folded with the
    state's step."""
    return jax.random.fold_in(jax.random.key(SEED), step)


# -- each module: JAX module and state, port module, batches, scalars and the
# -- port draws of JAX's step at a global step ------------------------------------


def _play_lmp(tmp):
    batches = [lmp._batch(i) for i in range(K)]
    jmod = JaxPlayLMPModule(lmp._cfg())
    jstate = jmod.init_state(jax.random.key(1), batches[0])
    pmod = PlayLMPModule(lmp._cfg(), device="cpu")
    pstate = pmod.init_state(0)
    pmod.net.load_state_dict(play_lmp_state_dict_from_jax(np_tree(jstate.params)))
    return dict(
        jmod=jmod, jstate=jstate, pmod=pmod, pstate=pstate, batches=batches,
        scalars={"kl_beta": 1e-3}, lr=lmp.LR,
        draws=lambda g: train_draws(SEED, g, lmp.B * lmp.T),
        convert=lambda s: play_lmp_state_dict_from_jax(np_tree(s.params)),
    )


def _lmp_dirs(tmp, cfg, jax_cls, port_cls, convert, batch):
    """A JAX stage-1 checkpoint and the same weights as a port checkpoint."""
    jmod = jax_cls(dict(cfg))
    jstate = jax.jit(jmod.init_state)(jax.random.key(2), batch)
    jax_dir, port_dir = tmp / "jax_lmp", tmp / "port_lmp"
    JaxCheckpointManager(jax_dir, config={"module": dict(cfg)}).save(int(jstate.step), jstate)
    pmod = port_cls(dict(cfg), device="cpu")
    pstate = pmod.init_state(0)
    pmod.net.load_state_dict(convert(np_tree(jstate.params)))
    CheckpointManager(port_dir, config={"module": cfg}).save(0, pstate)
    return jax_dir, port_dir


def _tacorl(tmp):
    batches = [taco._batch(i) for i in range(K)]
    first = batches[0]
    jax_dir, port_dir = _lmp_dirs(
        tmp, taco._lmp_cfg(), JaxPlayLMPModule, PlayLMPModule, play_lmp_state_dict_from_jax,
        {"states": first["states"], "actions": first["actions"]},
    )
    jmod = JaxTACORLModule(taco._tacorl_cfg(jax_dir))
    jstate = jmod.init_state(jax.random.key(1), first)
    pmod = TACORLModule(taco._tacorl_cfg(port_dir), device="cpu")
    pstate = pmod.init_state(0)
    pmod.net.load_state_dict(tacorl_state_dict_from_jax(np_tree(jstate.params), np_tree(jstate.aux)))

    def draws(g):
        k_aug, k_plan, k_cql = jax.random.split(_key(g), 3)
        d = cql_draws(k_cql, taco.B, taco.N_ACT, taco.LATENT, discrete_gripper=False)
        d["aug_states"] = {"rgb_static": aug_draws(leaf_key(k_aug, "rgb_static"), taco.B * taco.T)}
        d["aug_goal"] = {"rgb_static": aug_draws(leaf_key(jax.random.fold_in(k_aug, 1), "rgb_static"), taco.B)}
        d["plan_eps"] = _t(jax.random.normal(k_plan, (taco.B, taco.LATENT)))
        return {"draws": d}

    return dict(
        jmod=jmod, jstate=jstate, pmod=pmod, pstate=pstate, batches=batches,
        scalars={"bc_phase": 0.0}, lr=taco.LR, draws=draws,
        convert=lambda s: tacorl_state_dict_from_jax(np_tree(s.params), np_tree(s.aux)),
    )


def _flat(cfg_fn, batch_fn):
    def build(tmp):
        batches = [batch_fn(i) for i in range(K)]
        jmod = JaxCQLModule(cfg_fn())
        jstate = jmod.init_state(jax.random.key(1), batches[0])
        pmod = CQLModule(cfg_fn(), device="cpu")
        pstate = pmod.init_state(0)
        pmod.net.load_state_dict(cql_state_dict_from_jax(np_tree(jstate.params), np_tree(jstate.aux), ()))
        return dict(
            jmod=jmod, jstate=jstate, pmod=pmod, pstate=pstate, batches=batches,
            scalars={"bc_phase": 0.0}, lr=flat.LR,
            draws=lambda g: {"draws": flat.step_draws(jmod, None, _key(g), aug=False)},
            convert=lambda s: cql_state_dict_from_jax(np_tree(s.params), np_tree(s.aux), ()),
        )

    return build


def _ril(tmp):
    batches = [ril.visual_batch(i) for i in range(K)]
    jmod = JaxRILModule(ril.visual_cfg())
    jstate = jax.jit(jmod.init_state)(jax.random.key(1), batches[0])
    pmod = RILModule(ril.visual_cfg(), device="cpu")
    pstate = pmod.init_state(0)
    mods = ("rgb_static",)
    pmod.net.load_state_dict(ril_state_dict_from_jax(np_tree(jstate.params), mods))
    return dict(
        jmod=jmod, jstate=jstate, pmod=pmod, pstate=pstate, batches=batches, scalars={}, lr=ril.LR,
        draws=lambda g: {"draws": {
            leaf: {m: aug_draws(leaf_key(_key(g), leaf, m), ril.B, ril.PAD) for m in mods} for leaf in LEAVES
        }},
        convert=lambda s: ril_state_dict_from_jax(np_tree(s.params), mods),
    )


def _d4rl_lmp_draws(g):
    _, k_loss = jax.random.split(_key(g))
    k_plan, k_rand, _ = jax.random.split(k_loss, 3)
    return {
        "eps": _t(jax.random.normal(k_plan, (d4rl.B, d4rl.LATENT))),
        "random_plan": _t(jax.random.uniform(k_rand, (d4rl.B, d4rl.LATENT), minval=-1.0, maxval=1.0)),
    }


def _d4rl_batches(tmp):
    return [d4rl._batch(seed=i, tmp=tmp / f"data{i}") for i in range(K)]


def _play_lmp_d4rl(tmp):
    batches = _d4rl_batches(tmp)
    jmod = JaxPlayLMPD4RLModule(d4rl.lmp_cfg())
    jstate = jmod.init_state(jax.random.key(1), batches[0])
    pmod = PlayLMPD4RLModule(d4rl.lmp_cfg(), device="cpu")
    pstate = pmod.init_state(0)
    pmod.net.load_state_dict(play_lmp_d4rl_state_dict_from_jax(np_tree(jstate.params)))
    return dict(
        jmod=jmod, jstate=jstate, pmod=pmod, pstate=pstate, batches=batches,
        scalars={"kl_beta": 1e-2}, lr=d4rl.LR, draws=_d4rl_lmp_draws,
        convert=lambda s: play_lmp_d4rl_state_dict_from_jax(np_tree(s.params)),
    )


def _tacorl_d4rl(tmp):
    batches = _d4rl_batches(tmp)
    jax_dir, port_dir = _lmp_dirs(
        tmp, d4rl.lmp_cfg(), JaxPlayLMPD4RLModule, PlayLMPD4RLModule, play_lmp_d4rl_state_dict_from_jax,
        batches[0],
    )
    jmod = JaxTACORLD4RLModule(d4rl.tacorl_cfg(jax_dir))
    jstate = jmod.init_state(jax.random.key(1), batches[0])
    pmod = TACORLD4RLModule(d4rl.tacorl_cfg(port_dir), device="cpu")
    pstate = pmod.init_state(0)
    pmod.net.load_state_dict(tacorl_d4rl_state_dict_from_jax(np_tree(jstate.params), np_tree(jstate.aux)))

    def draws(g):
        k_plan, k_cql = jax.random.split(_key(g))
        d = cql_draws(k_cql, d4rl.B, d4rl.N_ACT, d4rl.LATENT, discrete_gripper=False)
        d["plan_eps"] = _t(jax.random.normal(k_plan, (d4rl.B, d4rl.LATENT)))
        return {"draws": d}

    return dict(
        jmod=jmod, jstate=jstate, pmod=pmod, pstate=pstate, batches=batches,
        scalars={"bc_phase": 0.0}, lr=d4rl.LR, draws=draws,
        convert=lambda s: tacorl_d4rl_state_dict_from_jax(np_tree(s.params), np_tree(s.aux)),
    )


CASES = {
    "play_lmp": _play_lmp,
    "tacorl": _tacorl,
    "cql_vector": _flat(flat.vector_cfg, flat.vector_batch),
    "cql_state_based": _flat(flat.state_cfg, flat.state_batch),
    "ril": _ril,
    "play_lmp_d4rl": _play_lmp_d4rl,
    "tacorl_d4rl": _tacorl_d4rl,
}
# the visual stages here; the others in test_torch_scanned_step_cql_ril_d4rl.py
# (each file's JAX compiles stay well under a minute)
HERE = ("play_lmp", "tacorl")


def scanned_pair_of(name, tmp):
    """The JAX scanned step and the port's over one stacked chunk of K
    batches, from the same weights, with the JAX step's draws."""
    case = CASES[name](tmp)
    stacked = _stack(case["batches"])
    jscalars = {k: jnp.asarray(v, dtype=jnp.float32) for k, v in case["scalars"].items()}
    with interpret_pallas():
        jstate, jmetrics = case["jmod"].make_scanned_train_step()(
            case["jstate"], stacked, jax.random.key(SEED), jscalars
        )
        jax.block_until_ready(jstate.params)
    pstate, pmetrics = case["pmod"].make_scanned_train_step()(
        case["pstate"], stacked, case["scalars"], seed=SEED,
        draw_source=lambda split, g: case["draws"](g),
    )
    return dict(case, jax_state=jstate, jax_metrics=jmetrics, port_state=pstate, port_metrics=pmetrics)


def check_chunk_steps(pair):
    assert pair["port_state"].step == int(pair["jax_state"].step) == K


def check_metrics(pair):
    got, want = pair["port_metrics"], pair["jax_metrics"]
    assert set(got) == set(want)
    for name, v in want.items():
        # rtol 1e-5: float32 sums taken in another order
        np.testing.assert_allclose(float(got[name]), float(v), rtol=1e-5, atol=1e-7, err_msg=name)


def check_params(pair):
    sd = pair["port_state"].net.state_dict()
    want = pair["convert"](pair["jax_state"])
    assert set(want) <= set(sd)
    for name, w in want.items():
        # the step tests' 2.5 lr per step, over the chunk's K steps
        np.testing.assert_allclose(sd[name].numpy(), w.numpy(), atol=K * 2.5 * pair["lr"], rtol=0, err_msg=name)


@pytest.fixture(scope="module", params=HERE)
def scanned_pair(request, tmp_path_factory):
    return scanned_pair_of(request.param, tmp_path_factory.mktemp(request.param))


def test_the_chunk_ends_k_steps_on(scanned_pair):
    check_chunk_steps(scanned_pair)


def test_last_step_metrics_match_jax(scanned_pair):
    check_metrics(scanned_pair)


def test_params_after_the_chunk_match_jax(scanned_pair):
    check_params(scanned_pair)


# -- the port against its own single steps ------------------------------------------------


def _dropout_cfg():
    cfg = lmp._cfg()
    cfg["plan_recognition"]["dropout_p"] = 0.1
    return cfg


def _singles(module, state, batches, scalars, seed):
    step = module.make_train_step()
    for g, batch in enumerate(batches):
        seed_generators(module, module.device, seed, g)
        state, metrics = step(state, batch, scalars)
    return state, metrics


@pytest.mark.parametrize("cfg_fn", [lmp._cfg, _dropout_cfg], ids=["draws", "dropout"])
def test_k_scanned_steps_are_bit_equal_to_k_single_steps(cfg_fn):
    """Without explicit draws: the module's generator and the dropout masks
    come from the per-step seeding in both."""
    batches = [lmp._batch(i) for i in range(K)]
    a, b = PlayLMPModule(cfg_fn(), device="cpu"), PlayLMPModule(cfg_fn(), device="cpu")
    sa, ma = _singles(a, a.init_state(0), batches, {"kl_beta": 1e-3}, seed=5)
    sb, mb = b.make_scanned_train_step()(b.init_state(0), _stack(batches), {"kl_beta": 1e-3}, seed=5)
    assert sa.step == sb.step == K and b.make_scanned_train_step().graph is None
    assert all(torch.equal(ma[k], mb[k]) for k in ma)
    da, db = sa.net.state_dict(), sb.net.state_dict()
    assert all(torch.equal(da[k], db[k]) for k in da)
    oa, ob = sa.optimizer.state_dict()["state"], sb.optimizer.state_dict()["state"]
    assert all(torch.equal(oa[i]["exp_avg"], ob[i]["exp_avg"]) for i in oa)


def test_a_one_step_chunk_is_one_step():
    batch = lmp._batch(0)
    a, b = PlayLMPModule(lmp._cfg(), device="cpu"), PlayLMPModule(lmp._cfg(), device="cpu")
    sa, ma = _singles(a, a.init_state(0), [batch], {"kl_beta": 1e-3}, seed=1)
    sb, mb = b.make_scanned_train_step()(b.init_state(0), _stack([batch]), {"kl_beta": 1e-3}, seed=1)
    assert sa.step == sb.step == 1
    assert all(torch.equal(ma[k], mb[k]) for k in ma)
    assert all(torch.equal(v, sb.net.state_dict()[k]) for k, v in sa.net.state_dict().items())


def test_a_chunk_reads_its_scalars_from_the_call():
    """kl_beta given to the call reaches every step of the chunk."""
    batches = [lmp._batch(i) for i in range(2)]
    mod = PlayLMPModule(lmp._cfg(), device="cpu")
    _, m = mod.make_scanned_train_step()(mod.init_state(0), _stack(batches), {"kl_beta": 0.5})
    np.testing.assert_allclose(float(m["kl_loss_scaled"]), 0.5 * float(m["kl_loss"]), rtol=1e-6)


# -- online modules -------------------------------------------------------------------------


def _online_cfg():
    cfg = flat.state_cfg()
    cfg["warm_start_steps"] = 0
    return cfg


@pytest.mark.parametrize("cls", [SACModule, CQLOnlineModule])
def test_online_modules_refuse_to_scan_as_jax_does(cls):
    with pytest.raises(RuntimeError, match="cannot be scanned") as jax_err:
        JaxSACModule(_online_cfg()).make_scanned_train_step()
    module = cls(_online_cfg(), device="cpu")
    assert module.supports_scan is False
    with pytest.raises(RuntimeError, match="interacts with the environment inside its train step") as err:
        module.make_scanned_train_step()
    assert str(err.value) == str(jax_err.value).replace("SACModule", cls.__name__)
