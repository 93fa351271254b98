"""Tensor parallelism on the CPU: the ``(dp, mp)`` mesh and
``shard_params_by_rule`` (``tacorl_tpu_torch/parallel/``) against the JAX
package's.

  * the port's ``PLAY_LMP_RULES`` select the leaves the JAX dry run's rules
    select (``__graft_entry__.py:dryrun_multichip``), mapped through the
    converter, at tiny and production widths; their refusals;
  * the mesh's layout: shapes, errors, a rank's rows (no process group);
  * gloo ranks (``torch.multiprocessing``, tests/torch_tp_child.py) at
    ``(dp, mp) = (1, 2)`` and ``(2, 2)``: the groups, the collectives over
    dp, the seeding, ``replicate`` of the shards; two steps of the tiny
    Play-LMP sharded by the rules against the JAX step on the matching
    ``create_mesh(dp, mp=2)`` mesh with the JAX ``shard_params_by_rule``,
    from the same converted weights with the JAX step's draws (every
    metric at rtol 1e-5, the gathered parameters at atol 2.5 lr a step,
    the replicated parameters bit-equal over the mp ranks of a row);
    checkpoints written at mp = 2 and read at mp = 1, and the reverse;
    ``Trainer(mesh=create_mesh(dp=1, mp=2))`` against one rank;
  * ``dryrun_multichip(4, device="cpu")``, the RL families included.

The JAX steps run their Pallas tail in interpret mode."""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as multiprocessing
from jax.sharding import PartitionSpec as P

import __graft_entry__ as graft
from tacorl_tpu.core.train_state import TrainState as JaxTrainState
from tacorl_tpu.parallel.mesh import create_mesh as jax_create_mesh
from tacorl_tpu.parallel.mesh import param_path_str, replicated_sharding, shard_batch
from tacorl_tpu.parallel.mesh import shard_params_by_rule as jax_shard_params_by_rule
from tacorl_tpu_torch import dryrun
from tacorl_tpu_torch.core.checkpoint import CheckpointManager
from tacorl_tpu_torch.modules.play_lmp import PlayLMPModule
from tacorl_tpu_torch.networks.layers import TorchDense
from tacorl_tpu_torch.parallel import mesh
from tacorl_tpu_torch.parallel.mesh import BatchShard, Mesh
from tacorl_tpu_torch.parallel.tensor_parallel import PLAY_LMP_RULES, shard_params_by_rule
from tacorl_tpu_torch.utils.convert import play_lmp_state_dict_from_jax
from tests import test_torch_play_lmp as lmp
from tests import test_torch_scanned_step as scan
from tests import torch_ddp_harness as ddp
from tests import torch_tp_child as child
from tests.torch_threads import share_cores

share_cores()  # the xdist workers share the cores

# __graft_entry__.py:dryrun_multichip's rules, verbatim
JAX_RULES = [
    (r"plan_recognition/.*TorchDense_0/kernel$", P(None, "mp")),
    (r"action_decoder/.*mean_fc/kernel$", P(None, "mp")),
    (r"action_decoder/.*log_scale_fc/kernel$", P(None, "mp")),
    (r"action_decoder/.*prob_fc/kernel$", P(None, "mp")),
]
STEPS, B, MP = 2, 4, 2
MESHES = [(1, 2), (2, 2)]


# -- the rules ---------------------------------------------------------------------


@pytest.mark.parametrize("tiny", [True, False])
def test_the_port_rules_select_the_jax_rules_leaves(tiny):
    """Each JAX leaf filled with its own index and converted: the port
    parameters the port's rules match are the converted JAX leaves the JAX
    rules match, one for one."""
    jmod = graft._module(tiny=tiny)
    shapes = jax.eval_shape(lambda k: jmod.init_state(k, graft._batch(2, 8, 48 if tiny else 128)).params,
                            jax.random.key(0))
    leaves, treedef = jax.tree_util.tree_flatten_with_path(shapes)
    marked = jax.tree_util.tree_unflatten(
        treedef, [np.full(leaf.shape, i, np.float32) for i, (_, leaf) in enumerate(leaves)])
    jax_hits = {i for i, (path, _) in enumerate(leaves)
                if any(re.search(pattern, param_path_str(path)) for pattern, _ in JAX_RULES)}
    converted = play_lmp_state_dict_from_jax(marked)
    port = dryrun._module("cpu", tiny=tiny)
    names = [n for n, _ in port.net.named_parameters()]
    assert set(names) <= set(converted)
    port_hits = {n for n in names if any(re.search(pattern, n) for pattern, _ in PLAY_LMP_RULES)}
    marks = {}
    for n in port_hits:
        values = converted[n].unique()
        assert values.numel() == 1, n
        marks[n] = int(values)
    assert sorted(marks.values()) == sorted(jax_hits), (marks, jax_hits)
    assert len(port_hits) == (5 if tiny else 6)  # fc, linear1 a layer, three heads


def _tiny_net():
    return dryrun._module("cpu").net


def test_a_rule_that_matches_nothing_raises_renamed():
    with pytest.raises(ValueError, match="renamed"):
        shard_params_by_rule(_tiny_net(), Mesh(dp=1, mp=2), [(r"^plan_recognition\.fcc\.weight$", ("mp", None))])
    # the first rule wins: the second matches nothing left
    with pytest.raises(ValueError, match="renamed"):
        shard_params_by_rule(_tiny_net(), Mesh(dp=1, mp=2), PLAY_LMP_RULES[:1] + [
            (r"^plan_recognition\.fc\.weight$", ("mp", None))])


@pytest.mark.parametrize("rule, error, match", [
    ((r"^plan_recognition\.transformer_encoder\.layers\.0\.self_attn\.in_proj_weight$", ("mp", None)),
     NotImplementedError, "Queue 3"),
    ((r"^plan_recognition\.transformer_encoder\.layers\.0\.self_attn\.out_proj\.weight$", ("mp", None)),
     NotImplementedError, "Queue 3"),
    ((r"^perceptual_encoder\.networks\.rgb_static\.model\.0\.weight$", ("mp",)), NotImplementedError, "Queue 3"),
    ((r"^plan_recognition\.position_embeddings\.weight$", ("mp",)), NotImplementedError, "Queue 3"),
    ((r"^action_decoder\.rnn\.weight_ih_l0$", ("mp", None)), NotImplementedError, "Queue 3"),
    ((r"^plan_recognition\.fc\.weight$", ("mp", "mp")), NotImplementedError, "Queue 3"),
    ((r"^plan_recognition\.fc\.bias$", ("mp",)), NotImplementedError, "Queue 3"),
    ((r"^plan_recognition\.mean_fc\.weight$", ("mp", None)), ValueError, "does not split over mp=3"),
    ((r"^plan_recognition\.fc\.weight$", ("dp", None)), ValueError, "spec"),
])
def test_unsupported_specs_and_undivided_dims_raise(rule, error, match):
    mp = 3 if "mp=3" in match else 2
    net = _tiny_net()
    before = {k: v.clone() for k, v in net.state_dict().items()}
    with pytest.raises(error, match=match):
        shard_params_by_rule(net, Mesh(dp=1, mp=mp), [rule])
    assert all(torch.equal(v, before[k]) for k, v in net.state_dict().items())  # nothing was cut


def test_an_mp_of_one_shards_nothing():
    net = _tiny_net()
    plan = shard_params_by_rule(net, Mesh(dp=1, mp=1), PLAY_LMP_RULES)
    assert len(plan) == 5 and all(m.tp is None for m in net.modules() if isinstance(m, TorchDense))


# -- the mesh without a process group ------------------------------------------------


@pytest.mark.parametrize("kwargs, match", [({"mp": 2}, "1 ranks not divisible by mp=2"),
                                            ({"dp": 1, "mp": 2}, r"\(dp=1, mp=2\) needs 2 ranks")])
def test_create_mesh_errors_are_jax_s(kwargs, match):
    with pytest.raises(ValueError, match=match):
        mesh.create_mesh(**kwargs)
    assert mesh.create_mesh(mp=1) == Mesh(dp=1, mp=1, rank=0) and mesh.current_mesh().shape == {"dp": 1, "mp": 1}


@pytest.mark.parametrize("rank", range(4))
def test_batch_sharding_at_2x2_gives_a_row_its_rows(rank):
    m = Mesh(dp=2, mp=2, rank=rank)
    assert (m.dp_index, m.mp_index) == (rank // 2, rank % 2)
    assert mesh.batch_sharding(m) == BatchShard(rank // 2, 2)
    rows = mesh.shard_batch({"x": np.arange(B)}, m)["x"]
    np.testing.assert_array_equal(rows, np.arange(B)[:B // 2] if rank < 2 else np.arange(B)[B // 2:])


# -- the ranks -------------------------------------------------------------------------


def _jax_steps(case, dp):
    """The JAX steps on create_mesh(dp, mp=2): the four rules' leaves
    sharded P(None, "mp"), the rest replicated, each batch dp-sharded."""
    jmesh = jax_create_mesh(dp=dp, mp=MP, devices=jax.devices()[:dp * MP])
    # host copies: the step donates its state
    js = case["jstate"]
    step0, params, opt_state, aux = jax.tree.map(np.array, (js.step, js.params, js.opt_state, js.aux))
    rep = replicated_sharding(jmesh)
    jstate = JaxTrainState(jax.device_put(step0, rep), jax_shard_params_by_rule(params, jmesh, JAX_RULES),
                           jax.device_put(opt_state, rep), aux)
    step = case["jmod"].make_train_step()
    scalars = {k: jnp.asarray(v, dtype=jnp.float32) for k, v in case["scalars"].items()}
    rows = []
    with scan.interpret_pallas():
        for batch in case["batches"]:
            jstate, metrics = step(jstate, shard_batch(batch, jmesh), jax.random.key(scan.SEED), scalars)
            rows.append({k: float(v) for k, v in metrics.items()})
    return rows, case["convert"](jstate)


def _one_rank(spec, root):
    """One port rank's steps on the whole batches from the spec's weights,
    saved as a checkpoint of mp = 1; its val loss."""
    module = PlayLMPModule(dict(spec["cfg"]), device="cpu")
    state = module.init_state(child.SEED)
    state.net.load_state_dict(spec["sd0"])
    child.run_steps(spec, Mesh(), state, module)
    CheckpointManager(root).save(STEPS, state)
    return child.val_loss(module, state, spec["val_batch"], BatchShard())


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("tp")
    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(lmp, "B", B)  # a batch two rows split
        patch.setattr(scan.JaxPlayLMPModule, "init_state", ddp._jitted(scan.JaxPlayLMPModule.init_state))
        case = scan.CASES["play_lmp"](root)
        case["batches"] = [ddp._widen(batch) for batch in case["batches"][:STEPS]]
        draws = [case["draws"](g) for g in range(STEPS)]
        want = {shape: _jax_steps(case, shape[0]) for shape in MESHES}
    val_batch = dict(ddp._widen(lmp._batch(9)), idx=np.arange(B))
    cfg = lmp._cfg()
    constant_cfg = lmp._cfg()
    constant_cfg["plan_recognition"]["dropout_p"] = 0.1
    first = case["batches"][0]
    spec = {"cfg": cfg, "sd0": {k: v.clone() for k, v in case["pmod"].net.state_dict().items()},
            "batches": case["batches"], "draws": draws, "scalars": case["scalars"], "mp": MP,
            "val_batch": val_batch, "ckpt_in": str(root / "one"), "constant_cfg": constant_cfg,
            "constant_item": {"states": {"rgb_static": first["states"]["rgb_static"][0]},
                              "actions": first["actions"][0]}}
    one_val = _one_rank(spec, root / "one")
    ranks = {}
    for dp, mp in MESHES:
        where = root / f"dp{dp}_mp{mp}"
        where.mkdir()
        torch.save(dict(spec, dp=dp, trainer=dp == 1), where / "tp.pt")
        multiprocessing.spawn(child.run_tp_job, args=(dp * mp, str(where)), nprocs=dp * mp, join=True)
        ranks[(dp, mp)] = [torch.load(where / f"tp_{r}.pt", weights_only=False) for r in range(dp * mp)]
    return {"root": root, "ranks": ranks, "want": want, "one_val": one_val, "spec": spec, "lr": case["lr"]}


@pytest.mark.parametrize("shape", MESHES)
def test_the_ranks_sit_in_their_groups(runs, shape):
    dp, mp = shape
    for r, out in enumerate(runs["ranks"][shape]):
        got = out["layout"]
        assert (got["dp_index"], got["mp_index"]) == (r // mp, r % mp)
        assert got["dp_ranks"] == [d * mp + r % mp for d in range(dp)]
        assert got["mp_ranks"] == [(r // mp) * mp + m for m in range(mp)]
        assert got["rows_of_8"] == list(range(8))[r // mp * 8 // dp:(r // mp + 1) * 8 // dp]


@pytest.mark.parametrize("shape", MESHES)
def test_column_and_row_parallel_layers_compute_the_whole_layers(runs, shape):
    """Forward, the input's gradient and the gathered weight gradients of
    a column-parallel layer (bias sharded) into a row-parallel one, against
    the layers whole (float32 sums in another order)."""
    for out in runs["ranks"][shape]:
        errs = dict(out["layers"])
        assert errs.pop("kinds") == ("column", "row")
        assert set(errs) == {"y", "x_grad", "col.weight.grad", "col.bias.grad", "row.weight.grad", "row.bias.grad"}
        assert max(errs.values()) < 1e-5, errs


@pytest.mark.parametrize("shape", MESHES)
def test_means_run_over_the_dp_group(runs, shape):
    """all_reduce_mean and sync_metrics average rank numbers over the ranks
    of one mp index (a column of the mesh), not over the world."""
    dp, mp = shape
    for r, out in enumerate(runs["ranks"][shape]):
        column = np.mean([d * mp + r % mp for d in range(dp)])
        assert out["layout"]["mean"] == out["layout"]["metrics"] == column


@pytest.mark.parametrize("shape", MESHES)
def test_fold_rank_folds_the_dp_index(runs, shape):
    dp, mp = shape
    folds = [out["layout"]["fold"] for out in runs["ranks"][shape]]
    rows = [folds[d * mp:(d + 1) * mp] for d in range(dp)]
    assert all(len(set(row)) == 1 for row in rows)  # the mp ranks of a row draw alike
    assert len({row[0] for row in rows}) == dp  # the rows do not
    assert (folds[0] == 123) == (dp == 1)


@pytest.mark.parametrize("shape", MESHES)
def test_replicate_keeps_each_row_its_shard(runs, shape):
    """Each rank moved every weight and moment by +rank: after replicate a
    replicated tensor is rank 0's (moved by 0), a shard the one of dp row 0
    with the same mp index (moved by mp_index)."""
    dp, mp = shape
    for r, out in enumerate(runs["ranks"][shape]):
        shards = set(out["shards"])
        assert len(shards) == 5
        moved = out["replicate"]
        assert any(k.startswith("exp_avg:") for k in moved)
        for k, values in moved.items():
            base = k.split(":")[-1]
            want = float(r % mp) if base in shards else 0.0
            assert values == [want], (k, values)


@pytest.mark.parametrize("shape", MESHES)
def test_sharded_steps_match_the_jax_mp_mesh_step(runs, shape):
    rows, jax_sd = runs["want"][shape]
    ranks = runs["ranks"][shape]
    ddp.close_rows(ranks[0]["rows"], rows, f"{shape}")
    assert "grad_norm" in rows[0]
    for out in ranks:
        assert out["rows"] == ranks[0]["rows"]
        ddp.close_params(out["full"], jax_sd, runs["lr"], f"{shape} gathered")


@pytest.mark.parametrize("shape", MESHES)
def test_sharded_weights_are_cut_and_replicated_ones_agree(runs, shape):
    dp, mp = shape
    ranks = runs["ranks"][shape]
    full = ranks[0]["full"]
    for r, out in enumerate(ranks):
        for k, v in out["local"].items():
            if k in out["shards"]:
                n = full[k].shape[0] // mp
                assert v.shape[0] == n and torch.equal(v, full[k][(r % mp) * n:(r % mp + 1) * n]), k
            else:
                # bit-equal over the mp ranks of the row (and here over the rows too)
                assert torch.equal(v, ranks[(r // mp) * mp]["local"][k]), k
                assert torch.equal(v, full[k]), k
    # the optimizer's moments gathered too: the unsharded layout
    state = ranks[0]["full_optimizer"]["state"]
    assert {tuple(s["exp_avg"].shape) for s in state.values()} >= {tuple(full["plan_recognition.fc.weight"].shape)}


@pytest.mark.parametrize("shape", MESHES)
def test_an_mp2_checkpoint_loads_at_mp1_with_the_same_loss(runs, shape):
    ranks = runs["ranks"][shape]
    module = PlayLMPModule(dict(runs["spec"]["cfg"]), device="cpu")
    manager = CheckpointManager(runs["root"] / f"dp{shape[0]}_mp{shape[1]}" / "ckpt")
    state = module.restore_state(manager)
    saved = manager.restore()
    assert all(torch.equal(v, ranks[0]["full"][k]) for k, v in saved["net"].items())
    loss = child.val_loss(module, state, runs["spec"]["val_batch"], BatchShard())
    np.testing.assert_allclose(ranks[0]["val"], loss, rtol=1e-5)


@pytest.mark.parametrize("shape", MESHES)
def test_an_mp1_checkpoint_loads_at_mp2_with_the_same_loss(runs, shape):
    for out in runs["ranks"][shape]:
        assert out["moments_in"]  # the loaded Adam moments cut with their weights
        np.testing.assert_allclose(out["val_in"], runs["one_val"], rtol=1e-5)


def test_the_trainer_on_a_1x2_mesh_equals_one_rank(runs, tmp_path):
    """Trainer(mesh=create_mesh(dp=1, mp=2)), dropout on: both ranks take
    the whole batch and draw the one-rank masks, so each equals one rank
    bit for bit."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # as each rank: the same sums in the same order
    try:
        one = child._fit(runs["spec"], None, tmp_path / "one")
    finally:
        torch.set_num_threads(threads)
    for out in runs["ranks"][(1, 2)]:
        got = out["trainer"]
        assert got["step"] == one["step"] == 3 and got["mesh"] == {"dp": 1, "mp": 2}
        assert got["shard"] == BatchShard(0, 1)
        assert all(torch.equal(v, one["sd"][k]) for k, v in got["sd"].items())


def test_dryrun_multichip_four_ranks_on_the_cpu(tmp_path, capsys):
    out = dryrun.dryrun_multichip(4, device="cpu", root=str(tmp_path))
    assert out["mesh"] == {"dp": 2, "mp": 2} and len(out["sharded"]) == 5
    assert out["replicated_compared"] > 0 and out["tacorl"]["frozen_checked"] > 0
    for family in ("cql", "ril", "sac", "tacorl"):
        assert all(np.isfinite(v) for v in out[family].values()), family
    printed = capsys.readouterr().out
    assert "dryrun_multichip OK: mesh={'dp': 2, 'mp': 2}" in printed and "tacorl OK" in printed
