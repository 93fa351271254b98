"""The PyTorch port stands alone: importing every module of
tacorl_tpu_torch, chip_smoke.py and kernel_ab.py pulls in neither JAX (nor flax/optax)
nor the JAX package; and its entry points (modules, agents, the trainer and
its device put, ``python -m tacorl_tpu_torch.evaluate`` and ``.train``)
refuse to run without CUDA unless the caller asks for the CPU."""

import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent

_PROBE = r"""
import importlib, json, pkgutil, sys
import tacorl_tpu_torch
names = [m.name for m in pkgutil.walk_packages(tacorl_tpu_torch.__path__, "tacorl_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke  # not run: main() is under the __main__ check
import kernel_ab  # nor this one
print(json.dumps({"imported": names, "loaded": sorted(sys.modules)}))
"""


@pytest.fixture(scope="module")
def probe():
    out = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=REPO, capture_output=True,
        text=True, timeout=300, check=True,
    )
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize(
    "name",
    [
        "tacorl_tpu_torch.ops.jitter_aug",
        "tacorl_tpu_torch.ops.shift_jitter_aug",
        "tacorl_tpu_torch.ops._cuda_build",
        "tacorl_tpu_torch.modules.play_lmp",
        "tacorl_tpu_torch.modules.cql",
        "tacorl_tpu_torch.modules.tacorl",
        "tacorl_tpu_torch.networks.action_decoder",
        "tacorl_tpu_torch.networks.critic",
        "tacorl_tpu_torch.networks.visual_wrappers",
        "tacorl_tpu_torch.core.checkpoint",
        "tacorl_tpu_torch.core.optimizers",
        "tacorl_tpu_torch.utils.convert",
        "tacorl_tpu_torch.config",
        "tacorl_tpu_torch.envs.base",
        "tacorl_tpu_torch.envs.fake_calvin",
        "tacorl_tpu_torch.data.storage",
        "tacorl_tpu_torch.data.expert_play",
        "tacorl_tpu_torch.evaluation.agents",
        "tacorl_tpu_torch.evaluation.rollout_manager",
        "tacorl_tpu_torch.evaluation.rollout_generator",
        "tacorl_tpu_torch.evaluation.manager",
        "tacorl_tpu_torch.evaluation.video",
        "tacorl_tpu_torch.evaluate",
        "tacorl_tpu_torch.train",
        "tacorl_tpu_torch.core.trainer",
        "tacorl_tpu_torch.core.logging",
        "tacorl_tpu_torch.data.native",
        "tacorl_tpu_torch.data.knn",
        "tacorl_tpu_torch.data.synthetic",
        "tacorl_tpu_torch.data.play_dataset",
        "tacorl_tpu_torch.data.loader",
        "tacorl_tpu_torch.data.datamodule",
        "tacorl_tpu_torch.callbacks",
        "tacorl_tpu_torch.callbacks.base",
        "tacorl_tpu_torch.callbacks.kl_schedule",
        "tacorl_tpu_torch.callbacks.horizon",
        "tacorl_tpu_torch.callbacks.rollout",
        "tacorl_tpu_torch.callbacks.horizon_uncertainty",
        "tacorl_tpu_torch.core.obs",
        "tacorl_tpu_torch.data.transition_dataset",
        "tacorl_tpu_torch.data.saved_transitions",
        "tacorl_tpu_torch.networks.encoders",
        "tacorl_tpu_torch.make_flagship_data",
        "tacorl_tpu_torch.data.d4rl_dataset",
        "tacorl_tpu_torch.data.d4rl_datamodule",
        "tacorl_tpu_torch.envs.fake_d4rl",
        "tacorl_tpu_torch.modules.play_lmp_d4rl",
        "tacorl_tpu_torch.modules.tacorl_d4rl",
        "tacorl_tpu_torch.evaluation.rollout_manager_d4rl",
        "tacorl_tpu_torch.evaluate_d4rl",
        "tacorl_tpu_torch.data.ril_dataset",
        "tacorl_tpu_torch.modules.ril",
        "tacorl_tpu_torch.modules.cem",
        "tacorl_tpu_torch.evaluate_ril_oracle",
        "tacorl_tpu_torch.utils.geometry",
        "tacorl_tpu_torch.envs.calvin",
        "tacorl_tpu_torch.envs.vec_env",
        "tacorl_tpu_torch.data.replay_buffer",
        "tacorl_tpu_torch.data.online_datamodule",
        "tacorl_tpu_torch.modules.sac",
        "tacorl_tpu_torch.modules.cql_online",
        "tacorl_tpu_torch.networks.resnet",
        "tacorl_tpu_torch.networks.actor",
        "tacorl_tpu_torch.networks.late_fusion",
        "tacorl_tpu_torch.networks.plan_recognition",
        "tacorl_tpu_torch.data.transforms",
        "tacorl_tpu_torch.ops.image_aug",
        "tacorl_tpu_torch.callbacks.tsne_plot",
        "tacorl_tpu_torch.envs.real_world",
        "tacorl_tpu_torch.utils.profiling",
        "tacorl_tpu_torch.utils.torch_convert",
        "tacorl_tpu_torch.utils.visualize_frames",
        "tacorl_tpu_torch.convert_checkpoint",
        "tacorl_tpu_torch.evaluate_real_world",
        "tacorl_tpu_torch.evaluate_real_world_from_dataset",
        "tacorl_tpu_torch.measure_protocol_ceiling",
        "tacorl_tpu_torch.dryrun",
        "tacorl_tpu_torch.parallel.tensor_parallel",
    ],
)
def test_probe_imported_every_module(probe, name):
    assert name in probe["imported"]
    assert "chip_smoke" in probe["loaded"] and "kernel_ab" in probe["loaded"]


# the JAX package's modules whose counterparts have other names
RENAMED = {"ops/pallas_aug.py": ("ops/jitter_aug.py", "ops/shift_jitter_aug.py")}
# entry points: scripts/<name>.py -> python -m tacorl_tpu_torch.<name>
SCRIPTS = ["train", "evaluate", "evaluate_d4rl", "evaluate_ril_oracle", "make_flagship_data",
           "convert_checkpoint", "evaluate_real_world", "evaluate_real_world_from_dataset",
           "measure_protocol_ceiling"]


def test_every_jax_module_and_script_has_a_counterpart():
    jax_pkg, port_pkg = REPO / "tacorl_tpu", REPO / "tacorl_tpu_torch"
    for path in sorted(jax_pkg.rglob("*.py")):
        rel = path.relative_to(jax_pkg).as_posix()
        for counterpart in RENAMED.get(rel, (rel,)):
            assert (port_pkg / counterpart).is_file(), rel
    jax_scripts = {p.stem for p in (REPO / "scripts").glob("*.py") if not p.stem.startswith("bench_")}
    assert jax_scripts == set(SCRIPTS)
    for name in SCRIPTS:
        assert (port_pkg / f"{name}.py").is_file(), name


@pytest.mark.parametrize("package", ["callbacks", "envs", "utils", "networks"])
def test_every_jax_class_in_all_resolves_to_the_port(package):
    """Each class a JAX module of ``package`` exports in ``__all__`` is what
    a config names; the port's ``get_class`` resolves every one to a class
    (or, for ``StackedRNN``, the factory) of the port."""
    import importlib

    from tacorl_tpu_torch.config import get_class

    checked = 0
    for path in sorted((REPO / "tacorl_tpu" / package).glob("*.py")):
        name = f"tacorl_tpu.{package}" + ("" if path.stem == "__init__" else f".{path.stem}")
        module = importlib.import_module(name)
        for attr in getattr(module, "__all__", []):
            if isinstance(getattr(module, attr), type):
                cls = get_class(f"{name}.{attr}")
                assert callable(cls) and cls.__module__.startswith("tacorl_tpu_torch."), (name, attr)
                checked += 1
    assert checked >= 1


@pytest.mark.parametrize("forbidden", ["jax", "jaxlib", "flax", "optax", "tacorl_tpu"])
def test_port_imports_nothing_of_jax(probe, forbidden):
    hits = [
        m for m in probe["loaded"] if m == forbidden or m.startswith(forbidden + ".")
    ]
    assert not hits, hits


def _no_cuda():
    if torch.cuda.is_available():
        pytest.skip("this check is about a machine without CUDA")


def _tiny_cfg():
    import chip_smoke

    return chip_smoke._tiny_cfg()


def _d4rl_cfg():
    return {"state_dim": 6, "action_dim": 3, "latent_plan_dim": 4,
            "plan_recognition": {"num_heads": 2, "num_layers": 1, "encoder_hidden_size": 8,
                                 "fc_hidden_size": 8},
            "plan_proposal": {"policy": {"num_layers": 1, "hidden_dim": 8}},
            "action_decoder": {"hidden_size": 8, "num_layers": 1, "n_mixtures": 2}}


def _ril_cfg():
    return {"high_level_policy_modalities": ["robot_obs"], "low_level_policy_modalities": ["robot_obs"],
            "vector_dims": {"robot_obs": 3}, "perceptual_encoder": {"networks": {}},
            "goal_encoder": {"out_features": 4, "hidden_size": 8},
            "high_level_policy": {"num_layers": 1, "hidden_dim": 8},
            "low_level_policy": {"num_layers": 1, "hidden_dim": 8}}


def _online_cfg():
    return {"state_based": True, "state_dim": 6, "goal_dim": 3, "warm_start_steps": 2}


def _cql_cfg():
    import chip_smoke

    cfg = dict(chip_smoke.TACORL_CFG)
    enc = {"networks": _tiny_cfg()["perceptual_encoder"]["networks"]}
    cfg.update(actor_encoder=enc, critic_encoder=enc, action_dim=7)
    return cfg


@pytest.mark.parametrize(
    "entry",
    ["resolve_device", "DeviceTransforms", "PlayLMPModule", "CQLModule", "StateCQLModule", "TACORLModule",
     "load_module_from_checkpoint", "LatentPlanAgent", "TACORLAgent", "FlatPolicyAgent",
     "make_agent", "evaluate.main", "Trainer", "train.main", "DevicePut", "PlayLMPD4RLModule",
     "TACORLD4RLModule", "LatentPlanD4RLAgent", "TACORLD4RLAgent", "make_d4rl_agent",
     "evaluate_d4rl.main", "RILModule", "RILAgent", "OracleSubgoalAgent", "evaluate_ril_oracle.main",
     "SACModule", "CQLOnlineModule", "train.main online", "local_mesh_devices", "convert_checkpoint.main",
     "evaluate_real_world.main", "evaluate_real_world_from_dataset.main", "dryrun_multichip"],
)
def test_default_device_entry_points_raise_without_cuda(entry, tmp_path):
    _no_cuda()
    from tacorl_tpu_torch import (
        convert_checkpoint,
        dryrun,
        evaluate,
        evaluate_d4rl,
        evaluate_real_world,
        evaluate_real_world_from_dataset,
        evaluate_ril_oracle,
        train,
    )
    from tacorl_tpu_torch.parallel.mesh import local_mesh_devices
    from tacorl_tpu_torch.core.checkpoint import CheckpointManager, load_module_from_checkpoint
    from tacorl_tpu_torch.core.trainer import Trainer
    from tacorl_tpu_torch.data.loader import DevicePut
    from tacorl_tpu_torch.data.transforms import DeviceTransforms
    from tacorl_tpu_torch.evaluation import agents
    from tacorl_tpu_torch.modules.cql import CQLModule
    from tacorl_tpu_torch.modules.cql_online import CQLOnlineModule
    from tacorl_tpu_torch.modules.play_lmp import PlayLMPModule
    from tacorl_tpu_torch.modules.ril import RILModule
    from tacorl_tpu_torch.modules.sac import SACModule
    from tacorl_tpu_torch.modules.tacorl import TACORLModule
    from tacorl_tpu_torch.utils import resolve_device

    cfg = {"_target_": "tacorl_tpu.modules.play_lmp.PlayLMPModule", **_tiny_cfg()}
    lmp = PlayLMPModule(cfg, device="cpu")
    CheckpointManager(tmp_path, config={"module": cfg}).save(0, lmp.init_state(0))
    from tacorl_tpu_torch.modules.play_lmp_d4rl import PlayLMPD4RLModule
    from tacorl_tpu_torch.modules.tacorl_d4rl import TACORLD4RLModule

    d4rl_cfg = {"_target_": "tacorl_tpu.modules.play_lmp_d4rl.PlayLMPD4RLModule", **_d4rl_cfg()}
    d4rl_dir = tmp_path / "d4rl"
    CheckpointManager(d4rl_dir, config={"module": d4rl_cfg}).save(
        0, PlayLMPD4RLModule(d4rl_cfg, device="cpu").init_state(0)
    )
    make = {
        "resolve_device": lambda: resolve_device(),
        "DeviceTransforms": lambda: DeviceTransforms({}),
        "PlayLMPModule": lambda: PlayLMPModule(_tiny_cfg()),
        "CQLModule": lambda: CQLModule(_cql_cfg()),
        "StateCQLModule": lambda: CQLModule({"state_based": True, "state_dim": 6, "goal_dim": 3}),
        "TACORLModule": lambda: TACORLModule({"play_lmp_dir": str(tmp_path)}),
        "load_module_from_checkpoint": lambda: load_module_from_checkpoint(tmp_path),
        # the agents over modules built on the default device
        "LatentPlanAgent": lambda: agents.LatentPlanAgent(PlayLMPModule(_tiny_cfg()), None),
        "TACORLAgent": lambda: agents.TACORLAgent(TACORLModule({"play_lmp_dir": str(tmp_path)}), None),
        "FlatPolicyAgent": lambda: agents.FlatPolicyAgent(CQLModule(_cql_cfg()), None),
        "make_agent": lambda: agents.make_agent(*load_module_from_checkpoint(tmp_path)),
        "evaluate.main": lambda: evaluate.main([f"module_path={tmp_path}", f"data_dir={tmp_path}"]),
        "Trainer": lambda: Trainer(),
        "train.main": lambda: train.main([f"data_dir={tmp_path}", f"run_dir={tmp_path}"]),
        # the prefetch's put_fn
        "DevicePut": lambda: DevicePut(),
        "PlayLMPD4RLModule": lambda: PlayLMPD4RLModule(_d4rl_cfg()),
        "TACORLD4RLModule": lambda: TACORLD4RLModule({"play_lmp_dir": str(d4rl_dir)}),
        "LatentPlanD4RLAgent": lambda: agents.LatentPlanD4RLAgent(PlayLMPD4RLModule(_d4rl_cfg()), None),
        "TACORLD4RLAgent": lambda: agents.TACORLD4RLAgent(TACORLD4RLModule({"play_lmp_dir": str(d4rl_dir)}), None),
        "make_d4rl_agent": lambda: agents.make_d4rl_agent(*load_module_from_checkpoint(d4rl_dir)),
        "evaluate_d4rl.main": lambda: evaluate_d4rl.main([f"module_path={d4rl_dir}"]),
        "RILModule": lambda: RILModule(_ril_cfg()),
        "RILAgent": lambda: agents.RILAgent(RILModule(_ril_cfg()), None),
        "OracleSubgoalAgent": lambda: agents.OracleSubgoalAgent(RILModule(_ril_cfg()), None, None),
        "evaluate_ril_oracle.main": lambda: evaluate_ril_oracle.main(
            [f"module_path={tmp_path}", f"data_dir={tmp_path}"]),
        "SACModule": lambda: SACModule(_online_cfg()),
        "CQLOnlineModule": lambda: CQLOnlineModule(_online_cfg()),
        "train.main online": lambda: train.main(["experiment=cql_online_fake", f"run_dir={tmp_path / 'online'}"]),
        "local_mesh_devices": lambda: local_mesh_devices(),
        "convert_checkpoint.main": lambda: convert_checkpoint.main(
            ["--ckpt", str(tmp_path / "x.ckpt"), "--module-config", str(tmp_path / "m.yaml"), "--out", str(tmp_path)]),
        "evaluate_real_world.main": lambda: evaluate_real_world.main([f"module_path={tmp_path}", "img_path=x"]),
        "evaluate_real_world_from_dataset.main": lambda: evaluate_real_world_from_dataset.main(
            [f"module_path={tmp_path}", "img_path=x", f"data_dir={tmp_path}"]),
        "dryrun_multichip": lambda: dryrun.dryrun_multichip(2),
    }[entry]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make()


def test_agent_refuses_a_module_whose_device_has_no_card():
    """An agent checks its module's device itself."""
    _no_cuda()
    from types import SimpleNamespace

    from tacorl_tpu_torch.evaluation import agents

    module = SimpleNamespace(device="cuda", transforms=None)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        agents.LatentPlanAgent(module, SimpleNamespace(net=torch.nn.Linear(1, 1)))


def test_evaluate_command_raises_without_cuda(tmp_path):
    """``python -m tacorl_tpu_torch.evaluate`` without ``+device=cpu`` runs
    on the card, so without one it fails before it loads anything."""
    _no_cuda()
    out = subprocess.run(
        [sys.executable, "-m", "tacorl_tpu_torch.evaluate", f"module_path={tmp_path}",
         f"data_dir={tmp_path}"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert out.returncode != 0
    assert "CUDA is not available" in out.stderr
    assert "wrote" not in out.stdout


def _fake_cuda_inputs(kernel):
    """CUDA tensors without a card: torch's fake tensors carry a device,
    shape and type but no data, which is all a wrapper reads before it
    builds and launches its kernel."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    mode = FakeTensorMode(allow_non_fake_inputs=True)
    with mode:
        if kernel == "shift_jitter_normalize":
            args = (torch.empty(2, 3, 20, 20, device="cuda"), torch.zeros(2, 10, device="cuda"), 2)
        else:
            args = (torch.empty(2, 3, 16, 16, device="cuda"), torch.zeros(2, 8, device="cuda"))
    return mode, args


# (library, wrapper module, wrapper) of each CUDA kernel
KERNELS = [
    ("shift_jitter", "tacorl_tpu_torch.ops.shift_jitter_aug", "shift_jitter_normalize"),
    ("jitter_normalize", "tacorl_tpu_torch.ops.jitter_aug", "jitter_normalize"),
]
KERNEL_IDS = [k[0] for k in KERNELS]


def _wrapper(module, name):
    import importlib

    mod = importlib.import_module(module)
    return mod, getattr(mod, name)


@pytest.mark.parametrize("library, module, wrapper", KERNELS, ids=KERNEL_IDS)
def test_cuda_kernel_build_raises_without_nvcc(monkeypatch, tmp_path, library, module, wrapper):
    """Pointed at a compiler that is not there, the build raises, and the
    kernel wrapper handed a CUDA tensor raises with it: no plain fallback."""
    from tacorl_tpu_torch.ops import _cuda_build

    monkeypatch.setenv("TACORL_NVCC", str(tmp_path / "no-such-nvcc"))
    monkeypatch.setattr(_cuda_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_cuda_build, "_LOADED", {})
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _cuda_build.load_library(library)
    _, fn = _wrapper(module, wrapper)
    mode, args = _fake_cuda_inputs(wrapper)
    before = fn.launches
    with mode, pytest.raises(RuntimeError, match="nvcc not found"):
        fn(*args)
    assert fn.launches == before


@pytest.mark.parametrize("library, module, wrapper", KERNELS, ids=KERNEL_IDS)
def test_cuda_kernel_build_raises_when_nvcc_fails(monkeypatch, tmp_path, library, module, wrapper):
    """A compiler that exits non-zero (here `false`) fails the build loudly
    and leaves no half-built library behind."""
    from tacorl_tpu_torch.ops import _cuda_build

    monkeypatch.setenv("TACORL_NVCC", shutil.which("false"))
    monkeypatch.setattr(_cuda_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_cuda_build, "_LOADED", {})
    with pytest.raises(RuntimeError, match="nvcc failed to build"):
        _cuda_build.load_library(library)
    assert not list((tmp_path / "build").iterdir())


def _refusing_library(monkeypatch, module, wrapper, status):
    """The wrapper's module with a library whose launcher returns ``status``
    and a current stream that needs no card."""
    from types import SimpleNamespace

    mod, fn = _wrapper(module, wrapper)
    lib = SimpleNamespace(**{f"{wrapper}_launch": lambda *args: status})
    monkeypatch.setattr(mod, "_library", lambda: lib)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: SimpleNamespace(cuda_stream=0))
    return fn


@pytest.mark.filterwarnings("ignore:Accessing the data pointer of FakeTensor")
@pytest.mark.parametrize("library, module, wrapper", KERNELS, ids=KERNEL_IDS)
def test_cuda_kernel_launch_failure_raises(monkeypatch, library, module, wrapper):
    """A launch the card refuses (a non-zero CUDA status) raises and is not
    counted."""
    fn = _refusing_library(monkeypatch, module, wrapper, 98)  # invalid device function
    mode, args = _fake_cuda_inputs(wrapper)
    before = fn.launches
    with mode, pytest.raises(RuntimeError, match="CUDA error 98"):
        fn(*args)
    assert fn.launches == before


@pytest.mark.filterwarnings("ignore:Accessing the data pointer of FakeTensor")
@pytest.mark.parametrize("library, module, wrapper", KERNELS, ids=KERNEL_IDS)
def test_unschedulable_cluster_shape_raises(monkeypatch, library, module, wrapper):
    """A cluster shape that cudaOccupancyMaxActiveClusters finds no room for
    (the launcher's -1) raises and is not counted."""
    fn = _refusing_library(monkeypatch, module, wrapper, -1)
    mode, args = _fake_cuda_inputs(wrapper)
    before = fn.launches
    with mode, pytest.raises(RuntimeError, match="cannot be scheduled"):
        fn(*args)
    assert fn.launches == before


def test_library_name_covers_the_shared_headers(monkeypatch, tmp_path):
    """An edit to a shared header renames the library that includes it, so
    a stale build is never loaded; an edit to another source does not."""
    from tacorl_tpu_torch.ops import _cuda_build

    csrc = tmp_path / "csrc"
    shutil.copytree(_cuda_build.CSRC_DIR, csrc)
    monkeypatch.setattr(_cuda_build, "CSRC_DIR", csrc)
    before = {name: _cuda_build.library_path(name) for name in KERNEL_IDS}
    header = csrc / "jitter_common.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {name: _cuda_build.library_path(name) for name in KERNEL_IDS}
    assert all(before[n] != after[n] for n in KERNEL_IDS)
    source = csrc / "shift_jitter.cu"
    source.write_text(source.read_text() + "\n// edited\n")
    assert _cuda_build.library_path("jitter_normalize") == after["jitter_normalize"]
    assert _cuda_build.library_path("shift_jitter") != after["shift_jitter"]


def test_train_command_raises_without_cuda(tmp_path):
    """``python -m tacorl_tpu_torch.train`` without ``+device=cpu`` runs on
    the card, so without one it fails before it builds anything."""
    _no_cuda()
    out = subprocess.run(
        [sys.executable, "-m", "tacorl_tpu_torch.train", f"data_dir={tmp_path}",
         f"run_dir={tmp_path / 'run'}"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert out.returncode != 0
    assert "CUDA is not available" in out.stderr
    assert not (tmp_path / "run").exists()


@pytest.mark.parametrize("compiler", ["missing", "failing"])
def test_episode_loader_build_failure_raises(monkeypatch, tmp_path, compiler):
    """A missing or failing g++ raises: packed storage has no numpy
    fallback, and no half-built library is left behind."""
    import numpy as np

    from tacorl_tpu_torch.data import native

    cxx = str(tmp_path / "no-such-g++") if compiler == "missing" else shutil.which("false")
    monkeypatch.setattr(native, "CXX", cxx)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="build"):
        native.get_native_lib()
    with pytest.raises(RuntimeError, match="build"):
        native.gather_rows(np.zeros((4, 3), np.uint8), [1])
    assert not list((tmp_path / "build").glob("*"))


def test_chip_smoke_fails_without_cuda(capsys):
    _no_cuda()
    import chip_smoke

    assert chip_smoke.main() != 0
    assert capsys.readouterr().out == ""


def test_chip_smoke_fails_outside_the_repo(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    out = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=tmp_path, capture_output=True,
        text=True, timeout=300, env={"PATH": "/usr/bin:/bin"},
    )
    assert out.returncode != 0
    assert "tacorl_tpu_torch" in out.stderr  # the port is not there to import
    assert '"ok": true' not in out.stdout
