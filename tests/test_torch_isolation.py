"""The PyTorch port stands alone: importing every module of
tacorl_tpu_torch, and chip_smoke.py, pulls in neither JAX (nor flax/optax)
nor the JAX package; and its entry points refuse to run without CUDA
unless the caller asks for the CPU."""

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
    ],
)
def test_probe_imported_every_module(probe, name):
    assert name in probe["imported"]
    assert "chip_smoke" in probe["loaded"]


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


def _cql_cfg():
    import chip_smoke

    cfg = dict(chip_smoke.TACORL_CFG)
    enc = {"networks": _tiny_cfg()["perceptual_encoder"]["networks"]}
    cfg.update(actor_encoder=enc, critic_encoder=enc, action_dim=7)
    return cfg


@pytest.mark.parametrize(
    "entry",
    ["resolve_device", "DeviceTransforms", "PlayLMPModule", "CQLModule", "TACORLModule",
     "load_module_from_checkpoint"],
)
def test_default_device_entry_points_raise_without_cuda(entry, tmp_path):
    _no_cuda()
    from tacorl_tpu_torch.core.checkpoint import CheckpointManager, load_module_from_checkpoint
    from tacorl_tpu_torch.data.transforms import DeviceTransforms
    from tacorl_tpu_torch.modules.cql import CQLModule
    from tacorl_tpu_torch.modules.play_lmp import PlayLMPModule
    from tacorl_tpu_torch.modules.tacorl import TACORLModule
    from tacorl_tpu_torch.utils import resolve_device

    if entry in ("TACORLModule", "load_module_from_checkpoint"):
        cfg = {"_target_": "tacorl_tpu.modules.play_lmp.PlayLMPModule", **_tiny_cfg()}
        lmp = PlayLMPModule(cfg, device="cpu")
        CheckpointManager(tmp_path, config={"module": cfg}).save(0, lmp.init_state(0))
    make = {
        "resolve_device": lambda: resolve_device(),
        "DeviceTransforms": lambda: DeviceTransforms({}),
        "PlayLMPModule": lambda: PlayLMPModule(_tiny_cfg()),
        "CQLModule": lambda: CQLModule(_cql_cfg()),
        "TACORLModule": lambda: TACORLModule({"play_lmp_dir": str(tmp_path)}),
        "load_module_from_checkpoint": lambda: load_module_from_checkpoint(tmp_path),
    }[entry]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make()


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


def test_cuda_kernel_build_raises_without_nvcc(monkeypatch, tmp_path):
    """Pointed at a compiler that is not there, the build raises, and the
    kernel wrapper handed a CUDA tensor raises with it: no plain fallback."""
    from tacorl_tpu_torch.ops import _cuda_build
    from tacorl_tpu_torch.ops.shift_jitter_aug import shift_jitter_normalize

    monkeypatch.setenv("TACORL_NVCC", str(tmp_path / "no-such-nvcc"))
    monkeypatch.setattr(_cuda_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_cuda_build, "_LOADED", {})
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _cuda_build.load_library("shift_jitter")
    mode, args = _fake_cuda_inputs("shift_jitter_normalize")
    before = shift_jitter_normalize.launches
    with mode, pytest.raises(RuntimeError, match="nvcc not found"):
        shift_jitter_normalize(*args)
    assert shift_jitter_normalize.launches == before


def test_cuda_kernel_build_raises_when_nvcc_fails(monkeypatch, tmp_path):
    """A compiler that exits non-zero (here `false`) fails the build loudly
    and leaves no half-built library behind."""
    from tacorl_tpu_torch.ops import _cuda_build

    monkeypatch.setenv("TACORL_NVCC", shutil.which("false"))
    monkeypatch.setattr(_cuda_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_cuda_build, "_LOADED", {})
    with pytest.raises(RuntimeError, match="nvcc failed to build"):
        _cuda_build.load_library("shift_jitter")
    assert not list((tmp_path / "build").iterdir())


@pytest.mark.filterwarnings("ignore:Accessing the data pointer of FakeTensor")
def test_cuda_kernel_launch_failure_raises(monkeypatch):
    """A launch the card refuses (a non-zero CUDA status) raises and is not
    counted."""
    from types import SimpleNamespace

    from tacorl_tpu_torch.ops import shift_jitter_aug

    lib = SimpleNamespace(shift_jitter_normalize_launch=lambda *args: 98)  # invalid device function
    monkeypatch.setattr(shift_jitter_aug, "_library", lambda: lib)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: SimpleNamespace(cuda_stream=0))
    mode, args = _fake_cuda_inputs("shift_jitter_normalize")
    before = shift_jitter_aug.shift_jitter_normalize.launches
    with mode, pytest.raises(RuntimeError, match="CUDA error 98"):
        shift_jitter_aug.shift_jitter_normalize(*args)
    assert shift_jitter_aug.shift_jitter_normalize.launches == before


def test_triton_kernel_build_failure_raises(monkeypatch):
    from tacorl_tpu_torch.ops import jitter_aug

    def fail():
        raise RuntimeError("triton build failed")

    monkeypatch.setattr(jitter_aug, "_build_kernel", fail)
    mode, args = _fake_cuda_inputs("jitter_normalize")
    before = jitter_aug.jitter_normalize.launches
    with mode, pytest.raises(RuntimeError, match="triton build failed"):
        jitter_aug.jitter_normalize(*args)
    assert jitter_aug.jitter_normalize.launches == before


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
