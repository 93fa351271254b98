"""The PyTorch port stands alone: importing every module of
tacorl_tpu_torch, chip_smoke.py and kernel_ab.py pulls in neither JAX (nor flax/optax)
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
    ],
)
def test_probe_imported_every_module(probe, name):
    assert name in probe["imported"]
    assert "chip_smoke" in probe["loaded"] and "kernel_ab" in probe["loaded"]


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
