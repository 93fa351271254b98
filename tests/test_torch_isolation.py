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


def test_probe_imported_every_module(probe):
    imported = set(probe["imported"])
    for name in (
        "tacorl_tpu_torch.ops.jitter_aug",
        "tacorl_tpu_torch.modules.play_lmp",
        "tacorl_tpu_torch.utils.convert",
        "tacorl_tpu_torch.networks.action_decoder",
    ):
        assert name in imported
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


@pytest.mark.parametrize("entry", ["resolve_device", "DeviceTransforms", "PlayLMPModule"])
def test_default_device_entry_points_raise_without_cuda(entry):
    _no_cuda()
    from tacorl_tpu_torch.data.transforms import DeviceTransforms
    from tacorl_tpu_torch.modules.play_lmp import PlayLMPModule
    from tacorl_tpu_torch.utils import resolve_device

    make = {
        "resolve_device": lambda: resolve_device(),
        "DeviceTransforms": lambda: DeviceTransforms({}),
        "PlayLMPModule": lambda: PlayLMPModule(_tiny_cfg()),
    }[entry]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make()


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
