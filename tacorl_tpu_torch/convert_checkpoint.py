"""Convert a released reference PyTorch-Lightning checkpoint into a port
checkpoint (mirrors scripts/convert_checkpoint.py, with the same flags).

Usage:
    python -m tacorl_tpu_torch.convert_checkpoint --ckpt /path/to/play_lmp.ckpt \
        --module-config configs_of_run.yaml --out runs/lmp_converted [--kind play_lmp]

``--module-config`` is the run's module config (its ``module`` entry, or
the whole file), with ``_target_``; a ``tacorl`` config names the converted
Play-LMP run in ``play_lmp_dir``. The module is built from it on
``--device`` (the card by default; without one this raises unless
``--device cpu`` is given), the converted weights are loaded into it
strictly, and step 0 is written through ``core/checkpoint.py`` with the
module's own fresh optimizer state. ``python -m tacorl_tpu_torch.evaluate
module_path=<out>`` scores it; ``play_lmp_dir=<out>`` grafts stage 2 from
it.
"""

from __future__ import annotations

import argparse
import sys

from tacorl_tpu_torch.config import get_class, load_yaml
from tacorl_tpu_torch.core.checkpoint import CheckpointManager
from tacorl_tpu_torch.utils import resolve_device
from tacorl_tpu_torch.utils.torch_convert import KINDS, convert, load_lightning_state_dict

__all__ = ["main"]


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--ckpt", required=True)
    parser.add_argument("--module-config", required=True, help="the module config yaml of the run")
    parser.add_argument("--out", required=True)
    parser.add_argument("--kind", default="play_lmp", choices=KINDS)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv if argv is not None else sys.argv[1:])
    device = resolve_device(args.device)

    cfg = load_yaml(args.module_config)
    module_cfg = cfg.get("module", cfg)
    sd = convert(args.kind, load_lightning_state_dict(args.ckpt), module_cfg)
    module = get_class(module_cfg["_target_"])(dict(module_cfg), device=device)
    state = module.init_state(0)
    state.net.load_state_dict(sd, strict=True)
    CheckpointManager(args.out, config={"module": module_cfg}).save(0, state)
    print(f"converted {args.kind} checkpoint written to {args.out}")
    return module, state


if __name__ == "__main__":
    main()
