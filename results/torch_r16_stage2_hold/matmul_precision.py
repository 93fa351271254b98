"""``python -m tacorl_tpu_torch.train`` with float32 matmuls at a reduced
input precision (``torch.set_float32_matmul_precision``), the nearest the
card comes to a TPU's default precision (bfloat16 inputs, float32 sums);
cuDNN's convolutions keep torch's default (TF32). No knob of the port is
added. Prints the relative error of a float32 matmul of normals against
float64 on the card under the setting, so the record says what ran.

    python results/torch_r16_stage2_hold/matmul_precision.py <high|medium> <train overrides...>
"""

import logging
import sys

import torch

from tacorl_tpu_torch import train


def matmul_error() -> float:
    g = torch.Generator(device="cuda").manual_seed(0)
    a, b = (torch.randn(1024, 1024, device="cuda", generator=g) for _ in range(2))
    want = a.double() @ b.double()
    return float(((a @ b).double() - want).norm() / want.norm())


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(levelname)s %(message)s")
    setting = sys.argv[1]
    torch.set_float32_matmul_precision(setting)
    print(f"float32 matmul precision {torch.get_float32_matmul_precision()}: matmul allow_tf32 "
          f"{torch.backends.cuda.matmul.allow_tf32}, cudnn allow_tf32 {torch.backends.cudnn.allow_tf32}, "
          f"relative error of a 1024x1024 float32 matmul against float64 {matmul_error():.3g}", flush=True)
    train.main(sys.argv[2:])
