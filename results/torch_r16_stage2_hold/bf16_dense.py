"""``python -m tacorl_tpu_torch.train`` with every float32 ``TorchDense``
layer computing as a TPU's default precision computes a float32 dot:
inputs and weights rounded to bfloat16, products summed in float32 (the
matmul without TF32). Layers that already compute in a ``compute_dtype``
(the bf16 convolutions) and cuDNN's RNN are left as they are. The layer is
patched from this script; no knob of the port is added.

    python results/torch_r16_stage2_hold/bf16_dense.py <train overrides...>
"""

import logging
import sys

import torch
import torch.nn.functional as F

from tacorl_tpu_torch import train
from tacorl_tpu_torch.networks.layers import TorchDense

float32_forward = TorchDense.forward


def bf16_forward(self, x):
    if self.compute_dtype is not None or self.tp is not None:
        return float32_forward(self, x)
    w = self.weight.to(torch.bfloat16).float()
    y = F.linear(x.float().to(torch.bfloat16).float(), w)
    return y if self.bias is None else y + self.bias


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(levelname)s %(message)s")
    TorchDense.forward = bf16_forward
    print(f"TorchDense: bfloat16 inputs and weights, float32 sums; matmul allow_tf32 "
          f"{torch.backends.cuda.matmul.allow_tf32}, cudnn allow_tf32 {torch.backends.cudnn.allow_tf32}", flush=True)
    train.main(sys.argv[1:])
