"""``python -m tacorl_tpu_torch.train`` with cuDNN's TF32 switched off
(float32 matmuls already run without it at torch's defaults), so a run's
only change is the convolutions' precision; no knob of the port is added.

    python results/torch_r16_stage2_hold/tf32_off.py <train overrides...>
"""

import logging
import sys

import torch

from tacorl_tpu_torch import train

if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(levelname)s %(message)s")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"matmul allow_tf32 {torch.backends.cuda.matmul.allow_tf32} cudnn allow_tf32 "
          f"{torch.backends.cudnn.allow_tf32}", flush=True)
    train.main(sys.argv[1:])
