"""The benchmark of tacorl_tpu_torch on NVIDIA H100 cards (see run.py)."""
