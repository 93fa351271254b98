"""PyTorch/CUDA port of tacorl_tpu for NVIDIA Hopper (H100).

Mirrors ``tacorl_tpu`` module for module (same module paths, class names and
config keys). Plain tensor code is PyTorch; the one Pallas kernel on the
Play-LMP train path (``tacorl_tpu/ops/pallas_aug.py:_jitter_kernel``) is a
hand-written Triton kernel in ``ops/jitter_aug.py``.

Entry points run on the card (``device="cuda"``) unless the caller asks for
the CPU; without CUDA they raise instead of silently running on the host.
This package imports neither JAX nor ``tacorl_tpu``.
"""

__version__ = "0.1.0"
