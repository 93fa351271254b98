"""PyTorch/CUDA port of tacorl_tpu for NVIDIA Hopper (H100).

Mirrors ``tacorl_tpu`` module for module (same module paths, class names and
config keys). Plain tensor code is PyTorch; the two Pallas kernels of
``tacorl_tpu/ops/pallas_aug.py`` are hand-written CUDA C++ kernels for
sm_90a in ``csrc/`` (``_jitter_kernel``, on the train paths, behind
``ops/jitter_aug.py``; ``_shift_jitter_kernel`` behind
``ops/shift_jitter_aug.py``).

Entry points run on the card (``device="cuda"``) unless the caller asks for
the CPU; without CUDA they raise instead of silently running on the host.
This package imports neither JAX nor ``tacorl_tpu``.
"""

__version__ = "0.1.0"
