"""PyTorch/CUDA port of ``distributed_cluster_gpus_tpu`` for NVIDIA Hopper.

A second package beside the JAX one, with the same module layout so each
module's counterpart is easy to find.  The JAX package is the reference
the port is held against (``tests/test_torch_*.py``); this package imports
torch and numpy only.  Entry points take an explicit ``device`` and default
to ``"cuda"``; asking for CUDA without a GPU raises.  Hand-written kernels
live in ``csrc/`` (CUDA C++, built on first use by ``kernels/build.py``),
each beside a plain torch version in ``kernels/``.
"""

__version__ = "0.1.0"
