"""tpu_nexus_torch: the PyTorch/CUDA port of ``tpu_nexus`` for NVIDIA Hopper.

The JAX package (``tpu_nexus``) stays the reference; this package imports
``torch``, ``numpy`` and the standard library only, never ``jax`` and
nothing of ``tpu_nexus``.  Every Pallas kernel on a ported path becomes a
hand-written CUDA kernel (``csrc/``), built at first use
(``ops/_build.py``).  Entry points run on ``cuda`` unless the caller asks
for the CPU.
"""

__version__ = "0.1.0"
