"""deephall-tpu on PyTorch and CUDA: the port of ``deephall_tpu`` to an NVIDIA H100.

The JAX package ``deephall_tpu`` stays the reference.  This package imports
``torch``, ``numpy``, ``yaml`` and the standard library, never JAX and nothing
of ``deephall_tpu``.  Its entry points run on ``cuda`` unless the caller passes
``device="cpu"``; on the CPU every hand-written kernel is replaced by its plain
PyTorch version.
"""

__version__ = "0.1.0"
