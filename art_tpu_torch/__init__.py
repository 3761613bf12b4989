"""art_tpu_torch — the PyTorch/CUDA port of the art_tpu wavefront path tracer.

The JAX package ``art_tpu`` is the reference: this package keeps its module
names and its component-planar layout (vectors are 3-tuples of ``(R,)``
tensors), with PyTorch idiom inside — plain functions on tensors, an
explicit ``device`` everywhere, no autograd.  The kernels that ``art_tpu``
wrote in Pallas for the TPU are CUDA C++ kernels for Hopper (``csrc/``),
built with ``nvcc`` at first use and bound with ``ctypes``
(``ops/_build.py``).  Each one has a plain PyTorch twin that the wrapper
takes for CPU tensors, so the whole port runs (slowly) on the CPU.

This package imports ``torch`` and never ``jax``.  Importing it builds
nothing and touches no device.
"""

__version__ = "0.1.0"
