"""art_tpu_torch — the PyTorch/CUDA port of the art_tpu wavefront path tracer.

The JAX package ``art_tpu`` is the reference: this package keeps its module
names and its component-planar layout (vectors are 3-tuples of ``(R,)``
tensors), with PyTorch idiom inside — plain functions on tensors, an
explicit ``device`` everywhere, no autograd.  The kernels that ``art_tpu``
wrote in Pallas for the TPU are CUDA C++ kernels for Hopper (``csrc/``),
built with ``nvcc`` at first use and bound with ``ctypes``
(``ops/_build.py``).  Each one has a plain PyTorch twin that the wrapper
takes for CPU tensors, so the whole port runs (slowly) on the CPU.

This package imports ``torch`` and never ``jax``.  It exports
``art_tpu``'s seven names (``SceneBuilder``, ``CompiledScene``,
``render_scene``, ``RenderConfig``, ``SCENES``, ``build_scene``,
``scene_defaults``) and the multi-device ``render_scene_sharded`` and
``make_mesh`` (``art_tpu.parallel``'s, also in ``art_tpu_torch.parallel``),
each loaded at its first use by the module's ``__getattr__``: importing the
package imports no submodule, not even ``torch``, builds nothing and
touches no device.
"""

import importlib

__version__ = "0.1.0"

_EXPORTS = {
    "SceneBuilder": "art_tpu_torch.scene.builder",
    "CompiledScene": "art_tpu_torch.scene.builder",
    "render_scene": "art_tpu_torch.render.renderer",
    "RenderConfig": "art_tpu_torch.render.renderer",
    "SCENES": "art_tpu_torch.models",
    "build_scene": "art_tpu_torch.models",
    "scene_defaults": "art_tpu_torch.models",
    "render_scene_sharded": "art_tpu_torch.parallel.sharding",
    "make_mesh": "art_tpu_torch.parallel.sharding",
}

__all__ = list(_EXPORTS)


def __getattr__(name: str):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(_EXPORTS[name]), name)
    globals()[name] = value
    return value


def __dir__():
    return sorted(list(globals()) + __all__)
