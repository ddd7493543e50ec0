"""Backend resolution: one op API, two implementations.

``get_batched_ops(config)`` is the same for ensembles: ops over B
independent members (``ops/ref.py``'s ``*_batched`` plain versions, and on
``cuda`` the batched entries of H1–H8, ``cuda_kernels.batched_overrides``).

``get_ops(config)`` returns a namespace with every op of the JAX package's
``ops/backend.py``, multigrid's ``pressure_solve_mg`` included.  ``ref`` is
the plain PyTorch oracle; ``cuda`` replaces the ops that the JAX package
runs as Pallas kernels with the Hopper kernels' wrappers
(``ops/cuda_kernels.py``), adds the optional ``pressure_project_mg`` hook
that the pipeline looks for, and keeps the ref ops for the rest.
"""

from __future__ import annotations

import types

from cudafluidsimulation_tpu_torch.config import FluidConfig
from cudafluidsimulation_tpu_torch.ops import ref as _ref

_OP_NAMES = [
    "bilerp",
    "advect_velocity",
    "advect_dye",
    "curl",
    "vorticity_confinement_cpu",
    "vorticity_confinement_gpu",
    "diffuse",
    "diffuse_multi",
    "diffuse_multi_splat",
    "divergence",
    "pressure_solve",
    "pressure_solve_mg",
    "pressure_project",
    "project",
    "splat_cpu",
    "splat_gpu",
    "cycle_color",
    "boundary_strip",
    "pack_rgba",
    "apply_bloom",
    "render_frame",
]


def _namespace(overrides=None) -> types.SimpleNamespace:
    ns = types.SimpleNamespace()
    for name in _OP_NAMES:
        setattr(ns, name, getattr(_ref, name))
    for name, fn in (overrides or {}).items():
        setattr(ns, name, fn)
    return ns


def get_ops(config: FluidConfig) -> types.SimpleNamespace:
    """The op namespace for ``config``; raises for ``backend='cuda'``
    without a CUDA device.  ``ref`` ignores the ``fast_*`` flags, as the
    JAX package's ref backend does."""
    backend = config.resolve_backend()
    if backend == "ref":
        return _namespace()
    from cudafluidsimulation_tpu_torch.ops import cuda_kernels

    return _namespace(cuda_kernels.overrides(config))


BATCHED_OP_NAMES = [
    "advect_velocity",
    "advect_dye",
    "vorticity_confinement_cpu",
    "vorticity_confinement_gpu",
    "diffuse",
    "diffuse_multi",
    "diffuse_multi_splat",
    "pressure_project",
    "pressure_project_mg",
    "splat_cpu",
    "splat_gpu",
]


def batched_namespace(overrides=None) -> types.SimpleNamespace:
    """The plain batched ops (``ref.<name>_batched``), ``boundary_strip``
    (which broadcasts over members) and ``overrides``."""
    ns = types.SimpleNamespace(boundary_strip=_ref.boundary_strip)
    for name in BATCHED_OP_NAMES:
        setattr(ns, name, getattr(_ref, f"{name}_batched"))
    for name, fn in (overrides or {}).items():
        setattr(ns, name, fn)
    return ns


def get_batched_ops(config: FluidConfig) -> types.SimpleNamespace:
    """The batched op namespace for ``config``; raises ``RuntimeError``
    for ``cuda`` and ``auto`` without a CUDA device, as :func:`get_ops`.
    ``ref`` ignores the ``fast_*`` flags."""
    if config.resolve_backend() == "ref":
        return batched_namespace()
    from cudafluidsimulation_tpu_torch.ops import cuda_kernels

    return batched_namespace(cuda_kernels.batched_overrides(config))
