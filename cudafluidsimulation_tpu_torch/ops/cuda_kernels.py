"""The hand-written Hopper kernels that take over from the JAX package's
Pallas kernels on the main path.

``overrides(config)`` maps op names to kernel wrappers, consumed by
``ops.backend.get_ops``:

- H1 advect (``ops/advect_cuda.py``, ``csrc/advect.cu``): ``advect_velocity``,
  ``advect_dye``;
- H2 vorticity (``ops/jacobi_cuda.py``, ``csrc/vorticity.cu``): both
  variants;
- H3 diffusion (``csrc/diffuse.cu``): ``diffuse``, ``diffuse_multi``,
  ``diffuse_multi_splat``;
- H4 pressure (``csrc/pressure.cu``): ``pressure_project``.

The TPU kernels' planners (strip heights, bursts, column tiles, padding)
have no counterpart: every kernel here takes any grid shape.
"""

from __future__ import annotations

import functools

from cudafluidsimulation_tpu_torch.config import FluidConfig


def overrides(config: FluidConfig) -> dict:
    from cudafluidsimulation_tpu_torch.ops import advect_cuda, jacobi_cuda

    del config  # every geometry is supported; no config-dependent choice
    return {
        "advect_velocity": advect_cuda.advect_velocity,
        "advect_dye": advect_cuda.advect_dye,
        "vorticity_confinement_gpu": functools.partial(
            jacobi_cuda.vorticity_confinement, variant="gpu"),
        "vorticity_confinement_cpu": functools.partial(
            jacobi_cuda.vorticity_confinement, variant="cpu"),
        "diffuse": jacobi_cuda.diffuse,
        "diffuse_multi": jacobi_cuda.diffuse_multi,
        "diffuse_multi_splat": jacobi_cuda.diffuse_multi_splat,
        "pressure_project": jacobi_cuda.pressure_project,
    }
