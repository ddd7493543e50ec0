"""The hand-written Hopper kernels that take over from the JAX package's
Pallas kernels.

``overrides(config)`` maps op names to kernel wrappers, consumed by
``ops.backend.get_ops``:

- H1 advect (``ops/advect_cuda.py``, ``csrc/advect.cu``): ``advect_velocity``,
  ``advect_dye``;
- H2 vorticity (``ops/jacobi_cuda.py``, ``csrc/vorticity.cu``): both
  variants;
- H3 diffusion (``csrc/diffuse.cu``): ``diffuse``, ``diffuse_multi``,
  ``diffuse_multi_splat``;
- H4 pressure (``csrc/pressure.cu``): ``pressure_project``, and its
  standalone ``pressure_solve``;
- H5 (``csrc/pressure.cu``): ``divergence``, ``project``;
- H6 multigrid smoother ends (``ops/multigrid_cuda.py``,
  ``csrc/multigrid.cu``) under ``pressure_solve_mg`` and the optional
  ``pressure_project_mg`` hook that the pipeline takes for
  ``pressure_solver="multigrid"`` (multigrid's restriction and
  prolongation stay plain torch, ``ops/multigrid.py``).

The TPU kernels' planners (strip heights, bursts, column tiles, padding)
have no counterpart: every kernel here takes any grid shape, so every
multigrid level runs on the kernels.
"""

from __future__ import annotations

import functools

from cudafluidsimulation_tpu_torch.config import FluidConfig


def overrides(config: FluidConfig) -> dict:
    from cudafluidsimulation_tpu_torch.ops import (
        advect_cuda, jacobi_cuda, multigrid, multigrid_cuda)

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
        "divergence": jacobi_cuda.divergence,
        "pressure_solve": jacobi_cuda.pressure_solve,
        "pressure_project": jacobi_cuda.pressure_project,
        "project": jacobi_cuda.project,
        "pressure_solve_mg": functools.partial(
            multigrid.pressure_solve_mg, smoother=multigrid_cuda.ENDS),
        "pressure_project_mg": functools.partial(
            multigrid.pressure_project_mg, ends=multigrid_cuda.ENDS),
    }
