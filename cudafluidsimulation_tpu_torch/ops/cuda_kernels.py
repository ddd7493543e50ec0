"""The hand-written Hopper kernels that take over from the JAX package's
Pallas kernels.

``overrides(config)`` maps op names to kernel wrappers, consumed by
``ops.backend.get_ops``:

- H1 advect (``ops/advect_cuda.py``, ``csrc/advect.cu``): ``advect_velocity``,
  ``advect_dye``; H8, its bf16-tap entry in the same source, when
  ``fast_velocity`` or ``fast_dye`` asks for it (``advect_fast_path``
  threaded through);
- H2 vorticity (``ops/jacobi_cuda.py``, ``csrc/vorticity.cu``): both
  variants;
- H3 diffusion (``csrc/diffuse.cu``): ``diffuse``, ``diffuse_multi``,
  ``diffuse_multi_splat``; with ``fast_diffuse``, H7 separable diffusion
  (``ops/fastdiffuse.py``, ``ops/fastdiffuse_cuda.py``,
  ``csrc/sepdiffuse.cu``) takes the three over wherever
  ``fastdiffuse.worthwhile`` grants it;
- H4 pressure (``csrc/pressure.cu``): ``pressure_project``, and its
  standalone ``pressure_solve``;
- H5 (``csrc/pressure.cu``): ``divergence``, ``project``;
- H6 multigrid smoother ends (``ops/multigrid_cuda.py``,
  ``csrc/multigrid.cu``) under ``pressure_solve_mg`` and the optional
  ``pressure_project_mg`` hook that the pipeline takes for
  ``pressure_solver="multigrid"``; on that hook the restriction and the
  prolongation ride the ends' launches (``ops/multigrid.py``).

The TPU kernels' planners (strip heights, bursts, column tiles, padding)
have no counterpart: every kernel here takes any grid shape, so every
multigrid level runs on the kernels, and fast diffusion has no shape gate.
"""

from __future__ import annotations

import functools

from cudafluidsimulation_tpu_torch.config import FluidConfig


def overrides(config: FluidConfig) -> dict:
    from cudafluidsimulation_tpu_torch.ops import (
        advect_cuda, fastdiffuse, jacobi_cuda, multigrid, multigrid_cuda)

    out = {
        "advect_velocity": functools.partial(
            advect_cuda.advect_velocity, packed=config.fast_velocity,
            fast_path=config.advect_fast_path),
        "advect_dye": functools.partial(
            advect_cuda.advect_dye, packed=config.fast_dye,
            fast_path=config.advect_fast_path),
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
    if config.fast_diffuse:
        # {} where the taps would not undercut the exact sweeps
        out.update(fastdiffuse.make_ops(config))
    return out
