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

Ensembles (``models/ensemble.py``) run B members a launch on the batched
entries of H1–H4 (``batched_overrides``); the other kernels have no batch
dimension yet, so :func:`check_batched` refuses a configuration that needs
them.

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


def check_batched(config: FluidConfig) -> None:
    """Raise ``NotImplementedError`` for an ensemble whose step needs a
    kernel without a batch dimension: the fast modes (H7, H8) and
    multigrid pressure (H5, H6).  Nothing falls back to a loop or to the
    CPU; ``backend="ref"`` runs every configuration on the plain ops."""
    lacking = []
    if config.fast_dye or config.fast_velocity or config.fast_diffuse:
        lacking.append("the fast modes (H7 separable diffusion, H8 bf16-tap advection)")
    if config.pressure_solver == "multigrid":
        lacking.append("multigrid pressure (H5 divergence/projection, H6 smoother ends)")
    if lacking:
        raise NotImplementedError(
            "ensembles on the CUDA kernels run H1-H4 only; " + " and ".join(lacking)
            + " need kernels that have no batch dimension yet (H5-H8; ROADMAP queue 1, "
            "item 10). "
            "Use backend='ref' for the plain ops.")


def batched_overrides() -> dict:
    """Batched op name -> kernel wrapper (H1–H4 over B members)."""
    from cudafluidsimulation_tpu_torch.ops import advect_cuda, jacobi_cuda

    return {
        "advect_velocity": advect_cuda.advect_velocity_batched,
        "advect_dye": advect_cuda.advect_dye_batched,
        "vorticity_confinement_gpu": functools.partial(
            jacobi_cuda.vorticity_confinement_batched, variant="gpu"),
        "vorticity_confinement_cpu": functools.partial(
            jacobi_cuda.vorticity_confinement_batched, variant="cpu"),
        "diffuse": jacobi_cuda.diffuse_batched,
        "diffuse_multi": jacobi_cuda.diffuse_multi_batched,
        "diffuse_multi_splat": jacobi_cuda.diffuse_multi_splat_batched,
        "pressure_project": jacobi_cuda.pressure_project_batched,
    }
