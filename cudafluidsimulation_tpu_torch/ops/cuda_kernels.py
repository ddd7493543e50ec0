"""The hand-written Hopper kernels that take over from the JAX package's
Pallas kernels.

``overrides(config)`` maps op names to kernel wrappers, consumed by
``ops.backend.get_ops``:

- H1 advect (``ops/advect_cuda.py``, ``csrc/advect.cu``): ``advect_velocity``,
  ``advect_dye`` and, unless a fast mode is on, ``advect_both`` (velocity
  and dye in one launch, which the step takes in place of the two); H8,
  the bf16-tap mode of the same source, when ``fast_velocity`` or
  ``fast_dye`` asks for it (``advect_fast_path`` threaded through);
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

The single step (``models/pipelines.py``) takes, in place of four of these
wrappers, the prepared launch each offers as ``op.prepare``: H1's
``advect_both`` (``advect_cuda.BothLaunch``), H2's
``vorticity_confinement_gpu`` (``jacobi_cuda.VorticityLaunch``), H3's
``diffuse_multi_splat`` (``DiffuseSplatLaunch``; H7's ops offer none) and
H4's ``pressure_project`` (``PressureLaunch``): the same launches, prepared
once for a shape, stream and device and enqueued with one C call each.

Ensembles (``models/ensemble.py``) run B members a launch on the batched
entries of H1–H8 (``batched_overrides(config)``): H8 and H7 where the fast
modes ask for them (H7 where ``fastdiffuse.worthwhile`` grants it, with
every member's dt and coefficients held to the nominal ones), and H5 and
H6 under ``pressure_project_mg`` for multigrid pressure, each member
stopping at its own V-cycle count.

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

    vorticity_gpu = functools.partial(jacobi_cuda.vorticity_confinement, variant="gpu")
    vorticity_gpu.prepare = jacobi_cuda.VorticityLaunch
    out = {
        "advect_velocity": functools.partial(
            advect_cuda.advect_velocity, packed=config.fast_velocity,
            fast_path=config.advect_fast_path),
        "advect_dye": functools.partial(
            advect_cuda.advect_dye, packed=config.fast_dye,
            fast_path=config.advect_fast_path),
        "vorticity_confinement_gpu": vorticity_gpu,
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
    if not (config.fast_velocity or config.fast_dye):
        out["advect_both"] = advect_cuda.advect_both
    if config.fast_diffuse:
        # {} where the taps would not undercut the exact sweeps
        out.update(fastdiffuse.make_ops(config))
    return out


def batched_overrides(config: FluidConfig) -> dict:
    """Batched op name -> kernel wrapper over B members: H1 (its two
    passes in one launch, ``advect_both``) or H8 advection (``fast_velocity``,
    ``fast_dye``), H2, H3 or H7 diffusion
    (``fast_diffuse``, where granted), H4, and H5 with H6 under the
    multigrid hook."""
    from cudafluidsimulation_tpu_torch.ops import (
        advect_cuda, fastdiffuse, jacobi_cuda, multigrid, multigrid_cuda)

    out = {
        "advect_velocity": functools.partial(
            advect_cuda.advect_velocity_batched, packed=config.fast_velocity,
            fast_path=config.advect_fast_path),
        "advect_dye": functools.partial(
            advect_cuda.advect_dye_batched, packed=config.fast_dye,
            fast_path=config.advect_fast_path),
        "vorticity_confinement_gpu": functools.partial(
            jacobi_cuda.vorticity_confinement_batched, variant="gpu"),
        "vorticity_confinement_cpu": functools.partial(
            jacobi_cuda.vorticity_confinement_batched, variant="cpu"),
        "diffuse": jacobi_cuda.diffuse_batched,
        "diffuse_multi": jacobi_cuda.diffuse_multi_batched,
        "diffuse_multi_splat": jacobi_cuda.diffuse_multi_splat_batched,
        "pressure_project": jacobi_cuda.pressure_project_batched,
        "pressure_project_mg": functools.partial(
            multigrid.pressure_project_mg_batched, ends=multigrid_cuda.ENDS_BATCHED),
    }
    if not (config.fast_velocity or config.fast_dye):
        out["advect_both"] = advect_cuda.advect_both_batched
    if config.fast_diffuse:
        # {} where the taps would not undercut the exact sweeps
        out.update(fastdiffuse.make_batched_ops(config))
    return out
