"""Simulation configuration for the PyTorch/CUDA port.

The same fields, defaults and presets as ``cudafluidsimulation_tpu.config``
(tests/test_torch_config_state.py holds the two field by field), with one
difference: ``backend`` is ``ref | cuda | auto``.

- ``ref``: plain PyTorch ops (``ops/ref.py``) on whatever device the state
  lives on.  They are the port's oracle and the kernels' plain versions.
- ``cuda``: the hand-written Hopper kernels (``ops/cuda_kernels.py``) over
  the ref ops.  Resolving it without a CUDA device raises.
- ``auto`` (the default): the same as ``cuda``, and it raises without a
  CUDA device too, so a simulation never falls back to the CPU unasked.

``block_rows``, which steers the TPU kernels' strips, is carried for
parity and has no effect here.  ``jacobi_burst`` and ``max_displacement``
set the sharded rollout's halos (``parallel/``): the sweeps between two
exchanges, and the advection's halo depth, which bounds its taps there;
on one device neither has an effect (the port's advection is unbounded
like the JAX ref backend).  Multigrid pressure (the ``quality`` preset) and the fast
modes are ported: ``fast_diffuse`` (separable diffusion, kernel H7),
``fast_velocity`` and ``fast_dye`` (bf16-tap advection, kernel H8).  With
a packed mode, ``advect_fast_path`` decides whether a quiet step (realized
displacement under one cell) takes the exact f32 taps (True) or every
step rounds its taps (False).  ``backend="ref"`` ignores the ``fast_*``
flags, as the JAX package's ref backend does.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

# 7-entry dye palette cycled through while the impulse is pressed
# (cpuFluidSim.cpp:66-72 / GPUFluidSim.cu:133-139).
PALETTE: Tuple[Tuple[float, float, float], ...] = (
    (1.0, 0.0, 0.0),
    (0.0, 1.0, 0.0),
    (1.0, 0.0, 1.0),
    (1.0, 1.0, 0.0),
    (0.0, 1.0, 1.0),
    (1.0, 0.0, 1.0),
    (1.0, 0.5, 0.3),
)


@dataclasses.dataclass(frozen=True)
class FluidConfig:
    """Static configuration for one simulation (see the JAX package's
    ``FluidConfig`` for the reference citation of every field)."""

    nx: int = 256
    ny: int = 256
    variant: str = "gpu"
    backend: str = "auto"
    dt: float = 1.0 / 60.0
    velocity_diffusion: float = 0.8
    color_diffusion: float = 0.8
    decay_rate: float = 1.2
    vorticity: float = 50.0
    force_scale: float = 5000.0
    splat_radius: float = 400.0
    diffusion_iters: int = 20
    pressure_iters: int = 30
    pressure_solver: str = "jacobi"
    mg_cycles: int = 2
    mg_tol: float = 0.0
    mg_max_cycles: int = 8
    boundary_rows: int = 0
    color_diffusion_enabled: bool = True
    half_divergence: bool = True
    bloom_enabled: bool = True
    bloom_intense: float = 0.1
    bloom_duration: float = 5.0
    block_rows: int = 256
    jacobi_burst: int = 8
    max_displacement: int = 15
    fast_dye: bool = False
    fast_velocity: bool = False
    fast_diffuse: bool = False
    advect_fast_path: bool = True

    def __post_init__(self):
        if self.variant not in ("cpu", "gpu"):
            raise ValueError(f"variant must be 'cpu' or 'gpu', got {self.variant!r}")
        if self.backend not in ("ref", "cuda", "auto"):
            raise ValueError(f"unknown backend {self.backend!r}")
        if self.pressure_solver not in ("jacobi", "multigrid"):
            raise ValueError(f"unknown pressure_solver {self.pressure_solver!r}")
        if self.diffusion_iters < 0 or self.pressure_iters < 0:
            raise ValueError("iteration counts must be >= 0")
        if self.mg_cycles < 1:
            raise ValueError("mg_cycles must be >= 1")
        if self.mg_tol < 0:
            raise ValueError("mg_tol must be >= 0 (0 = fixed mg_cycles)")
        if self.mg_max_cycles < 1:
            raise ValueError("mg_max_cycles must be >= 1")
        if self.max_displacement < 1:
            raise ValueError("max_displacement must be >= 1")

    # -- reference configurations -------------------------------------------

    @staticmethod
    def cpu_reference(nx: int = 128, ny: int = 128, **overrides) -> "FluidConfig":
        """The reference CPU backend's exact parameter set (128² grid,
        globals at cpuFluidSim.cpp:25-29)."""
        kw = dict(
            nx=nx,
            ny=ny,
            variant="cpu",
            velocity_diffusion=0.8,
            color_diffusion=0.8,
            decay_rate=1.2,
            vorticity=0.35,
            force_scale=500.0,
            splat_radius=10.0,
            diffusion_iters=5,
            pressure_iters=5,
            boundary_rows=11,
            color_diffusion_enabled=False,
            half_divergence=False,
            bloom_enabled=False,
        )
        kw.update(overrides)
        return FluidConfig(**kw)

    @staticmethod
    def gpu_reference(nx: int = 960, ny: int = 540, **overrides) -> "FluidConfig":
        """The reference GPU backend's exact parameter set (960x540 grid,
        setConfig defaults at GPUFluidSim.cu:51-73)."""
        kw = dict(
            nx=nx,
            ny=ny,
            variant="gpu",
            velocity_diffusion=0.8,
            color_diffusion=0.8,
            decay_rate=1.2,
            vorticity=50.0,
            force_scale=5000.0,
            splat_radius=400.0,
            diffusion_iters=20,
            pressure_iters=30,
            boundary_rows=0,
            color_diffusion_enabled=True,
            half_divergence=True,
            bloom_enabled=True,
        )
        kw.update(overrides)
        return FluidConfig(**kw)

    @staticmethod
    def quality(nx: int = 2048, ny: int = 2048, **overrides) -> "FluidConfig":
        """Beyond-parity "quality" preset: multigrid pressure with
        residual-targeted stopping (V-cycles until rms(A p + div) < 0.05,
        at most ``mg_max_cycles``).  On ``backend="cuda"`` the projection
        runs on kernels H5 and H6 (``ops/multigrid.py``)."""
        kw = dict(
            pressure_solver="multigrid",
            mg_tol=0.05,
            max_displacement=31,
        )
        kw.update(overrides)
        return FluidConfig.gpu_reference(nx=nx, ny=ny, **kw)

    # -- derived ------------------------------------------------------------

    @property
    def shape(self) -> Tuple[int, int]:
        """(ny, nx) — fields are (H, W) row-major, y is the row axis."""
        return (self.ny, self.nx)

    def palette_array(self) -> np.ndarray:
        return np.asarray(PALETTE, dtype=np.float32)

    def resolve_backend(self) -> str:
        """``ref`` or ``cuda``; ``cuda`` and ``auto`` without a CUDA device
        raise: the plain ops run on the CPU only when ``backend='ref'``
        asks for them."""
        import torch

        if self.backend == "ref":
            return "ref"
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"backend={self.backend!r} runs the CUDA kernels and needs a "
                "CUDA device, but torch.cuda.is_available() is False; pass "
                "backend='ref' to run the plain PyTorch ops on the CPU")
        return "cuda"

