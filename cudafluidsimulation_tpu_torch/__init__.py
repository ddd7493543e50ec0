"""The stable-fluids engine ported to PyTorch and CUDA.

A second package beside the JAX one (``cudafluidsimulation_tpu``), with the
same module names and public names.  Plain PyTorch ops (``ops/ref.py``)
are the oracle; on a CUDA device the main path's stencil and advection ops
run on hand-written Hopper kernels (``csrc/*.cu``, built with ``nvcc`` at
first use).  The port imports ``torch`` and never ``jax``.
"""

from cudafluidsimulation_tpu_torch.config import FluidConfig, PALETTE
from cudafluidsimulation_tpu_torch.state import FluidState, init_state
from cudafluidsimulation_tpu_torch.models.pipelines import make_step
from cudafluidsimulation_tpu_torch.models.simulation import Simulation, run_scan
from cudafluidsimulation_tpu_torch.models.ensemble import (
    batched_impulse,
    batched_state,
    make_diffusion_sweep_run,
    make_ensemble_run,
)
from cudafluidsimulation_tpu_torch.utils.impulse import (
    Impulse,
    no_impulse,
    constant_impulse,
    orbit_impulse,
    mouse_to_grid,
)

__all__ = [
    "FluidConfig",
    "PALETTE",
    "FluidState",
    "init_state",
    "make_step",
    "Simulation",
    "run_scan",
    "batched_state",
    "batched_impulse",
    "make_ensemble_run",
    "make_diffusion_sweep_run",
    "Impulse",
    "no_impulse",
    "constant_impulse",
    "orbit_impulse",
    "mouse_to_grid",
]

__version__ = "0.1.0"
