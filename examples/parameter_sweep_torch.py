"""Viscosity parameter sweep on the PyTorch/CUDA port: 16 simulations of
256² in one batched rollout on one CUDA device (each stage one launch of
kernels H1-H4 for all 16).

    python examples/parameter_sweep_torch.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from cudafluidsimulation_tpu_torch import FluidConfig
from cudafluidsimulation_tpu_torch.models.ensemble import (
    batched_impulse,
    batched_state,
    make_diffusion_sweep_run,
)
from cudafluidsimulation_tpu_torch.utils.impulse import orbit_impulse


def main():
    cfg = FluidConfig.gpu_reference(nx=256, ny=256)
    b = 16
    run = make_diffusion_sweep_run(cfg)

    imp = orbit_impulse(200, cfg.dt, center=(128, 128), radius=32)
    viscosities = np.linspace(0.1, 2.0, b, dtype=np.float32)
    out = run(viscosities, batched_state(cfg, b), batched_impulse(imp, b))

    ke = (0.5 * (out.u ** 2 + out.v ** 2).mean(dim=(1, 2))).cpu().numpy()
    for visc, k in zip(viscosities, ke):
        print(f"viscosity {visc:5.2f}: kinetic energy {k:10.2f}")


if __name__ == "__main__":
    main()
