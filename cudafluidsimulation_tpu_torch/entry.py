"""The port's entry point: one step of the flagship configuration and its
arguments, the counterpart of the JAX package's ``__graft_entry__.entry``.

    from cudafluidsimulation_tpu_torch.entry import entry

    step, (state, imp) = entry()        # on the card
    state = step(state, imp)
"""

from __future__ import annotations

from cudafluidsimulation_tpu_torch.config import FluidConfig
from cudafluidsimulation_tpu_torch.models.pipelines import make_step
from cudafluidsimulation_tpu_torch.state import init_state
from cudafluidsimulation_tpu_torch.utils.impulse import single


def entry(backend: str = "auto", device=None):
    """(step, (state, impulse)): the gpu-parity stable-fluids step at 512²
    with 40 pressure sweeps, a zero state and one pressed impulse.

    The default ``backend="auto"`` runs the Hopper kernels on the card and
    raises without one; ``backend="ref"`` runs the plain PyTorch ops, on
    the CPU unless ``device`` names another."""
    cfg = FluidConfig.gpu_reference(nx=512, ny=512, pressure_iters=40, backend=backend)
    step = make_step(cfg)
    state = init_state(cfg, device)
    imp = single((256.0, 256.0), (250.0, 252.0), True, cfg.dt)
    return step, (state, imp)
