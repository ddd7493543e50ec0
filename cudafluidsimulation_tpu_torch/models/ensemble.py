"""Batched ensembles: many independent simulations in one batched step.

The JAX package runs a parameter sweep as one vmapped rollout
(BASELINE.json config 4: 64 × 512² on one chip).  Here the batch dimension
is written out: the state's fields carry a leading member axis, and each
stage of a step is one call for the whole batch
(``models/pipelines.make_batched_step``, the single step's own body), on
the card the kernels over every member at once, with each member's scalars
in device memory: H1–H4 for the parity step (H3's diffusion and H4's
pressure as wavefront passes), H8 and H7 for the fast modes, H5 and H6 for
multigrid pressure, where each member stops at its own V-cycle count as
under a vmapped while-loop.  The rollout is a Python loop over time, as
``Simulation.run`` is.  ``backend="ref"`` runs every configuration on the
plain ops (and ignores the ``fast_*`` flags).

One departure from the JAX package: its fast diffusion ignores the traced
coefficient, so a ``fast_diffuse`` viscosity sweep there quietly runs
every member at the config's viscosity.  Here, where the separable taps
are in effect, :func:`make_diffusion_sweep_run` raises ``ValueError``
before the first step unless every member's viscosity and dt are the
config's (``ops.fastdiffuse.make_batched_ops``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from cudafluidsimulation_tpu_torch.config import FluidConfig
from cudafluidsimulation_tpu_torch.models.pipelines import make_batched_step
from cudafluidsimulation_tpu_torch.ops.backend import get_batched_ops
from cudafluidsimulation_tpu_torch.state import FluidState, init_state
from cudafluidsimulation_tpu_torch.utils.impulse import Impulse


def batched_state(config: FluidConfig, n: int, device=None) -> FluidState:
    """``n`` copies of the initial state, stacked on a leading member axis:
    fields (n, H, W), dye (n, 3, H, W) and vel_stats (n, 2) on ``device``
    (``state.default_device`` when None), the scalar state (n,) and mouse
    (n, 2) on the host."""
    return FluidState(*(torch.stack([x] * n) for x in init_state(config, device)))


def batched_impulse(imp: Impulse, n: int,
                    jitter_pos: Optional[np.ndarray] = None) -> Impulse:
    """Tile a (T, ...) impulse stream to (n, T, ...) host tensors;
    ``jitter_pos`` (n, 2) offsets each member's positions for decorrelated
    sweeps."""
    out = Impulse(*(torch.stack([f] * n) for f in imp))
    if jitter_pos is not None:
        j = torch.as_tensor(np.asarray(jitter_pos, np.float32))[:, None, :]
        out = out._replace(pos=out.pos + j, last_pos=out.last_pos + j)
    return out


def step_of(impulses: Impulse, i: int) -> Impulse:
    """Step ``i`` of every member of an (n, T, ...) stream."""
    return Impulse(*(f[:, i] for f in impulses))


def run_batched(step_fn, state: FluidState, impulses: Impulse) -> FluidState:
    """Run a batched step over every step of an (n, T, ...) stream."""
    for i in range(int(impulses.pressed.shape[1])):
        state = step_fn(state, step_of(impulses, i))
    return state


def make_ensemble_run(config: FluidConfig, ops=None):
    """``run(batched_state, (n, T) impulses) -> batched final state``;
    ``ops``: a batched namespace (``get_batched_ops(config)`` when None)."""
    step = make_batched_step(config, ops)

    def run(state: FluidState, impulses: Impulse) -> FluidState:
        return run_batched(step, state, impulses)

    return run


def make_diffusion_sweep_run(config: FluidConfig, ops=None):
    """A rollout with a velocity-diffusion coefficient per member:
    ``run(diffusions (n,), batched_state, (n, T) impulses) -> batched
    final``.  Channels 0-1 (velocity) of every diffusion op take the
    member's coefficient, the dye the config's (the JAX package's
    ``_step_with_diffusion``).  ``ops``: a batched namespace
    (``get_batched_ops(config)`` when None).  Where the namespace's
    diffusion is the fast taps' (its ``check_sweep``), a member whose
    viscosity, or a step whose dt, is not the config's raises
    ``ValueError`` before the first step."""
    ops = get_batched_ops(config) if ops is None else ops
    check_sweep = getattr(ops, "check_sweep", None)

    def run(diffusions, state: FluidState, impulses: Impulse) -> FluidState:
        diffusions = np.asarray(diffusions, np.float32).reshape(-1)
        if check_sweep is not None:
            check_sweep(impulses.dt, diffusions)
        return run_batched(make_batched_step(config, ops, diffusions), state, impulses)

    return run
