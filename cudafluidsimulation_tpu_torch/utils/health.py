"""Simulation health checks — the failure-detection layer the reference
lacks entirely (SURVEY.md §5: only a CUDA abort macro).

Numerical blow-up in a stable-fluids step shows up as NaN/Inf fields or
runaway velocity magnitudes.  These helpers make that observable at the
harness level without touching the hot loop: run segments, check between
segments, and report the segment where health was lost.  A check reduces
on the state's device and reads its five scalars back in one transfer.

Health also reports the realized advection displacement (max |u|*dt,
max |v|*dt).  The JAX package's Pallas advection and its sharded meshes
bound backtrace taps at ``config.max_displacement`` cells, and
:func:`displacement_check` warns where a flow outruns that bound.  The
port's single-device advection (H1, H8 and the plain ops) is the
reference's unbounded backtrace (GPUFluidSim.cu:267), so
:func:`clamp_axes` says no axis is clamped there.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from cudafluidsimulation_tpu_torch.state import FluidState
from cudafluidsimulation_tpu_torch.utils.impulse import Impulse, num_steps


class Health(NamedTuple):
    finite: bool
    max_speed: float
    max_dye: float
    max_abs_u: float = 0.0
    max_abs_v: float = 0.0

    @property
    def ok(self) -> bool:
        return self.finite

    def realized_displacement(self, dt: float) -> Tuple[float, float]:
        """(max |u|*dt, max |v|*dt): the realized backtrace displacement in
        cells, the quantity an advection bound ``max_displacement`` clamps."""
        return self.max_abs_u * dt, self.max_abs_v * dt


class HealthError(RuntimeError):
    pass


def _health_stats(state: FluidState):
    """(finite, max speed, max dye, max|u|, max|v|), reduced on the
    state's device and read back as one stacked tensor."""
    u, v = state.u, state.v
    finite = (torch.isfinite(u).all() & torch.isfinite(v).all()
              & torch.isfinite(state.dye).all() & torch.isfinite(state.pressure).all())
    stats = torch.stack([
        finite.to(torch.float32),
        torch.sqrt(torch.max(u * u + v * v)),
        torch.max(state.dye),
        torch.max(torch.abs(u)),
        torch.max(torch.abs(v)),
    ]).tolist()
    return bool(stats[0]), *stats[1:]


def check_health(state: FluidState, max_speed: Optional[float] = None) -> Health:
    h = Health(*_health_stats(state))
    if not h.finite:
        raise HealthError(
            f"non-finite fields at step {int(state.step)} "
            f"(t={float(state.t):.4f})"
        )
    if max_speed is not None and h.max_speed > max_speed:
        raise HealthError(
            f"velocity blow-up at step {int(state.step)}: "
            f"max speed {h.max_speed:.1f} > limit {max_speed:.1f}"
        )
    return h


def displacement_check(health: Health, dt: float, bound: int,
                       axes: str = "y") -> Optional[str]:
    """Warning string when the realized backtrace displacement exceeds the
    advection bound on the clamped axes (``"y"``, or ``"xy"`` for both),
    else None."""
    dx, dy = health.realized_displacement(dt)
    clamped = []
    if dy > bound:
        clamped.append(f"|v|*dt = {dy:.1f}")
    if "x" in axes and dx > bound:
        clamped.append(f"|u|*dt = {dx:.1f}")
    if not clamped:
        return None
    return (
        f"advection clamp: realized displacement {' and '.join(clamped)} "
        f"cells exceeds max_displacement={bound}; backtraces are clamped "
        f"where the flow is fast (physics diverges from the reference's "
        f"unbounded backtrace) — raise --max-displacement to "
        f"{int(max(dx if 'x' in axes else 0.0, dy)) + 1} or more for "
        f"exactness"
    )


def clamp_axes(backend: str, mesh: str = "none") -> str:
    """Which advection axes an execution path clamps at
    ``max_displacement``: '' = none (exact unbounded backtrace),
    'y' = vertical only, 'xy' = both.

    Every single-device backend of the port is exact: H1 and H8 backtrace
    without a bound, unlike the JAX package's Pallas kernel, which bounds
    vertical taps (its ``clamp_axes("pallas")`` is 'y').  The sharded
    meshes, not yet ported, keep the JAX package's answers: both bound
    vertical taps by their halo depth, and the 2-D mesh horizontal ones
    too."""
    del backend
    if mesh == "2d":
        return "xy"
    if mesh == "rows":
        return "y"
    return ""


def run_checked(sim, state: FluidState, impulses, segment: int = 100,
                max_speed: Optional[float] = None) -> FluidState:
    """Run a rollout in ``segment``-step slices with a health check between
    slices; raises HealthError naming the failing segment."""
    total = num_steps(impulses)
    start = 0
    while start < total:
        end = min(start + segment, total)
        part = Impulse(*(f[start:end] for f in impulses))
        state = sim.run(state, part)
        check_health(state, max_speed=max_speed)
        start = end
    return state
