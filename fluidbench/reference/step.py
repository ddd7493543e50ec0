"""The plain gpu-parity step and render, composed from ``reference/ops.py``.

The upstream app's step (GPUFluidSim.cu:604-715): advect velocity, advect
dye through the advected velocity, vorticity confinement, 5-channel Jacobi
diffusion of velocity and dye with the splat after the last sweep,
divergence -> Jacobi pressure from zero -> projection; then the render
with its bloom.  The scalar state (time, pressed time, time since the last
press, the cursor, the step count) follows the impulse stream on the host
in float32.

``dtype`` sets the precision of every field between two ops: float32 is
the reference, bfloat16 its lower-precision control.  Only the gpu
variant with colour diffusion, Jacobi pressure and no boundary strip is
written here; :class:`Params` refuses any other configuration.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from fluidbench.reference import ops
from fluidbench.reference.ops import F, f32, f32_vec

# the 7-entry dye palette cycled through while pressed (GPUFluidSim.cu:133-139)
PALETTE = np.asarray([
    (1.0, 0.0, 0.0), (0.0, 1.0, 0.0), (1.0, 0.0, 1.0), (1.0, 1.0, 0.0),
    (0.0, 1.0, 1.0), (1.0, 0.0, 1.0), (1.0, 0.5, 0.3)], np.float32)


class Params(NamedTuple):
    """The physical parameters of one configuration (its file's ``fluid``)."""

    nx: int
    ny: int
    dt: float
    velocity_diffusion: float
    color_diffusion: float
    decay_rate: float
    vorticity: float
    force_scale: float
    splat_radius: float
    diffusion_iters: int
    pressure_iters: int
    half_divergence: bool
    bloom_enabled: bool
    bloom_intense: float
    bloom_duration: float

    @staticmethod
    def from_fluid(fluid: dict) -> "Params":
        """The parameters from a configuration's ``fluid`` table; raises
        for a step this reference does not write."""
        wanted = {"variant": "gpu", "pressure_solver": "jacobi",
                  "color_diffusion_enabled": True, "boundary_rows": 0}
        for key, value in wanted.items():
            if fluid.get(key) != value:
                raise ValueError(f"the reference step needs {key}={value!r}, "
                                 f"got {fluid.get(key)!r}")
        return Params(**{k: fluid[k] for k in Params._fields})


class State(NamedTuple):
    """Fields on a device and the scalar state on the host."""

    u: torch.Tensor
    v: torch.Tensor
    dye: torch.Tensor
    pressure: torch.Tensor
    vel_stats: torch.Tensor
    t: np.float32
    press_time: np.float32
    time_since_press: np.float32
    mouse: np.ndarray
    step: int


class Impulse(NamedTuple):
    """One step's input: cursor position, previous position, press, dt."""

    pos: tuple
    last_pos: tuple
    pressed: bool
    dt: float


def init(p: Params, device, dtype=torch.float32) -> State:
    """Zero fields (the app's init), never pressed."""
    z = lambda *s: torch.zeros(s, dtype=dtype, device=device)  # noqa: E731
    return State(z(p.ny, p.nx), z(p.ny, p.nx), z(3, p.ny, p.nx), z(p.ny, p.nx),
                 torch.zeros(2, dtype=dtype, device=device), F(0), F(0), F(1e9),
                 np.zeros(2, np.float32), 0)


def step(p: Params, s: State, imp: Impulse, dtype=torch.float32) -> State:
    """One step from ``s`` under ``imp``; every field rounded to ``dtype``
    after each op."""
    c = lambda t: t.to(dtype)  # noqa: E731
    dt = f32(imp.dt)
    u, v, dye = c(s.u), c(s.v), c(s.dye)

    u, v = map(c, ops.advect_velocity(u, v, dt, p.decay_rate))
    dye = c(ops.advect_dye(dye, u, v, dt, p.decay_rate))
    u, v = map(c, ops.vorticity_confinement(u, v, dt, p.vorticity))

    scalars = host_scalars(s, imp, dtype)
    pressed_f = F(bool(imp.pressed))
    color = ops.cycle_color(PALETTE, scalars.press_time)
    cur = f32_vec(imp.pos)
    last = f32_vec(imp.last_pos)
    force = F(p.force_scale) * pressed_f
    amps = np.concatenate([
        np.asarray([(last[0] - cur[0]) * force * dt, (last[1] - cur[1]) * force * dt],
                   np.float32),
        color * pressed_f])
    coeffs = np.asarray([p.velocity_diffusion] * 2 + [p.color_diffusion] * 3, np.float32)
    pack = torch.cat([torch.stack([u, v]), dye])
    pack = c(ops.diffuse_multi(pack, dt, coeffs, p.diffusion_iters))
    pack = c(ops.splat_tail(pack, amps, last, p.splat_radius))
    u, v, dye = pack[0], pack[1], pack[2:]

    div = c(ops.divergence(u, v, p.half_divergence))
    pres = c(ops.pressure_solve(div, p.pressure_iters))
    u, v = map(c, ops.project(u, v, pres))

    return scalars._replace(u=u, v=v, dye=dye, pressure=pres, vel_stats=ops.vel_max(u, v))


def host_scalars(s: State, imp: Impulse, dtype=torch.float32) -> State:
    """The step's host scalars alone (fields untouched), float32 on the
    host and each rounded to ``dtype``: the recurrence a rollout's counters
    follow."""
    dt = f32(imp.dt)
    pressed = bool(imp.pressed)

    def r(x):
        return np.asarray(torch.tensor(np.asarray(x, np.float32)).to(dtype).float())

    return s._replace(
        t=F(r(f32(s.t) + dt)), press_time=F(r(f32(s.press_time) + dt * F(pressed))),
        time_since_press=F(0) if pressed else F(r(f32(s.time_since_press) + dt)),
        mouse=r(f32_vec(imp.pos)) if pressed else np.asarray(s.mouse, np.float32),
        step=int(s.step) + 1)


def render(p: Params, s: State, dtype=torch.float32) -> torch.Tensor:
    """The (H, W, 4) uint8 host-layout image of ``s`` (flipped, y up at the
    top), bloomed while the last press is under ``bloom_duration`` old."""
    dye = s.dye.to(dtype)
    if p.bloom_enabled:
        active = f32(s.time_since_press) < F(p.bloom_duration)
        frame = ops.render_frame(dye, s.mouse, p.bloom_intense, p.splat_radius, active)
    else:
        frame = ops.render_frame(dye, s.mouse, 0.0, p.splat_radius, False)
    return ops.frame_image(frame)
