"""Scripted impulse streams — the headless replacement for mouse input.

An :class:`Impulse` holds per-step cursor data as CPU tensors (the leading
axis is time).  The stream stays on the host: the step reads its scalars
without touching the device.  Positions are in grid coordinates (x right,
y up).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch


class Impulse(NamedTuple):
    """Per-step impulse; leading axis is time for a stream."""

    pos: torch.Tensor  # (2,) current position, grid coords (x, y), f32
    last_pos: torch.Tensor  # (2,) previous position, f32
    pressed: torch.Tensor  # () bool — whether the splat fires this step
    dt: torch.Tensor  # () f32 per-step timestep


def _stack(pos, last, pressed, dt) -> Impulse:
    return Impulse(
        pos=torch.as_tensor(np.asarray(pos, np.float32)),
        last_pos=torch.as_tensor(np.asarray(last, np.float32)),
        pressed=torch.as_tensor(np.asarray(pressed, bool)),
        dt=torch.as_tensor(np.asarray(dt, np.float32)),
    )


def no_impulse(steps: int, dt: float) -> Impulse:
    """``steps`` steps of free evolution (no splat)."""
    z = np.zeros((steps, 2), np.float32)
    return _stack(z, z, np.zeros((steps,), bool), np.full((steps,), dt, np.float32))


def constant_impulse(
    steps: int,
    dt: float,
    pos: Tuple[float, float],
    last_pos: Optional[Tuple[float, float]] = None,
    pressed: bool = True,
) -> Impulse:
    """Hold the cursor at ``pos`` (optionally having dragged from
    ``last_pos``) for ``steps`` steps."""
    p = np.tile(np.asarray(pos, np.float32), (steps, 1))
    l = np.tile(np.asarray(last_pos if last_pos is not None else pos, np.float32), (steps, 1))
    return _stack(p, l, np.full((steps,), pressed, bool), np.full((steps,), dt, np.float32))


def orbit_impulse(
    steps: int,
    dt: float,
    center: Tuple[float, float],
    radius: float,
    omega: float = 2.0,
    pressed_every: int = 1,
) -> Impulse:
    """Circular stirring: the cursor orbits ``center``; ``last_pos`` is the
    previous sample, so the drag force follows an interactive drag."""
    t = np.arange(steps + 1, dtype=np.float32) * dt
    xs = center[0] + radius * np.cos(omega * t)
    ys = center[1] + radius * np.sin(omega * t)
    pos = np.stack([xs[1:], ys[1:]], axis=1)
    last = np.stack([xs[:-1], ys[:-1]], axis=1)
    pressed = (np.arange(steps) % pressed_every) == 0
    return _stack(pos, last, pressed, np.full((steps,), dt, np.float32))


def concat_impulses(*parts: Impulse) -> Impulse:
    """The streams ``parts`` one after another."""
    return Impulse(*(torch.cat(fields, dim=0) for fields in zip(*parts)))


def impulse_from_file(path: str, dt: float) -> Impulse:
    """Load a scripted impulse stream from JSON — the replayable equivalent
    of the reference's recorded mouse interaction.

    Format: a list of events, each ``[x, y, pressed]`` (grid coords, one per
    step) or ``{"pos": [x, y], "pressed": bool, "dt": t}``.  ``last_pos`` is
    the previous event's position (like GLFW polling, Main.cpp:228-233).
    """
    import json

    with open(path) as f:
        events = json.load(f)
    if not events:
        raise ValueError(f"{path}: empty impulse script")
    pos, pressed, dts = [], [], []
    for ev in events:
        if isinstance(ev, dict):
            pos.append(tuple(ev["pos"]))
            pressed.append(bool(ev.get("pressed", True)))
            dts.append(float(ev.get("dt", dt)))
        else:
            x, y, p = ev
            pos.append((float(x), float(y)))
            pressed.append(bool(p))
            dts.append(dt)
    pos = np.asarray(pos, np.float32)
    last = np.concatenate([pos[:1], pos[:-1]], axis=0)
    return _stack(pos, last, np.asarray(pressed, bool), np.asarray(dts, np.float32))


def mouse_to_grid(
    mx: float,
    my: float,
    window: Tuple[int, int],
    grid: Tuple[int, int],
    variant: str = "gpu",
) -> Tuple[float, float]:
    """Window pixels -> grid coords, replicating each reference backend.

    cpu: pos = (mx * nx/w, (h-1-my) * ny/h)   (cpuFluidSim.cpp:301-303)
    gpu: pos = (mx / scale, (h - my) / scale) (Main.cpp:155), scale = w/nx
    """
    w, h = window
    nx, ny = grid
    if variant == "cpu":
        return mx * nx / w, (h - 1.0 - my) * ny / h
    return mx * nx / w, (h - my) * ny / h


def num_steps(imp: Impulse) -> int:
    return int(imp.pressed.shape[0])


def slice_step(imp: Impulse, i: int) -> Impulse:
    """Extract step ``i`` from an impulse stream."""
    return Impulse(imp.pos[i], imp.last_pos[i], imp.pressed[i], imp.dt[i])


def single(pos, last_pos, pressed, dt) -> Impulse:
    """One impulse (for stepping interactively)."""
    return _stack(pos, last_pos, pressed, dt)
