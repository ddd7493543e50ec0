"""The one traffic generator: seeded cursor orbits from a mix's parameters.

A mix (``traffic/<name>.json``) is a sequence of units, each an episode
of ``steps_per_unit`` steps (``kind`` "rollout") or a session of as many
frames (``kind`` "frames"), from a fresh state.  In every unit the cursor
orbits the grid's centre, shifted by a seeded offset of at most
``centre_offset`` cells on each axis, at radius ``radius_over_ny`` * ny
and ``omega`` rad/s from a seeded phase in [0, 2 pi), pressed every
``pressed_every`` steps.  Every seed gives the same sizes, steps and frames:
the seed moves the stirring, not the work.  Unit ``k`` of seed ``s`` is the
same in every run.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np


class Unit(NamedTuple):
    """One episode or session: its orbit, the step it checks in the middle
    (``probe``, 2 <= probe < steps: the state before it and after it are
    kept) and its length."""

    index: int
    centre: tuple
    radius: float
    omega: float
    phase: float
    pressed_every: int
    steps: int
    probe: int

    def at(self, t: float) -> tuple:
        """The cursor at time ``t`` (grid coordinates)."""
        a = self.omega * t + self.phase
        return (self.centre[0] + self.radius * math.cos(a),
                self.centre[1] + self.radius * math.sin(a))

    def pressed(self, i: int) -> bool:
        """Whether step ``i`` (0-based) presses."""
        return i % self.pressed_every == 0

    def stream(self, dt: float):
        """The episode's per-step (pos, last_pos, pressed, dt) as float32
        arrays of ``steps`` rows: the cursor at (i + 1) dt, dragged from
        where it was at i dt."""
        t = np.arange(self.steps + 1, dtype=np.float32) * np.float32(dt)
        a = np.float32(self.omega) * t + np.float32(self.phase)
        xs = np.float32(self.centre[0]) + np.float32(self.radius) * np.cos(a)
        ys = np.float32(self.centre[1]) + np.float32(self.radius) * np.sin(a)
        pos = np.stack([xs[1:], ys[1:]], axis=1).astype(np.float32)
        last = np.stack([xs[:-1], ys[:-1]], axis=1).astype(np.float32)
        pressed = np.asarray([self.pressed(i) for i in range(self.steps)], bool)
        return pos, last, pressed, np.full((self.steps,), dt, np.float32)


def seed_words(seed: int) -> int:
    """Any whole number as a non-negative 64-bit seed word."""
    return int(seed) % (1 << 64)


def unit(mix: dict, fluid: dict, seed: int, index: int) -> Unit:
    """Unit ``index`` of ``mix`` on a grid of ``fluid``'s size under ``seed``."""
    rng = np.random.default_rng([seed_words(seed), int(index)])
    off = int(mix["centre_offset"])
    dx, dy = (int(d) for d in rng.integers(-off, off + 1, size=2))
    phase = float(rng.uniform(0.0, 2.0 * math.pi))
    steps = int(mix["steps_per_unit"])
    probe = int(rng.integers(2, steps))
    return Unit(index, (fluid["nx"] / 2.0 + dx, fluid["ny"] / 2.0 + dy),
                float(mix["radius_over_ny"]) * fluid["ny"], float(mix["omega"]), phase,
                int(mix["pressed_every"]), steps, probe)
