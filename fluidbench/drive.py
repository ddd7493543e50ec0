"""The two ways a mix drives the program, by its ``kind``.

- "rollout": headless episodes through ``Simulation.run``, each from a
  fresh ``Simulation.init()``, one after another; only the window's end
  synchronizes.
- "frames": live sessions through ``FluidApp.run(max_frames=...)``, one
  viewer in a closed loop with the config's dt as ``fixed_dt``, the
  harness's own input source (the unit's orbit) and a sink that only takes
  the host image and notes its arrival.  A session's set-up (a new
  ``FluidApp``) lies inside the window and outside every frame's time.

Each unit keeps what ``check.py`` judges: the program's states before and
after its first step, its probe step and its last step (held by
reference: the program writes every step into fresh tensors, so a state
once returned is never written again), the inputs of every step and, for
frames, the host images of those three frames.  Only the last unit's are
kept.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List

import numpy as np
import torch

from fluidbench import generator


@dataclasses.dataclass
class Capture:
    """What one unit leaves for the check: ``states[n]`` the program's
    state after n steps (n in 0, 1, probe - 1, probe, steps - 1, steps),
    ``inputs[i]`` step i's (pos, last_pos, pressed, dt), ``images[n]`` the
    host image after frame n, and each frame's time in seconds, from the
    previous frame's arrival at the sink (the first: from the session's
    first loop iteration) to its own (frames only)."""

    unit: generator.Unit
    states: Dict[int, object]
    inputs: List[tuple]
    images: Dict[int, np.ndarray] = dataclasses.field(default_factory=dict)
    frame_s: List[float] = dataclasses.field(default_factory=list)

    def checked(self) -> List[int]:
        """The steps judged one by one: the first, the probe, the last."""
        return sorted({1, self.unit.probe, self.unit.steps})


class Driver:
    """A mix's units on one configuration; ``unit(k)`` runs unit k.

    ``step_factory`` names, as (module, attribute), the factory the
    driver's step is built by, so that the harness's tests can plant a
    broken step there: ``Rollout`` builds its step when it is made,
    ``Frames`` in each unit, both through the port's ``Simulation``.  The
    module is one ``importlib.import_module`` finds by its dotted name,
    never a driver's own file (``spec`` loads that anew each time).  A
    driver that builds its step elsewhere (an ensemble's batched step)
    names its own.  No run reads it."""

    step_factory = ("cudafluidsimulation_tpu_torch.models.simulation", "make_step")

    def __init__(self, config, fluid: dict, mix: dict, seed: int):
        self.config = config
        self.fluid = fluid
        self.mix = mix
        self.seed = seed
        self.next_index = 0

    def _unit(self, k: int) -> generator.Unit:
        return generator.unit(self.mix, self.fluid, self.seed, k)

    def units(self, n: int) -> Capture:
        """Run the next ``n`` units; the last one's capture."""
        for _ in range(n):
            cap = self.unit(self.next_index)
            self.next_index += 1
        return cap

    def window(self, seconds: float, sync) -> dict:
        """Units one after another until ``seconds`` have passed, then
        ``sync()``: the records of the window, with the last capture."""
        t0 = time.perf_counter()
        n = 0
        frame_s: List[float] = []
        cap = None
        while n == 0 or time.perf_counter() - t0 < seconds:
            cap = self.unit(self.next_index)
            self.next_index += 1
            n += 1
            frame_s += cap.frame_s
        sync()
        window_s = time.perf_counter() - t0
        steps = n * int(self.mix["steps_per_unit"])
        return {"window_s": window_s, "units": n, "steps": steps,
                "cells": self.fluid["nx"] * self.fluid["ny"], "frame_s": frame_s,
                "capture": cap}


class Rollout(Driver):
    kind = "rollout"

    def __init__(self, config, fluid, mix, seed):
        super().__init__(config, fluid, mix, seed)
        from cudafluidsimulation_tpu_torch.models.simulation import Simulation
        from cudafluidsimulation_tpu_torch.utils.impulse import Impulse

        self.sim = Simulation(config)
        self._impulse = Impulse

    def unit(self, k: int) -> Capture:
        u = self._unit(k)
        pos, last, pressed, dt = u.stream(self.fluid["dt"])
        imp = self._impulse(torch.from_numpy(pos), torch.from_numpy(last),
                            torch.from_numpy(pressed), torch.from_numpy(dt))
        state = self.sim.init()
        states = {0: state}
        # the episode's one stream in five calls, so the states the check
        # reads are those the rollout passes through
        cuts = [0, 1, u.probe - 1, u.probe, u.steps - 1, u.steps]
        for a, b in zip(cuts, cuts[1:]):
            state = self.sim.run(state, self._impulse(*(f[a:b] for f in imp)))
            states[b] = state
        inputs = list(zip(map(tuple, pos.tolist()), map(tuple, last.tolist()),
                          pressed.tolist(), dt.tolist()))
        return Capture(u, states, inputs)


class Frames(Driver):
    kind = "frames"

    def __init__(self, config, fluid, mix, seed):
        super().__init__(config, fluid, mix, seed)
        from cudafluidsimulation_tpu_torch.models.app import FluidApp

        self._app = FluidApp

    def unit(self, k: int) -> Capture:
        u = self._unit(k)
        dt = float(self.fluid["dt"])
        keep = {1, u.probe - 1, u.probe, u.steps - 1, u.steps}
        shown = {1, u.probe, u.steps}
        inputs: List[tuple] = []
        arrivals: List[float] = []
        images: Dict[int, np.ndarray] = {}
        states: Dict[int, object] = {}
        start: List[float] = []
        prev: List[tuple] = [u.at(0.0)]

        def source(t: float):
            if not start:
                start.append(time.perf_counter())  # the session's first loop iteration
            pos = u.at(t)
            step = (pos, prev[0], u.pressed(len(inputs)))
            prev[0] = pos
            inputs.append(step + (dt,))
            return step

        def sink(image: np.ndarray) -> None:
            arrivals.append(time.perf_counter())
            if len(arrivals) in shown:
                images[len(arrivals)] = image

        def on_frame(state, n: int) -> None:
            if n in keep:
                states[n] = state

        app = self._app(self.config, input_source=source, frame_sink=sink, fixed_dt=dt)
        states[0] = app.state
        app.run(max_frames=u.steps, pipelined=bool(self.mix["pipelined"]), on_frame=on_frame)
        return Capture(u, states, inputs, images,
                       np.diff(np.asarray(start[:1] + arrivals)).tolist())


DRIVERS = {d.kind: d for d in (Rollout, Frames)}
