"""The simulation harness: step, rollout, render, timing.

The JAX package compiles a rollout into one ``lax.scan``; here a rollout is
a Python loop over the impulse stream that enqueues each step's kernels on
the current stream and never waits on the device.
"""

from __future__ import annotations

import statistics
from typing import Optional

import numpy as np
import torch

from cudafluidsimulation_tpu_torch.config import FluidConfig
from cudafluidsimulation_tpu_torch.models.ensemble import make_ensemble_run
from cudafluidsimulation_tpu_torch.models.pipelines import make_render, make_step
from cudafluidsimulation_tpu_torch.ops.backend import get_ops
from cudafluidsimulation_tpu_torch.state import FluidState, default_device, init_state
from cudafluidsimulation_tpu_torch.utils.impulse import (
    Impulse, no_impulse, num_steps, slice_step)
from cudafluidsimulation_tpu_torch.utils.timing import StageReport, cuda_times_ms


def run_scan(step_fn, state: FluidState, impulses: Impulse) -> FluidState:
    """Run ``step_fn`` over every step of an impulse stream."""
    for i in range(num_steps(impulses)):
        state = step_fn(state, slice_step(impulses, i))
    return state


def run_scan_render(step_fn, render_fn, state: FluidState, impulses: Impulse):
    """Rollout that renders an RGBA frame after every step: (final state,
    (T, 4, H, W) uint8 frames on the state's device).  The frames take
    T*H*W*4 bytes; ``Simulation.collect_frames`` keeps one at a time."""
    frames = []
    for i in range(num_steps(impulses)):
        state = step_fn(state, slice_step(impulses, i))
        frames.append(render_fn(state))
    return state, torch.stack(frames)


class Simulation:
    """Config -> step/run/render + timing.

    ``device`` defaults to the CUDA device for the ``cuda`` backend and to
    the CPU for ``ref``; the ``ref`` backend also runs on a CUDA device when
    asked.  Building a simulation raises for ``backend='cuda'`` without a
    CUDA device.  ``ops`` replaces the backend's op namespace (for example
    the plain versions of the kernels, to hold a step against them).
    """

    def __init__(self, config: FluidConfig, device=None, ops=None):
        self.config = config
        self.ops = get_ops(config) if ops is None else ops
        backend = config.resolve_backend()
        self.device = torch.device(default_device(config) if device is None else device)
        if backend == "cuda" and self.device.type != "cuda":
            raise ValueError(f"backend='cuda' runs on a CUDA device, not {self.device}")
        self.step_fn = make_step(config, self.ops)
        self.render_fn = make_render(config, self.ops)

    # -- lifecycle ----------------------------------------------------------

    def init(self) -> FluidState:
        return init_state(self.config, self.device)

    def step(self, state: FluidState, imp: Impulse) -> FluidState:
        return self.step_fn(state, imp)

    def run(self, state: FluidState, impulses: Impulse) -> FluidState:
        return run_scan(self.step_fn, state, impulses)

    def run_steps(self, state: FluidState, steps: int) -> FluidState:
        """``steps`` steps of free evolution."""
        return self.run(state, no_impulse(steps, self.config.dt))

    def run_displacement(self, state: FluidState, impulses: Impulse):
        """Rollout + realized advection displacement: returns
        ``(final_state, (max|u|*dt, max|v|*dt))`` with the maxima over every
        step, read from each step's ``vel_stats`` (the kernel-emitted bound
        of the velocity that step's backtrace samples).  The running max
        stays on the device; the one read is at the end."""
        run_max = torch.zeros((2,), dtype=torch.float32, device=self.device)
        for i in range(num_steps(impulses)):
            imp = slice_step(impulses, i)
            run_max = torch.maximum(run_max, state.vel_stats * float(imp.dt))
            state = self.step_fn(state, imp)
        mu, mv = run_max.tolist()
        return state, (mu, mv)

    # -- rendering ----------------------------------------------------------

    @staticmethod
    def frame_image(device_frame: torch.Tensor, flip: bool = True) -> np.ndarray:
        """(4, H, W) frame -> uint8 (H, W, 4) host image (y-up at the top
        when ``flip``) — the one place the layout/flip convention lives."""
        img = np.moveaxis(device_frame.cpu().numpy(), 0, -1)
        return img[::-1] if flip else img

    def render(self, state: FluidState, flip: bool = True) -> np.ndarray:
        """uint8 (H, W, 4) frame; ``flip`` puts y-up at the image top."""
        return self.frame_image(self.render_fn(state), flip)

    def collect_frames(self, state: FluidState, impulses: Impulse, every: int = 1):
        """Roll out and return (final state, (N, H, W, 4) uint8 frames,
        y-up): one frame after each ``every`` steps and after the last, so
        device memory holds one frame at a time."""
        n = num_steps(impulses)
        frames = []
        for start in range(0, n, every):
            part = Impulse(*(f[start:min(start + every, n)] for f in impulses))
            state = self.run(state, part)
            frames.append(self.render(state))
        return state, np.stack(frames)

    # -- ensembles ----------------------------------------------------------

    def vmapped_run(self):
        """The rollout over a leading member axis of (state, impulses):
        independent simulations batched on one device
        (``models.ensemble.make_ensemble_run``)."""
        return make_ensemble_run(self.config)

    # -- timing -------------------------------------------------------------

    def benchmark(self, steps: int = 100, impulses: Optional[Impulse] = None,
                  iters: int = 5) -> StageReport:
        """Median time of a ``steps``-step rollout from the initial state,
        by CUDA events (needs the simulation on a CUDA device)."""
        if self.device.type != "cuda":
            raise RuntimeError("benchmark times the card; build the simulation "
                               "on a CUDA device")
        if impulses is None:
            impulses = no_impulse(steps, self.config.dt)
        steps = num_steps(impulses)
        state = self.init()
        ms = statistics.median(cuda_times_ms(lambda: self.run(state, impulses), iters=iters))
        return StageReport(grid=f"{self.config.nx}x{self.config.ny}",
                           steps=steps, total_s=ms / 1000.0)
