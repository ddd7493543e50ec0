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
from cudafluidsimulation_tpu_torch.utils.timing import StageReport, cuda_times_ms, time_stage


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
    def frame_layout(device_frame: torch.Tensor, flip: bool = True) -> torch.Tensor:
        """(4, H, W) frame -> contiguous uint8 (H, W, 4) image on the frame's
        device (y-up at the top when ``flip``) — the one place the
        layout/flip convention lives.  On the card the permute and the flip
        are two copies on the device, so the host reads the image whole."""
        img = device_frame.flip(1) if flip else device_frame
        return img.permute(1, 2, 0).contiguous()

    @staticmethod
    def frame_image(device_frame: torch.Tensor, flip: bool = True) -> np.ndarray:
        """(4, H, W) frame -> uint8 (H, W, 4) host image (:meth:`frame_layout`,
        read back)."""
        return Simulation.frame_layout(device_frame, flip).cpu().numpy()

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

    def stage_timings(self, iters: int = 24,
                      state: Optional[FluidState] = None) -> StageReport:
        """Per-stage breakdown out of band, the analogue of the reference's
        per-stage averages (Main.cpp:195-206) and of the JAX package's
        ``Simulation.stage_timings``, with the same buckets.  Each bucket is
        the op that the configured pipeline runs, fusions included: one
        "Pressure+Project" bucket where the pipeline runs the fused
        divergence -> Jacobi -> projection op (H4 on the card), "Pressure"
        (divergence, then the V-cycles) and "Project" under multigrid;
        "Diffuse+Force" where the splat rides the last diffusion sweep (H3,
        or H7 where the fast preset grants it), else "Diffuse" and "Force";
        "Paint+Bloom" where the render blooms, else "Paint".  The CLI's
        ``--report-mode decomposed`` (``utils.instrument``) splits the
        fused ops back into the reference's buckets.

        Each stage runs ``iters`` times with its output threaded back in
        (``utils.timing.time_stage``: CUDA events on the card, the host
        clock on the CPU), from ``state`` (the initial state when None).
        The advection threads its velocity bound as the step does.  A
        stage that injects energy self-amplifies (confinement run alone
        grows |v| each time), so flow-dependent rows can read above their
        in-step cost; the step total is the ground truth."""
        cfg = self.config
        ops = self.ops
        if state is None:
            state = self.init()
        dt = np.float32(cfg.dt)
        u, v, dye, p = state.u, state.v, state.dye, state.pressure
        color = cfg.palette_array()[0]
        pos = np.asarray([cfg.nx / 2.0, cfg.ny / 2.0], np.float32)
        five = cfg.color_diffusion_enabled
        fused_splat = five and cfg.variant == "gpu"
        coeffs = np.asarray([cfg.velocity_diffusion] * 2 + [cfg.color_diffusion] * 3,
                            np.float32)

        advect_both = getattr(ops, "advect_both", None)

        def advect_body(c):
            u, v, dye, st = c
            if advect_both is not None:  # the step's one launch
                return advect_both(u, v, dye, dt, cfg.decay_rate, vel_stats=st,
                                   return_stats=True)
            u2, v2, st2 = ops.advect_velocity(u, v, dt, cfg.decay_rate, vel_stats=st,
                                              return_stats=True)
            return u2, v2, ops.advect_dye(dye, u2, v2, dt, cfg.decay_rate,
                                          vel_stats=st2), st2

        vort = (ops.vorticity_confinement_cpu if cfg.variant == "cpu"
                else ops.vorticity_confinement_gpu)

        def vorticity_body(c):
            return vort(c[0], c[1], dt, cfg.vorticity)

        if fused_splat:
            # the pipeline's op: the splat folded into the last sweep
            amps = np.concatenate([np.ones((2,), np.float32), color])

            def diffuse_body(c):
                return (ops.diffuse_multi_splat(c[0], dt, coeffs, cfg.diffusion_iters,
                                                amps, pos, cfg.splat_radius),)
        elif five:
            def diffuse_body(c):
                return (ops.diffuse_multi(c[0], dt, coeffs, cfg.diffusion_iters),)
        else:
            def diffuse_body(c):
                return (ops.diffuse(c[0], dt, cfg.velocity_diffusion, cfg.diffusion_iters),)
        pack = (torch.cat([torch.stack([u, v]), dye]) if five
                else torch.stack([u, v]))

        splat = ops.splat_cpu if cfg.variant == "cpu" else ops.splat_gpu

        def force_body(c):
            return splat(*c, pos, pos, dt, cfg.force_scale, cfg.splat_radius, color)

        def pressure_body(c):
            u, v, _ = c
            div = ops.divergence(u, v, cfg.half_divergence)
            return u, v, ops.pressure_solve_mg(div, cfg.mg_cycles, tol=cfg.mg_tol,
                                               max_cycles=cfg.mg_max_cycles)

        def pressure_project_body(c):
            # the pipeline's op on the Jacobi path: fused divergence ->
            # sweeps -> gradient subtraction
            return ops.pressure_project(c[0], c[1], cfg.pressure_iters, cfg.half_divergence)

        def project_body(c):
            u, v, p = c
            return (*ops.project(u, v, p), p)

        def paint_body(c):
            return c[0], ops.pack_rgba(c[0])

        def render_body(c):
            # the pipeline's render op with the bloom active: the driven
            # (interactive) worst case
            return c[0], ops.render_frame(c[0], pos, cfg.bloom_intense, cfg.splat_radius, True)

        stages = {
            "Advect": (advect_body, (u, v, dye, state.vel_stats)),
            "Vorticity": (vorticity_body, (u, v)),
        }
        if fused_splat:
            stages["Diffuse+Force"] = (diffuse_body, (pack,))
        else:
            stages["Diffuse"] = (diffuse_body, (pack,))
            stages["Force"] = (force_body, (u, v, dye))
        if cfg.pressure_solver == "multigrid":
            stages["Pressure"] = (pressure_body, (u, v, p))
            stages["Project"] = (project_body, (u, v, p))
        else:
            stages["Pressure+Project"] = (pressure_project_body, (u, v, p))
        if cfg.bloom_enabled:
            stages["Paint+Bloom"] = (render_body, (dye, None))
        else:
            stages["Paint"] = (paint_body, (dye, None))

        report = StageReport(grid=f"{cfg.nx}x{cfg.ny}", steps=1, total_s=0.0)
        for name, (body, carry) in stages.items():
            sec = time_stage(body, carry, n=iters)
            report.stage_ms[name] = sec * 1000.0
            report.total_s += sec
        return report
