"""Run-accumulated per-stage timing — the reference's in-run timers.

The reference accumulates running averages around every stage of the
actual run (cpuFluidSim.cpp:329-385, GPUFluidSim.cu:609-712) and prints
them at exit.  This module is the decomposed in-run variant for
diagnostics (CLI ``--report-mode decomposed``), as in the JAX package: it
wraps the op namespace so that every op call bills its time to the
reference's stage buckets, and splits the fused ops (``pressure_project``,
``pressure_project_mg``, ``diffuse_multi_splat``, ``render_frame``,
``advect_both``) back into their unfused sub-ops so that the buckets stay
the reference's.  That decomposition is the point and the caveat: the
unfused ops pay device-memory round trips the fused step does not, so the
totals exceed the fused step's time (``Simulation.stage_timings``, CLI
``--report-mode sampled``, times the ops the pipeline runs).

On the card the decomposed Jacobi projection runs H5 ``divergence``, H4's
standalone ``pressure_solve`` and H5 ``project``; the splat rides no
sweep, so H3 runs without it and the plain ``splat_tail`` follows.  Each
op on the card is billed by a pair of CUDA events on the current stream,
all of them read after the rollout (no synchronize per op); on the CPU the
ops are synchronous and the host clock bills them.
"""

from __future__ import annotations

import time
import types
from typing import Dict, Tuple

import torch

from cudafluidsimulation_tpu_torch.config import FluidConfig
from cudafluidsimulation_tpu_torch.models.pipelines import make_step
from cudafluidsimulation_tpu_torch.ops import ref as _ref
from cudafluidsimulation_tpu_torch.ops.backend import get_ops
from cudafluidsimulation_tpu_torch.state import FluidState
from cudafluidsimulation_tpu_torch.utils.impulse import Impulse, num_steps, slice_step
from cudafluidsimulation_tpu_torch.utils.timing import StageReport

# op name -> reference stage bucket (Main.cpp:183 stage names)
_STAGE_OF = {
    "advect_velocity": "Advect",
    "advect_dye": "Advect",
    "curl": "Vorticity",
    "vorticity_confinement_cpu": "Vorticity",
    "vorticity_confinement_gpu": "Vorticity",
    "diffuse": "Diffuse",
    "diffuse_multi": "Diffuse",
    "splat_cpu": "Force",
    "splat_gpu": "Force",
    "cycle_color": "Force",
    "divergence": "Pressure",
    "pressure_solve": "Pressure",
    "pressure_solve_mg": "Pressure",
    "project": "Project",
    "boundary_strip": "Project",
    "pack_rgba": "Paint",
    "apply_bloom": "Bloom",
}
STAGE_ORDER = ("Advect", "Vorticity", "Diffuse", "Force", "Pressure", "Project",
               "Paint", "Bloom")


class StageSpans:
    """Spans of work billed to stage buckets, on ``device``: CUDA events
    on the current stream, read by :meth:`seconds`, for the card; the host
    clock for the CPU."""

    def __init__(self, device):
        self.on_card = torch.device(device).type == "cuda"
        self._events = []  # (stage, start, end) not yet read
        self._seconds: Dict[str, float] = {}

    def begin(self):
        if self.on_card:
            start = torch.cuda.Event(enable_timing=True)
            start.record()
            return start
        return time.perf_counter()

    def end(self, stage: str, begun) -> None:
        if self.on_card:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            self._events.append((stage, begun, end))
        else:
            self._add(stage, time.perf_counter() - begun)

    def _add(self, stage: str, sec: float) -> None:
        self._seconds[stage] = self._seconds.get(stage, 0.0) + sec

    def seconds(self) -> Dict[str, float]:
        """Seconds billed to each stage so far (waits for the card's
        outstanding spans)."""
        if self._events:
            self._events[-1][2].synchronize()
            for stage, start, end in self._events:
                self._add(stage, start.elapsed_time(end) / 1000.0)
            self._events.clear()
        return dict(self._seconds)


def timed_ops(base, spans: StageSpans) -> types.SimpleNamespace:
    """``base``'s ops, each billing its calls to its stage in ``spans``,
    with the fused ops decomposed through the billed sub-ops."""
    ns = types.SimpleNamespace()
    for name in vars(base):
        fn = getattr(base, name)
        stage = _STAGE_OF.get(name)
        if stage is None:
            setattr(ns, name, fn)
            continue

        def wrapped(*args, _fn=fn, _stage=stage, **kw):
            begun = spans.begin()
            out = _fn(*args, **kw)
            spans.end(_stage, begun)
            return out

        setattr(ns, name, wrapped)

    def pressure_project(u, v, iters, half, *, return_stats=False):
        d = ns.divergence(u, v, half)
        p = ns.pressure_solve(d, iters)
        if return_stats:
            u2, v2, st = ns.project(u, v, p, return_stats=True)
            return u2, v2, p, st
        u2, v2 = ns.project(u, v, p)
        return u2, v2, p

    def pressure_project_mg(u, v, cycles, tol=0.0, max_cycles=8, half=True,
                            return_stats=False):
        d = ns.divergence(u, v, half)
        p = ns.pressure_solve_mg(d, cycles, tol=tol, max_cycles=max_cycles)
        if return_stats:
            u2, v2, st = ns.project(u, v, p, return_stats=True)
            return u2, v2, p, st
        u2, v2 = ns.project(u, v, p)
        return u2, v2, p

    def diffuse_multi_splat(fields, dt, coeffs, iters, amps, last, radius):
        f = ns.diffuse_multi(fields, dt, coeffs, iters)  # bills Diffuse
        begun = spans.begin()
        out = _ref.splat_tail(f, amps, last, radius)
        spans.end("Force", begun)
        return out

    def advect_both(u, v, dye, dt, decay_rate, vel_stats=None, return_stats=False,
                    out=None):
        # a namespace that carries the fused advection (H1's one launch, the
        # sharded namespaces' one exchange) still bills Advect through the
        # sub-ops
        if return_stats:
            u2, v2, st = ns.advect_velocity(u, v, dt, decay_rate, vel_stats=vel_stats,
                                            return_stats=True)
            dye2 = ns.advect_dye(dye, u2, v2, dt, decay_rate, vel_stats=st, out=out)
            return u2, v2, dye2, st
        u2, v2 = ns.advect_velocity(u, v, dt, decay_rate, vel_stats=vel_stats)
        return u2, v2, ns.advect_dye(dye, u2, v2, dt, decay_rate, out=out)

    def render_frame(dye, pos, intense, radius, active):
        rgba = ns.pack_rgba(dye)  # bills Paint
        bloomed = ns.apply_bloom(rgba, pos, intense, radius)  # bills Bloom
        return bloomed if bool(active) else rgba

    ns.pressure_project = pressure_project
    ns.diffuse_multi_splat = diffuse_multi_splat
    ns.render_frame = render_frame
    if hasattr(base, "advect_both"):
        ns.advect_both = advect_both
    if hasattr(base, "pressure_project_mg"):
        ns.pressure_project_mg = pressure_project_mg
    return ns


def run_instrumented(config: FluidConfig, state: FluidState,
                     impulses: Impulse) -> Tuple[FluidState, StageReport]:
    """Run the rollout on the decomposed, billed ops from ``state`` (on its
    device); returns the final state and a reference-style per-stage
    report of the run."""
    device = state.u.device
    spans = StageSpans(device)
    step = make_step(config, timed_ops(get_ops(config), spans))

    n = num_steps(impulses)
    if spans.on_card:
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    for i in range(n):
        state = step(state, slice_step(impulses, i))
    if spans.on_card:
        torch.cuda.synchronize(device)
    total = time.perf_counter() - t0

    totals = spans.seconds()
    report = StageReport(grid=f"{config.nx}x{config.ny}", steps=n, total_s=total)
    for stage in STAGE_ORDER:
        if stage in totals:
            report.stage_ms[stage] = 1000.0 * totals[stage] / max(1, n)
    return state, report
