"""The quality cell's plain reference (``fluidbench/reference/multigrid.py``)
against the port, on the CPU; the port's multigrid span and counters; the
cell's three readers.

- The port's quality step (``make_step``, ``backend="ref"``, and the kernel
  wrappers' plain versions, ``pressure_project_mg`` over
  ``multigrid_cuda.ENDS``) equals the reference's ``step`` bit for bit
  (``torch.equal``) from seeded random fields, pressed and unpressed, at
  2 and 4 levels.
- Stopping: with a target between the residuals of two cycle counts, the
  port and the reference stop after the same k cycles (0 to 3, and a run
  capped by ``mg_max_cycles``); ``mg_cycles`` rises by k, ``mg_reads`` by
  k + 1 and ``mg_solves`` by 1, and under ``torch.profiler`` the
  ``fluid.mg.cycle`` spans count k, numbered 1 to k.
- ``Params.from_fluid`` refuses the configurations the reference does not
  write; importing the reference loads no JAX and no module of the port.
"""

import dataclasses
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from cudafluidsimulation_tpu_torch import FluidConfig
from cudafluidsimulation_tpu_torch.models.pipelines import make_step
from cudafluidsimulation_tpu_torch.ops import backend, multigrid, multigrid_cuda
from cudafluidsimulation_tpu_torch.ops import ref as port_ref
from cudafluidsimulation_tpu_torch.state import FluidState
from cudafluidsimulation_tpu_torch.utils import impulse as timp
from cudafluidsimulation_tpu_torch.utils import trace
from fluidbench import roofline, spec
from fluidbench.reference import multigrid as ref

ROOT = Path(__file__).resolve().parents[1]
FIELDS = ("u", "v", "dye", "pressure", "vel_stats")
H100 = "NVIDIA H100 80GB HBM3"


def _fluid(cfg):
    d = dataclasses.asdict(cfg)
    d.pop("backend")
    return d


def _fields(seed, h, w, scale=20.0):
    g = torch.Generator().manual_seed(seed)
    u = torch.randn(h, w, generator=g) * scale
    v = torch.randn(h, w, generator=g) * scale
    dye = torch.rand(3, h, w, generator=g) * 1.2
    return u, v, dye


def _states(cfg, seed):
    """The same random state as the port's and as the reference's."""
    u, v, dye = _fields(seed, cfg.ny, cfg.nx)
    stats = port_ref.vel_max(u, v)
    f32 = lambda x: torch.tensor(x, dtype=torch.float32)  # noqa: E731
    port = FluidState(u=u, v=v, dye=dye, pressure=torch.zeros_like(u), t=f32(1.25),
                      press_time=f32(0.5), time_since_press=f32(0.25),
                      mouse=torch.tensor([cfg.nx / 3, cfg.ny / 2], dtype=torch.float32),
                      step=torch.tensor(7, dtype=torch.int32), vel_stats=stats)
    mine = ref.State(u, v, dye, torch.zeros_like(u), stats, np.float32(1.25), np.float32(0.5),
                     np.float32(0.25), port.mouse.numpy().copy(), 7)
    return port, mine


def _counts():
    c = trace.counters()
    return np.asarray([c["mg_solves"], c["mg_cycles"], c["mg_reads"]])


def _spans(work):
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as prof:
        out = work()
    events = sorted((e for e in prof.events() if e.name.startswith("fluid.mg.")),
                    key=lambda e: e.time_range.start)
    cycles = [e.kwinputs.get("ident") for e in events if e.name == "fluid.mg.cycle"]
    reads = sum(e.name == "fluid.mg.stopping_read" for e in events)
    return out, cycles, reads


# -- the step -------------------------------------------------------------------


@pytest.mark.parametrize("ns", ["plain", "kernels"])
@pytest.mark.parametrize("pressed", [True, False], ids=["pressed", "unpressed"])
@pytest.mark.parametrize("nx, ny", [(40, 32), (64, 48), (128, 128)])
def test_the_quality_step_equals_the_reference(nx, ny, pressed, ns):
    cfg = FluidConfig.quality(nx=nx, ny=ny, backend="ref")
    p = ref.Params.from_fluid(_fluid(cfg))
    ops = backend.kernel_ops(cfg) if ns == "kernels" else None
    step = make_step(cfg, ops)
    port, mine = _states(cfg, seed=nx * ny + pressed)
    imp = timp.slice_step(timp.orbit_impulse(1, cfg.dt, (nx / 2 + 1.5, ny / 2 - 2), ny / 8,
                                             omega=3.0, pressed_every=1 if pressed else 2), 0)
    if not pressed:
        imp = imp._replace(pressed=torch.zeros_like(imp.pressed))
    before = _counts()
    got = step(port, imp)
    solves, cycles, reads = _counts() - before
    exp = ref.step(p, mine, ref.Impulse(tuple(imp.pos.tolist()), tuple(imp.last_pos.tolist()),
                                        bool(imp.pressed), float(imp.dt)))
    for f in FIELDS:
        assert torch.equal(getattr(got, f), getattr(exp, f)), f
    assert (float(got.t), float(got.press_time), float(got.time_since_press), int(got.step)) == (
        exp.t, exp.press_time, exp.time_since_press, exp.step)
    np.testing.assert_array_equal(got.mouse.numpy(), exp.mouse)
    # equal pressures came from equal cycle counts (the stopping tests below)
    assert (solves, reads) == (1, cycles + 1) and cycles >= 1


@pytest.mark.parametrize("shape", [(32, 40), (64, 48), (128, 128), (96, 256)])
def test_the_transfers_and_the_sum_equal_the_ports(shape):
    u, v, _ = _fields(sum(shape), *shape)
    r = ref.ops.divergence(u, v, True)
    assert torch.equal(ref.restrict(r), multigrid._restrict(r))
    assert torch.equal(ref.prolong(r), multigrid._prolong(r))
    assert torch.equal(ref.apply_a(r), multigrid.apply_a(r))
    assert torch.equal(ref.smooth(u, r, 3), multigrid.smooth_damped(u, r, 3))
    assert torch.equal(ref.mean_square(r), multigrid.mean_square(r))
    assert len(ref.level_shapes(*shape)) == multigrid._levels(*shape)


def test_the_sum_at_2048_equals_the_ports():
    r = torch.randn(2048, 2048, generator=torch.Generator().manual_seed(3))
    assert torch.equal(ref.mean_square(r), multigrid.mean_square(r))
    assert ref.level_shapes(2048, 2048)[-1] == (16, 16) and len(ref.level_shapes(2048, 2048)) == 8


# -- stopping ---------------------------------------------------------------------


def _history(rhs, n):
    """mean(res^2) after each of the first n + 1 fine pre-smooths."""
    levels = len(ref.level_shapes(*rhs.shape))
    p = ref.smooth(torch.zeros_like(rhs), rhs, ref.NU1)
    res = rhs - ref.apply_a(p)
    out = [float(ref.mean_square(res))]
    for _ in range(n):
        p = ref.smooth(ref.complete(p, res, rhs, levels), rhs, ref.NU1)
        res = rhs - ref.apply_a(p)
        out.append(float(ref.mean_square(res)))
    return out


def _case(rhs, case):
    """(tol, max_cycles, k): a target that stops the solve after k cycles,
    or one it never meets, capped at 3."""
    if case == "capped":
        return 1e-9, 3, 3
    ms = _history(rhs, case + 1)
    assert all(a > 1.2 * b for a, b in zip(ms, ms[1:]))  # far from rounding either way
    hi = 10 * ms[0] if case == 0 else ms[case - 1]
    return math.sqrt(math.sqrt(hi * ms[case])), 8, case


CASES = [0, 1, 2, 3, "capped"]


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("shape", [(32, 40), (128, 128)])
def test_the_port_and_the_reference_stop_after_the_same_cycles(shape, case):
    u, v, _ = _fields(7 + shape[0], *shape, scale=5.0)
    div = ref.ops.divergence(u, v, True)
    tol, cap, k = _case(-div, case)
    p_ref, cycles = ref.solve(-div, tol, cap)
    assert cycles == k

    before = _counts()
    p, spans, reads = _spans(lambda: multigrid.pressure_solve_mg(div, tol=tol, max_cycles=cap))
    assert tuple(_counts() - before) == (1, k, k + 1)
    assert spans == list(range(1, k + 1)) and reads == k + 1
    assert torch.equal(p, p_ref)

    before = _counts()
    out, spans, reads = _spans(lambda: multigrid.pressure_project_mg(
        u, v, tol=tol, max_cycles=cap, return_stats=True, ends=multigrid_cuda.ENDS))
    assert tuple(_counts() - before) == (1, k, k + 1)
    assert spans == list(range(1, k + 1)) and reads == k + 1
    eu, ev = ref.ops.project(u, v, p_ref)
    for g, e in zip(out, (eu, ev, p_ref, ref.ops.vel_max(eu, ev))):
        assert torch.equal(g, e)


@pytest.mark.parametrize("cycles", [1, 2, 3])
def test_a_fixed_count_solve_counts_its_cycles_and_no_read(cycles):
    u, v, _ = _fields(cycles, 64, 64, scale=5.0)
    div = port_ref.divergence(u, v, True)
    for solve in (lambda: multigrid.pressure_solve_mg(div, cycles),
                  lambda: multigrid.pressure_project_mg(u, v, cycles, ends=multigrid_cuda.ENDS)):
        before = _counts()
        _, spans, reads = _spans(solve)
        assert tuple(_counts() - before) == (1, cycles, 0)
        assert spans == list(range(1, cycles + 1)) and reads == 0


def test_a_batched_solve_counts_once():
    u, v, _ = _fields(11, 2 * 32, 40, scale=5.0)
    u, v = u.reshape(2, 32, 40), v.reshape(2, 32, 40)
    before = _counts()
    multigrid.pressure_project_mg_batched(u, v, tol=0.05)
    solves, cycles, reads = _counts() - before
    assert solves == 1 and cycles >= 1 and reads == cycles + 1


# -- Params, imports --------------------------------------------------------------


REFUSED = {
    "parity": dict(pressure_solver="jacobi", mg_tol=0.0),
    "mg_tol": dict(mg_tol=0.0),
    "variant": dict(variant="cpu"),
    "boundary_rows": dict(boundary_rows=11),
    "nx": dict(nx=16, ny=16),
}


@pytest.mark.parametrize("what", list(REFUSED))
def test_params_refuse_a_step_the_reference_does_not_write(what):
    fluid = dict(_fluid(FluidConfig.quality(nx=64, ny=64)), **REFUSED[what])
    with pytest.raises(ValueError, match=what if what != "parity" else "pressure_solver"):
        ref.Params.from_fluid(fluid)


def test_the_cells_configuration_is_the_quality_preset_at_2048():
    conf = spec.config("quality-2048")
    assert conf["reference"] == "multigrid" and conf["reduced"] == []
    assert conf["fluid"] == _fluid(FluidConfig.quality(nx=2048, ny=2048))
    assert ref.Params.from_fluid(conf["fluid"]).mg_tol == 0.05


def test_importing_the_reference_loads_no_jax_and_no_port():
    code = ("import sys, fluidbench.reference.multigrid; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'cudafluidsimulation_tpu', 'cudafluidsimulation_tpu_torch'}))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, timeout=120, env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


# -- the count of the step's work ---------------------------------------------------


def test_the_stages_are_the_parity_three_and_the_multigrid_two():
    fluid = spec.config("quality-2048")["fluid"]
    mine, parity = ref.stages(fluid), roofline.stages(fluid)
    assert list(mine) == ["advection", "vorticity", "diffusion_splat", "pressure_projection",
                          "mg_cycle"]
    for name in ("advection", "vorticity", "diffusion_splat"):
        assert mine[name] == parity[name]
    plane = 4 * 2048 * 2048
    assert mine["pressure_projection"][0] / plane == pytest.approx(11.25, abs=1e-5)
    assert mine["mg_cycle"][0] / plane == pytest.approx(10.333, abs=1e-3)
    for nbytes, ops in mine.values():
        assert nbytes / 3.35e12 > ops / 67e12  # each bound by its bytes
    bound = roofline.stage_bound_s(fluid, H100, ref.stages)
    assert bound["mg_cycle"] * 1e3 == pytest.approx(0.0517, rel=0.01)


# -- the readers ------------------------------------------------------------------


STAGE = "stage_roofline_share.pressure_projection.quality"
SPANS = {"fluid.step.pressure_projection": {"count": 400, "host_s": 0.4, "device_s": 0.1},
         "fluid.mg.cycle": {"count": 800, "host_s": 1.2, "device_s": 0.3},
         "fluid.mg.stopping_read": {"count": 1200, "host_s": 0.2, "device_s": 0.001},
         "fluid.step": {"count": 400, "host_s": 2.0, "device_s": 0.05}}
BOUND = {"advection": 5e-5, "pressure_projection": 5.6e-5, "mg_cycle": 5.2e-5}


def _rec(**kw):
    return dict({"kind": "rollout", "traced_steps": 400, "stage_bound_s": BOUND,
                 "trace": {"spans": SPANS}}, **kw)


def test_the_stage_roofline_bills_the_projection_and_every_cycle():
    read = spec.reader(STAGE)
    want = 100 * (5.6e-5 * 400 + 5.2e-5 * 800) / (0.1 + 0.3 + 0.001)
    assert read(_rec()) == pytest.approx(want)


@pytest.mark.parametrize("rec", [
    dict(trace=None), dict(kind="frames"), dict(stage_bound_s=None),
    dict(stage_bound_s={"pressure_projection": 2.5e-5}),  # a parity count
    dict(trace={"spans": {k: v for k, v in SPANS.items() if k != "fluid.mg.cycle"}}),
    dict(trace={"busy_s": 1.0})], ids=["untraced", "frames", "no_bound", "parity_bound",
                                       "no_cycle_span", "no_spans"])
def test_the_stage_roofline_is_none_without_what_it_reads(rec):
    assert spec.reader(STAGE)(_rec(**rec)) is None


def test_the_host_read_is_the_stopping_reads_host_time_a_step():
    read = spec.reader("host.mg_read_ms_per_step.quality")
    assert read(_rec()) == pytest.approx(0.5)
    assert read(_rec(trace=None)) is None and read(_rec(kind="frames")) is None
    assert read(_rec(trace={"spans": {}})) is None


def test_cycles_a_solve_are_the_ports_ratio(monkeypatch):
    read = spec.reader("mg.cycles_per_solve.quality")
    monkeypatch.setattr(multigrid, "MG_STATS", {"mg_solves": 4, "mg_cycles": 10, "mg_reads": 14})
    assert read({"kind": "rollout"}) == pytest.approx(2.5)
    monkeypatch.setattr(multigrid, "MG_STATS", {"mg_solves": 0, "mg_cycles": 0, "mg_reads": 0})
    assert read({"kind": "rollout"}) is None
    monkeypatch.setattr(trace, "counters", lambda: {"build_s": 1.0})  # a port before them
    assert read({"kind": "rollout"}) is None
