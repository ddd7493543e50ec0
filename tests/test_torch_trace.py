"""The port's spans and counters (``utils/trace.py``), on the CPU.

- With no profiler running, ``span()`` is one shared no-op and makes no
  profiler range.
- Under a CPU ``torch.profiler``, a step of each preset (parity, quality,
  fast, cpu variant), single and batched, on the kernels' wrappers (their
  plain versions here) and on the plain ops, gives its stage spans once
  each, in pipeline order, inside ``fluid.step``; quality adds one
  ``fluid.mg.stopping_read`` a stopping test.  ``FluidApp.run``,
  ``Simulation.run`` and ``Simulation.init`` give theirs.
- A span is an operator's range, not a user annotation, in the events and
  in the exported trace; without the private operator range a span is the
  no-op.
- The build counters count a compile as a build and a load, a cached
  library as a load alone (a stand-in compiler, no nvcc).
"""

import ctypes
import json
import stat

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from cudafluidsimulation_tpu_torch import FluidConfig, Simulation
from cudafluidsimulation_tpu_torch.models import app, ensemble
from cudafluidsimulation_tpu_torch.models.pipelines import make_batched_step
from cudafluidsimulation_tpu_torch.ops import _build, backend, multigrid
from cudafluidsimulation_tpu_torch.utils import impulse as timp
from cudafluidsimulation_tpu_torch.utils import trace

DT = 1 / 60
N = 32
GPU_STAGES = ["fluid.step.advection", "fluid.step.vorticity", "fluid.step.diffusion_splat",
              "fluid.step.pressure_projection"]
CPU_STAGES = ["fluid.step.advection", "fluid.step.vorticity", "fluid.step.diffusion",
              "fluid.step.splat", "fluid.step.pressure_projection", "fluid.step.boundary_strip"]
PRESETS = {
    "parity": lambda: FluidConfig.gpu_reference(nx=N, ny=N, backend="ref"),
    "quality": lambda: FluidConfig.quality(nx=N, ny=N, backend="ref"),
    "fast": lambda: FluidConfig.gpu_reference(nx=N, ny=N, fast_dye=True, fast_velocity=True,
                                              fast_diffuse=True, backend="ref"),
    "cpu": lambda: FluidConfig.cpu_reference(nx=N, ny=N, backend="ref"),
}


def _traced(work, shapes=False):
    with profile(activities=[ProfilerActivity.CPU], record_shapes=shapes) as prof:
        out = work()
    spans = sorted((e for e in prof.events() if e.name.startswith("fluid.")),
                   key=lambda e: e.time_range.start)
    return spans, out


def _inside(e, outer):
    return outer.time_range.start <= e.time_range.start and e.time_range.end <= outer.time_range.end


def _ident(e):
    return e.kwinputs.get("ident")


# -- the gate ----------------------------------------------------------------


@pytest.mark.parametrize("ident", [None, 3, torch.tensor(4, dtype=torch.int32),
                                   torch.tensor([5, 5])], ids=["none", "int", "0d", "batch"])
def test_no_profiler_gives_the_shared_noop(ident, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a profiler range was made with no profiler running")

    monkeypatch.setattr(trace, "_RecordFunctionFast", refuse)
    assert not torch.autograd._profiler_enabled()
    got = trace.span("fluid.step", ident)
    assert got is trace.OFF and trace.span("fluid.frame") is got
    with got:
        pass


def test_a_step_makes_no_range_without_a_profiler(monkeypatch):
    made = []
    monkeypatch.setattr(trace, "_RecordFunctionFast", lambda *a: made.append(a))
    sim = Simulation(PRESETS["parity"]())
    sim.run(sim.init(), timp.orbit_impulse(2, DT, (16.0, 16.0), 4, omega=3.0))
    assert made == []


@pytest.mark.parametrize("ident,want", [(None, None), (7, 7),
                                        (torch.tensor(8, dtype=torch.int32), 8),
                                        (torch.tensor([9, 9]), 9)],
                         ids=["none", "int", "0d", "batch"])
def test_a_span_under_a_profiler_is_a_named_range_with_its_ident(ident, want):
    def work():
        with trace.span("fluid.frame", ident):
            torch.ones(3).add_(1)

    spans, _ = _traced(work, shapes=True)
    assert [e.name for e in spans] == ["fluid.frame"]
    assert _ident(spans[0]) == want
    assert spans[0].device_type == torch.autograd.DeviceType.CPU
    assert not spans[0].is_user_annotation  # no range of its own on the device's timeline


@pytest.mark.parametrize("ident", [None, 7], ids=["none", "int"])
def test_an_exported_span_is_no_user_annotation(ident, tmp_path):
    # kineto projects a user annotation onto the device's timeline; the
    # exported trace names the category that decides it
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.span("fluid.step", ident):
            torch.ones(3).add_(1)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("name") == "fluid.step"]
    assert len(events) == 1
    assert events[0]["cat"] != "user_annotation"


def test_without_the_operator_range_a_span_is_the_noop(monkeypatch):
    monkeypatch.setattr(trace, "_RecordFunctionFast", None)
    spans, _ = _traced(lambda: [trace.span("fluid.frame", 3).__enter__(),
                                trace.span("fluid.step").__enter__()])
    assert spans == []
    assert trace.span("fluid.frame", 3) is trace.OFF


# -- the step's stages -----------------------------------------------------------


def _stages(cfg):
    if cfg.variant == "cpu":
        return [s for s in CPU_STAGES
                if s != "fluid.step.diffusion" or cfg.diffusion_iters > 0
                if s != "fluid.step.boundary_strip" or cfg.boundary_rows > 0]
    return GPU_STAGES


def _count_tests(monkeypatch):
    """Wrap ``probed_tol_loop`` so that each call's stopping tests (its
    completed cycles + 1) are counted."""
    tests = []
    real = multigrid.probed_tol_loop

    def counted(probe, finish, *args):
        tests.append(1)

        def fin(*a):
            tests.append(1)
            return finish(*a)

        return real(probe, fin, *args)

    monkeypatch.setattr(multigrid, "probed_tol_loop", counted)
    return tests


@pytest.mark.parametrize("ns", ["kernels", "plain"])
@pytest.mark.parametrize("batched", [False, True], ids=["single", "batched"])
@pytest.mark.parametrize("preset", list(PRESETS))
def test_a_step_gives_its_stage_spans_in_order(preset, batched, ns, monkeypatch):
    cfg = PRESETS[preset]()
    imp = timp.orbit_impulse(1, DT, (16.0, 16.0), 4, omega=3.0)
    if batched:
        ops = (backend.kernel_ops(cfg, batched=True) if ns == "kernels"
               else backend.get_batched_ops(cfg))
        step = make_batched_step(cfg, ops)
        state = ensemble.batched_state(cfg, 2, device="cpu")
        imp = ensemble.step_of(ensemble.batched_impulse(imp, 2), 0)
    else:
        sim = Simulation(cfg, ops=backend.kernel_ops(cfg) if ns == "kernels" else None)
        step, state = sim.step_fn, sim.init()
        imp = timp.slice_step(imp, 0)
    tests = _count_tests(monkeypatch)
    spans, out = _traced(lambda: step(state, imp), shapes=True)
    assert int(out.step.reshape(-1)[0]) == 1
    outer = [e for e in spans if e.name == "fluid.step"]
    assert len(outer) == 1 and _ident(outer[0]) == 0
    stages = [e for e in spans if e.name.startswith("fluid.step.")]
    assert [e.name for e in stages] == _stages(cfg)
    assert all(e.cpu_parent is not None and e.cpu_parent.name == "fluid.step" for e in stages)
    reads = [e for e in spans if e.name == "fluid.mg.stopping_read"]
    assert len(reads) == len(tests)
    if cfg.pressure_solver == "multigrid" and cfg.mg_tol > 0:
        assert len(reads) >= 2  # k + 1 tests for k >= 1 completed cycles
        pressure = stages[-1]
        assert all(_inside(r, pressure) for r in reads)


# -- the rollout, the session and the frame loop --------------------------------------


def test_a_rollout_and_an_init_give_their_spans():
    sim = Simulation(PRESETS["parity"]())
    imp = timp.orbit_impulse(3, DT, (16.0, 16.0), 4, omega=3.0)
    spans, _ = _traced(lambda: sim.run(sim.init(), imp), shapes=True)
    names = [e.name for e in spans]
    assert names.count("fluid.init") == 1 and names.count("fluid.rollout") == 1
    roll = next(e for e in spans if e.name == "fluid.rollout")
    assert _ident(roll) == 3
    steps = [e for e in spans if e.name == "fluid.step"]
    assert [_ident(e) for e in steps] == [0, 1, 2]
    assert all(e.cpu_parent is roll for e in steps)


def test_a_session_set_up_holds_its_init():
    spans, _ = _traced(lambda: app.FluidApp(PRESETS["parity"](), fixed_dt=DT))
    setup = [e for e in spans if e.name == "fluid.session.setup"]
    init = [e for e in spans if e.name == "fluid.init"]
    assert len(setup) == 1 and len(init) == 1 and init[0].cpu_parent is setup[0]


@pytest.mark.parametrize("pipelined", [False, True], ids=["waits", "pipelined"])
@pytest.mark.parametrize("with_sink", [True, False], ids=["sink", "no_sink"])
def test_three_frames_give_three_frame_spans_with_their_phases(pipelined, with_sink):
    shown = []
    sink = shown.append if with_sink else None
    a = app.FluidApp(PRESETS["parity"](), frame_sink=sink, fixed_dt=DT)
    spans, _ = _traced(lambda: a.run(max_frames=3, pipelined=pipelined), shapes=True)
    frames = [e for e in spans if e.name == "fluid.frame"]
    assert [_ident(e) for e in frames] == [1, 2, 3]
    for k, frame in enumerate(frames, 1):
        phases = [e.name for e in spans if e.cpu_parent is frame]
        want = ["fluid.frame.input", "fluid.step"]
        if with_sink:
            want += ["fluid.render", "fluid.frame.layout", "fluid.frame.readback_queue"]
            # a pipelined frame hands the previous frame to the sink; the
            # last is handed over after the loop
            if not pipelined or k > 1:
                want += ["fluid.frame.sink"]
        assert phases == want, (k, phases)
    sinks = [e for e in spans if e.name == "fluid.frame.sink"]
    assert len(sinks) == (3 if with_sink else 0) and len(shown) == len(sinks)


# -- the counters ------------------------------------------------------------------


def test_counters_are_the_build_counters_alone():
    # the build counters, H3's two, H4's two, the single step's two and
    # multigrid's three
    c = trace.counters()
    assert set(c) == {"build_s", "builds", "loads", "diffuse_calls", "diffuse_passes",
                      "pressure_calls", "pressure_passes", "step_calls", "planned_stages",
                      "mg_solves", "mg_cycles", "mg_reads"}
    c["builds"] += 1  # a snapshot, not the counters themselves
    c["diffuse_passes"] += 1
    c["pressure_passes"] += 1
    c["planned_stages"] += 1
    assert trace.counters()["builds"] == c["builds"] - 1
    assert trace.counters()["diffuse_passes"] == c["diffuse_passes"] - 1
    assert trace.counters()["pressure_passes"] == c["pressure_passes"] - 1
    assert trace.counters()["planned_stages"] == c["planned_stages"] - 1


class _FakeCDLL:
    def __init__(self, path):
        self.path = path
        self.fluid_error_string = type("Fn", (), {})()


@pytest.fixture
def fake_compiler(tmp_path, monkeypatch):
    """A stand-in for nvcc (writes its ``-o`` file), a fresh build
    directory, no libraries loaded, zeroed build counters and a fake
    ``ctypes.CDLL``."""
    script = tmp_path / "fake-nvcc"
    script.write_text('#!/bin/sh\nwhile [ "$1" != "-o" ]; do shift; done\n'
                      'echo stub > "$2"\necho "ptxas info: 0 bytes spill"\n')
    script.chmod(script.stat().st_mode | stat.S_IXUSR)
    monkeypatch.setattr(_build, "nvcc", lambda: str(script))
    monkeypatch.setattr(_build, "BUILD", tmp_path / "build")
    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setattr(_build, "BUILD_STATS", {"build_s": 0.0, "builds": 0, "loads": 0})
    monkeypatch.setattr(ctypes, "CDLL", _FakeCDLL)
    return tmp_path / "build"


def _stats():
    c = trace.counters()
    return c["builds"], c["loads"], c["build_s"]


def test_a_compiled_library_counts_a_build_and_a_load(fake_compiler):
    lib = _build.load("advect")
    assert lib.path.startswith(str(fake_compiler))
    builds, loads, seconds = _stats()
    assert (builds, loads) == (1, 1) and seconds > 0
    assert _build.load("advect") is lib and _stats()[:2] == (1, 1)  # loaded once a process


def test_a_cached_library_counts_a_load_and_no_build(fake_compiler, monkeypatch):
    _build.build_all(["pressure"])
    assert _stats()[:2] == (1, 0)
    monkeypatch.setattr(_build, "nvcc", lambda: pytest.fail("a cached library was compiled"))
    _build.load("pressure")
    builds, loads, seconds = _stats()
    assert (builds, loads) == (1, 1) and seconds > 0
    monkeypatch.setattr(_build, "_LIBS", {})  # a later process: the library is on disk
    _build.load("pressure")
    assert _stats()[:2] == (1, 2)


def test_build_all_compiles_only_what_is_missing(fake_compiler):
    _build.build_all(["advect", "diffuse"])
    _build.build_all(["advect", "diffuse", "vorticity"])
    assert _stats()[:2] == (3, 0)
