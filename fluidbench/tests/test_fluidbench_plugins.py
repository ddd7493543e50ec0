"""What a later configuration or mix brings as new files, on the CPU: a
reference of its own with its own count of the step's stages
(``reference/<module>.py``, named by the configuration's ``reference``),
a driver of its own (``drivers/<kind>.py``, named by the mix's ``kind``),
captures judged member by member, and the port's spans in the traced
summary with the per-stage roofline that reads them.  A cell whose
reference has a ``Params`` of its own and whose driver names a step
factory of its own goes through the harness's per-cell test bodies (the
control, the broken steps, the small run) as new files only."""

import copy
import json
import math
import shutil
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from fluidbench import check, drive, roofline, run, spec, trace
from fluidbench.reference import step as parity
from fluidbench.tests import small
from fluidbench.tests import test_fluidbench_control as control
from fluidbench.tests import test_fluidbench_counters as counters
from fluidbench.tests import test_fluidbench_harness as harness

HERE = Path(__file__).resolve().parent.parent
CELLS = [c["name"] for c in small.BENCH["workloads"]]
H100 = "NVIDIA H100 80GB HBM3"
STAGE_READER = "stage_roofline_share.pressure_projection.headless"
END_TO_END = ("gcell_per_s", "frames_per_s", "frame_ms_p95")

WRAPPED = '''"""The parity step, wrapped: notes each call beside this file."""
from pathlib import Path

import torch

from fluidbench import roofline
from fluidbench.reference import step as base
from fluidbench.reference.step import Impulse, Params, State, host_scalars, init, render  # noqa

LOG = Path(__file__).with_suffix(".log")


def _note(what):
    with open(LOG, "a") as f:
        f.write(what + "\\n")


def step(p, s, imp, dtype=torch.float32):
    _note("step")
    return base.step(p, s, imp, dtype)


def stages(fluid):
    _note("stages")
    return {k: (2 * b, 2 * ops) for k, (b, ops) in roofline.stages(fluid).items()}
'''

RECORDED = '''"""Headless rollouts, noting each unit beside this file."""
from pathlib import Path

from fluidbench import drive

LOG = Path(__file__).with_suffix(".log")


class Recorded(drive.Rollout):
    kind = "recorded"
    records = "rollout"  # the headless readers read its window

    def unit(self, k):
        with open(LOG, "a") as f:
            f.write(f"unit {k}\\n")
        return super().unit(k)


DRIVER = Recorded
'''


def _records(metrics):
    """A reader that keeps the run's records and reports nothing."""
    kept = {}
    metrics.append(({"name": "records", "unit": "-"}, lambda r: kept.update(r)))
    return kept


def _run(conf, mix, limits, root=spec.HERE, seed=7, read=()):
    metrics = [({"name": name, "unit": "-"}, spec.reader(name)) for name in read]
    rec = _records(metrics)
    res = run.run_cell(conf, mix, limits, metrics, seed, 0.2, False, backend="ref", root=root)
    return res, rec


@pytest.fixture
def cpu_peaks(monkeypatch):
    """The CPU given the H100's row of peaks, so the runs bound their steps."""
    monkeypatch.setitem(roofline.PEAKS, "cpu", roofline.PEAKS[H100])


def _dropped_in(tmp_path, recorded=RECORDED):
    """A harness root with the wrapped reference and the recorded driver."""
    root = tmp_path / "fluidbench"
    for d in ("configs", "traffic", "limits"):
        shutil.copytree(HERE / d, root / d)
    (root / "reference").mkdir()
    (root / "drivers").mkdir()
    (root / "reference" / "wrapped.py").write_text(WRAPPED)
    (root / "drivers" / "recorded.py").write_text(recorded)
    _, conf, mix, limits = small.parts("parity-2048.orbit")
    conf["reference"] = "wrapped"
    mix["kind"] = "recorded"
    (root / "configs" / "wrapped-2048.json").write_text(json.dumps(conf))
    (root / "traffic" / "recorded-orbit.json").write_text(json.dumps(mix))
    return root, spec.config("wrapped-2048", root), spec.traffic("recorded-orbit", root), limits


def test_a_dropped_in_reference_and_driver_are_the_ones_run(tmp_path, cpu_peaks):
    root, conf, mix, limits = _dropped_in(tmp_path)
    res, rec = _run(conf, mix, limits, root, read=END_TO_END)
    assert res["correct"] is True, res["checks"]
    assert all(c["value"] == 0 for c in res["checks"].values())
    steps = (root / "reference" / "wrapped.log").read_text().split()
    assert steps.count("step") == 3 and "stages" in steps  # first, probe, last
    units = (root / "drivers" / "recorded.log").read_text().splitlines()
    assert units[:3] == ["unit 0", "unit 1", "unit 2"] and len(units) == 2 + res["attempted"]
    assert rec["kind"] == "rollout"  # the driver's records, not the mix's kind
    gcell = res["metrics"]["gcell_per_s"]["value"]  # through the cell's own reader
    assert gcell == rec["cells"] * rec["steps"] / rec["window_s"] / 1e9 > 0
    assert set(res["metrics"]) == {"gcell_per_s"}  # the live readers leave it out

    _, plain = _run(*small.parts("parity-2048.orbit")[1:])
    assert rec["step_bound_s"] == 2 * plain["step_bound_s"]  # its own count, doubled
    assert rec["stage_bound_s"] == {k: 2 * v for k, v in plain["stage_bound_s"].items()}


def test_a_dropped_in_driver_without_records_gives_its_own_kind(tmp_path):
    unlabelled = RECORDED.replace('    records = "rollout"  # the headless readers read its window\n', "")
    assert unlabelled != RECORDED
    root, conf, mix, limits = _dropped_in(tmp_path, unlabelled)
    res, rec = _run(conf, mix, limits, root, read=END_TO_END)
    assert res["correct"] is True and rec["kind"] == "recorded"
    assert res["metrics"] == {}  # no reader knows the record


def test_a_missing_reference_or_driver_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        spec.reference("vcycle", tmp_path)
    with pytest.raises(FileNotFoundError):
        spec.driver("ensemble", tmp_path)
    assert spec.driver("rollout", tmp_path) is drive.Rollout
    assert spec.driver("frames", tmp_path) is drive.Frames
    assert spec.reference(None).__file__ == parity.__file__


# -- a cell with its own Params and step factory, through the per-cell bodies --


def step_reference_named_or_not_reads_the_same(workload, root=spec.HERE, bench=small.BENCH):
    """The cell run as its configuration names its reference and with that
    name written out (``step`` where it names none) reads the same, and its
    step is bounded by that reference's own count of its stages; the first
    run's records for the caller."""
    _, conf, mix, limits = small.parts(workload, root=root, bench=bench)
    named = dict(copy.deepcopy(conf), reference=conf.get("reference") or "step")
    res_a, rec_a = _run(conf, mix, limits, root, seed=2 ** 31 + 11)
    res_b, rec_b = _run(named, mix, limits, root, seed=2 ** 31 + 11)
    assert res_a["correct"] is True and res_a["checks"] == res_b["checks"]
    assert rec_a["step_bound_s"] == rec_b["step_bound_s"]
    assert rec_a["stage_bound_s"] == rec_b["stage_bound_s"]
    fluid = conf["fluid"]
    count = getattr(spec.reference(conf.get("reference"), root), "stages", roofline.stages)
    assert rec_a["step_bound_s"] == roofline.step_bound_s(fluid, H100, count)  # bit for bit
    assert rec_a["step_bound_s"] == sum(
        max(b / 3.35e12, ops / 67e12) for b, ops in count(fluid).values())
    return rec_a


OWN = "own-2048.orbit"

OWN_REFERENCE = '''"""The parity step under a Params of its own, with its own count of the
step's stages (three times the parity's); notes its calls in a log."""
from pathlib import Path
from typing import NamedTuple

import torch

from fluidbench import roofline
from fluidbench.reference import step as base
from fluidbench.reference.step import Impulse, State, host_scalars  # noqa

LOG = Path(__file__).with_suffix(".log")


def _note(what):
    with open(LOG, "a") as f:
        f.write(what + "\\n")


class Params(NamedTuple):
    parity: base.Params

    @staticmethod
    def from_fluid(fluid):
        _note("from_fluid")
        return Params(base.Params.from_fluid(fluid))


def init(p, device, dtype=torch.float32):
    return base.init(p.parity, device, dtype)


def step(p, s, imp, dtype=torch.float32):
    _note("step")
    return base.step(p.parity, s, imp, dtype)


def render(p, s, dtype=torch.float32):
    return base.render(p.parity, s, dtype)


def stages(fluid):
    _note("stages")
    return {k: (3 * b, 3 * ops) for k, (b, ops) in roofline.stages(fluid).items()}
'''

OWN_STEPS = '''"""The port's step factory, wrapped: notes its calls beside this file."""
from pathlib import Path

from cudafluidsimulation_tpu_torch.models import pipelines

LOG = Path(__file__).with_suffix(".log")


def make_step(config, ops=None):
    with open(LOG, "a") as f:
        f.write("make_step\\n")
    return pipelines.make_step(config, ops)
'''

OWN_DRIVER = '''"""Headless rollouts whose step the factory of ``steps_own`` builds."""
import importlib

from fluidbench import drive


class Stepped(drive.Rollout):
    kind = "stepped"
    records = "rollout"
    step_factory = ("steps_own", "make_step")

    def __init__(self, config, fluid, mix, seed):
        super().__init__(config, fluid, mix, seed)
        module, name = self.step_factory
        self.sim.step_fn = getattr(importlib.import_module(module), name)(config, self.sim.ops)


DRIVER = Stepped
'''


def _own_cell(tmp_path, monkeypatch):
    """A harness root and a benchmark table with one more cell, ``OWN``:
    the parity configuration naming the reference ``own`` (a ``Params`` and
    a count of stages of its own), and the orbit mix of kind ``stepped``
    (a driver whose step comes from the factory of ``steps_own``, a module
    of that root on the import path), each a new file."""
    root = tmp_path / "fluidbench"
    for d in ("configs", "traffic", "limits", "metrics"):
        shutil.copytree(HERE / d, root / d)
    for path, text in (("reference/own.py", OWN_REFERENCE), ("steps/steps_own.py", OWN_STEPS),
                       ("drivers/stepped.py", OWN_DRIVER)):
        (root / path).parent.mkdir(exist_ok=True)
        (root / path).write_text(text)
    monkeypatch.syspath_prepend(str(root / "steps"))
    monkeypatch.delitem(sys.modules, "steps_own", raising=False)  # an earlier root's
    conf = dict(spec.config("parity-2048"), reference="own")
    mix = dict(spec.traffic("orbit-headless"), kind="stepped")
    (root / "configs" / "own-2048.json").write_text(json.dumps(conf))
    (root / "traffic" / "stepped-orbit.json").write_text(json.dumps(mix))
    shutil.copy(root / "limits" / "parity-2048.orbit.json", root / "limits" / f"{OWN}.json")
    bench = copy.deepcopy(small.BENCH)
    bench["configs"].append({"name": "own-2048", "source": conf["source"],
                             "file": "fluidbench/configs/own-2048.json", "reduced": [],
                             "why": "its own Params and count of stages"})
    bench["workloads"].append({"name": OWN, "config": "own-2048", "traffic": "stepped-orbit",
                               "chips": 1, "why": "its own Params and step factory"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "parity-2048.orbit" in m.get("workloads", []):
            m["workloads"].append(OWN)
    return root, bench


def _notes(root):
    """What the cell's reference and its step factory noted."""
    logs = (root / "reference" / "own.log", root / "steps" / "steps_own.log")
    return [log.read_text().split() if log.exists() else [] for log in logs]


# Every body that fluidbench/tests runs over the cells or configurations of
# BENCHMARK.json, and the check of the table itself: the reference's Params
# made, the factory's calls and its stages counted (once a whole run) in each.
OWN_BODIES = {
    "control": (1, 1, 0),         # correct in float32, not in bfloat16
    "unchanged": (1, 0, 1),       # correct false; the fault's factory calls no other
    "altered": (1, 1, 1),         # correct false
    "small_run": (1, 1, 1),       # correct, every check 0
    "step_reference": (2, 2, 4),  # named or not, the same; bounded by its own stages
    "build_load": (0, 0, 0),
    "preset": (0, 0, 0),
    "benchmark_json": (0, 0, 0),
}


@pytest.mark.parametrize("body", list(OWN_BODIES))
def test_a_cells_own_reference_and_driver_are_the_ones_its_tests_run(tmp_path, monkeypatch,
                                                                      cpu_peaks, body):
    root, bench = _own_cell(tmp_path, monkeypatch)
    if body == "control":
        control.control_is_not_correct(OWN, 5, root, bench)
    elif body in control.FAULTS:
        control.broken_step_is_not_correct(OWN, control.FAULTS[body], monkeypatch, root, bench)
    elif body == "small_run":
        res = harness.small_run_is_correct(OWN, root, bench)
        assert set(res["metrics"]) == {"gcell_per_s", "setup_s"}
    elif body == "step_reference":
        rec = step_reference_named_or_not_reads_the_same(OWN, root, bench)
        fluid = small.parts(OWN, root=root, bench=bench)[1]["fluid"]
        assert rec["step_bound_s"] == pytest.approx(3 * roofline.step_bound_s(fluid, H100))
    elif body == "build_load":
        counters.reports_build_load_when_traced(OWN, bench)
    elif body == "preset":
        harness.config_is_its_preset_as_run("own-2048", root)
    else:
        harness.benchmark_json_names_files_that_exist(bench, root)
    made, built, runs = OWN_BODIES[body]
    reference, factory = _notes(root)
    assert reference.count("from_fluid") == made and reference[:1] == ["from_fluid"][:made]
    assert ("step" in reference) == (made > 0) and reference.count("stages") == runs
    assert factory == ["make_step"] * built


@pytest.mark.parametrize("workload", CELLS)
def test_the_step_reference_named_or_not_reads_the_same(workload, cpu_peaks):
    step_reference_named_or_not_reads_the_same(workload)


def test_the_stage_bounds_at_2048_sum_to_the_step_bound():
    fluid = spec.config("parity-2048")["fluid"]
    stages = roofline.stage_bound_s(fluid, H100)
    assert list(stages) == ["advection", "vorticity", "diffusion_splat", "pressure_projection"]
    assert stages["pressure_projection"] * 1e3 == pytest.approx(0.025, rel=0.01)  # H4, bytes
    assert sum(stages.values()) == roofline.step_bound_s(fluid, H100)
    assert roofline.stage_bound_s(fluid, "some other card") is None


# -- judging a list of captures ---------------------------------------------


def _capture(seed):
    _, conf, mix, _ = small.parts("parity-2048.orbit")
    cfg = run.port_config(conf, "ref")
    return drive.Rollout(cfg, conf["fluid"], mix, seed).units(1)


def _spoil(cap, field, how):
    last = cap.states[cap.unit.steps]
    cap.states[cap.unit.steps] = last._replace(**{field: how(getattr(last, field))})
    return cap


def test_judge_over_captures_gives_the_worst_of_each_number():
    params = parity.Params.from_fluid(small.parts("parity-2048.orbit")[1]["fluid"])
    clean = _capture(1)
    u_off = _spoil(_capture(2), "u", lambda u: 3 * u + 1)
    dye_nan = _spoil(_capture(3), "dye", lambda d: d * float("nan"))
    each = [check.judge(c, params) for c in (clean, u_off, dye_nan)]
    worst = check.judge([clean, u_off, dye_nan], params)
    assert set(worst) == set(each[0])
    assert worst["step_u"] == each[1]["step_u"] == max(e["step_u"] for e in each) >= 1
    assert math.isnan(worst["step_dye"])
    assert worst["step_v"] == max(e["step_v"] for e in each)
    assert check.judge([clean], params) == check.judge(clean, params)
    assert check.judge((u_off, clean), params)["step_u"] == each[1]["step_u"]
    ctl = check.judge([clean, clean], params, torch.bfloat16)
    assert ctl == check.judge(clean, params, torch.bfloat16)


# -- spans in the traced summary ---------------------------------------------

HOST = [  # name, start, end, parent
    ("fluid.rollout", 0.0, 10.0, None),                      # 0
    ("fluid.step", 0.5, 4.5, 0),                             # 1
    ("fluid.step.advection", 0.6, 1.5, 1),                   # 2
    ("cudaLaunchKernel", 0.7, 0.8, 2),                       # 3
    ("fluid.step.pressure_projection", 1.6, 4.0, 1),         # 4
    ("aten::zero_", 1.7, 1.9, 4),                            # 5
    ("aten::fill_", 1.75, 1.85, 5),                          # 6
    ("cudaLaunchKernel", 2.0, 2.1, 4),                       # 7
    ("cudaEventSynchronize", 5.0, 7.0, 0),                   # 8
    ("fluid.step", 7.5, 9.0, 0),                             # 9
    ("aten::empty", 7.6, 7.7, 9),                            # 10
]
DEVICE = [  # name, start, end
    ("advect_rows_kernel", 1.0, 2.0),
    ("Memset (Device)", 2.0, 2.5),
    ("pressure_burst_kernel", 2.5, 4.75),
    ("fluid.step.pressure_projection", 1.6, 4.0),  # a span projected on the device
    ("vel_bound_kernel", 8.0, 8.5),
    ("late_kernel", 9.5, 11.0),
]
LINKS = [3, 6, 7, 4, 10, None]


def test_summarize_bills_device_time_to_the_innermost_span():
    window = (0.0, 10.0)
    host3 = [h[:3] for h in HOST]
    plain = trace.summarize(window, DEVICE, host3)
    linked = trace.summarize(window, DEVICE, HOST, LINKS)
    for key in ("window_s", "busy_s", "kernel_s", "readback_s", "device_ops", "idle_gaps"):
        assert linked[key] == plain[key], key
    assert plain["busy_s"] == pytest.approx(1.0 + 0.5 + 2.25 + 0.5 + 0.5)  # the annotation out
    assert dict(plain["idle_gaps"]) == {"fluid.step": pytest.approx(1.0),
                                        "cudaEventSynchronize": pytest.approx(3.25),
                                        "fluid.rollout": pytest.approx(1.0)}
    spans = linked["spans"]
    assert set(spans) == {"fluid.rollout", "fluid.step", "fluid.step.advection",
                          "fluid.step.pressure_projection"}
    assert spans["fluid.step.advection"] == {"count": 1, "host_s": pytest.approx(0.9),
                                             "device_s": pytest.approx(1.0)}
    # the memset through aten::fill_ and aten::zero_, the kernel from the span
    assert spans["fluid.step.pressure_projection"]["device_s"] == pytest.approx(0.5 + 2.25)
    assert spans["fluid.step"] == {"count": 2, "host_s": pytest.approx(4.0 + 1.5),
                                   "device_s": pytest.approx(0.5)}
    assert spans["fluid.rollout"]["device_s"] == 0.0  # late_kernel has no launch
    assert all(s["device_s"] == 0.0 for s in plain["spans"].values())
    assert plain["spans"]["fluid.step"]["count"] == 2


def test_launches_pair_device_events_with_the_cpu_event_listing_them():
    def dev(name, start, dur, device=0):
        return SimpleNamespace(name=name, device_index=device, time_range=SimpleNamespace(
            start=start, end=start + dur, elapsed_us=lambda: dur))

    def cpu(*kernels):
        return SimpleNamespace(kernels=[SimpleNamespace(name=n, device=0, duration=d)
                                        for n, d in kernels])

    host = [cpu(), cpu(("k", 2.0)), cpu(("k", 2.0), ("m", 1.0)), cpu(("k", 3.0))]
    device = [dev("k", 10, 2.0), dev("k", 12, 2.0), dev("m", 14, 1.0), dev("k", 15, 3.0),
              dev("k", 18, 2.0), dev("k", 20, 3.0, device=1)]
    assert trace.launches(host, device) == [1, 2, 2, 3, None, None]


# -- the per-stage roofline reader --------------------------------------------


def test_the_stage_roofline_reads_the_span_or_nothing():
    read = spec.reader(STAGE_READER)
    bound = {"pressure_projection": 0.025e-3, "advection": 0.05e-3}
    span = {"count": 400, "host_s": 0.08, "device_s": 0.14752}
    rec = {"kind": "rollout", "traced_steps": 400, "stage_bound_s": bound,
           "trace": {"spans": {"fluid.step.pressure_projection": span}}}
    assert read(rec) == pytest.approx(100 * 0.025 / 0.3688)
    assert read(dict(rec, trace=None)) is None
    assert read(dict(rec, trace={"spans": {}})) is None
    assert read(dict(rec, trace={"busy_s": 1.0})) is None  # a summary without spans
    assert read(dict(rec, trace={"spans": {"fluid.step.pressure_projection":
                                           dict(span, device_s=0.0)}})) is None
    assert read(dict(rec, stage_bound_s=None)) is None
    assert read(dict(rec, stage_bound_s={"advection": 1e-5})) is None
    assert read(dict(rec, kind="frames")) is None


def test_the_stage_roofline_is_the_orbit_cells_alone():
    entry = {m["name"]: m for m in small.BENCH["per_layer"]}[STAGE_READER]
    assert entry == {"name": STAGE_READER, "unit": "%", "better": "higher",
                     "source": "device_trace", "layer": "kernels", "moves": "gcell_per_s",
                     "workloads": ["parity-2048.orbit"]}
    live = [m["name"] for m in spec.metrics_for(small.BENCH, "parity-2048.live", True)]
    assert STAGE_READER not in live
