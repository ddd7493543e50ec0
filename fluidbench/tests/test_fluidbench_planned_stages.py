"""The per-layer metric of the stage calls made through a prepared launch a
single step, on the CPU: each of its two names reads the port's counters at
the end of the run, and gives None where the port keeps no such counter (an
older port) or made no single step on the card, without raising."""

import os
import subprocess
import sys
from pathlib import Path

import pytest

from fluidbench import spec
from fluidbench.tests import small

ROOT = Path(__file__).resolve().parents[2]

PLANNED = ("host.planned_stages_per_step", "host.planned_stages_per_step.live")


@pytest.mark.parametrize("name", PLANNED)
def test_planned_stages_per_step_is_the_ports_ratio(monkeypatch, name):
    from cudafluidsimulation_tpu_torch.models import pipelines

    monkeypatch.setattr(pipelines, "STEP_STATS", {"step_calls": 400, "planned_stages": 1600})
    assert spec.reader(name)({"kind": "rollout"}) == pytest.approx(4.0)
    monkeypatch.setattr(pipelines, "STEP_STATS", {"step_calls": 3, "planned_stages": 7})
    assert spec.reader(name)({"kind": "frames"}) == pytest.approx(7 / 3)


@pytest.mark.parametrize("name", PLANNED)
def test_planned_stages_per_step_is_none_without_a_step(monkeypatch, name):
    from cudafluidsimulation_tpu_torch.models import pipelines

    monkeypatch.setattr(pipelines, "STEP_STATS", {"step_calls": 0, "planned_stages": 0})
    assert spec.reader(name)({"kind": "rollout"}) is None


@pytest.mark.parametrize("name", PLANNED)
def test_planned_stages_per_step_is_none_for_a_port_without_the_counters(tmp_path, name):
    # an older port: counters() with the build counters, H3's and H4's alone
    utils = tmp_path / "cudafluidsimulation_tpu_torch" / "utils"
    utils.mkdir(parents=True)
    (utils.parent / "__init__.py").write_text("")
    (utils / "__init__.py").write_text("")
    (utils / "trace.py").write_text(
        "def counters():\n    return {'build_s': 1.5, 'builds': 0, 'loads': 6, "
        "'diffuse_calls': 400, 'diffuse_passes': 800, 'pressure_calls': 400, "
        "'pressure_passes': 1600}\n")
    code = ("import sys; from fluidbench import spec; "
            f"print(spec.reader({name!r})({{'kind': 'rollout'}}))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env={**os.environ, "PYTHONPATH": f"{tmp_path}{os.pathsep}{ROOT}"},
                         cwd=tmp_path, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "None"


@pytest.mark.parametrize("workload,name", [("parity-2048.orbit", PLANNED[0]),
                                           ("parity-2048.live", PLANNED[1])])
def test_each_cell_reports_the_planned_stages_of_the_metric_it_moves(workload, name):
    traced = {m["name"]: m for m in spec.metrics_for(small.BENCH, workload, True)}
    assert name in traced and not set(PLANNED) - {name} & set(traced)
    e2e = [m["name"] for m in spec.metrics_for(small.BENCH, workload, False)]
    assert traced[name]["moves"] in e2e
    assert traced[name]["layer"] == "rollout loop and kernel wrappers"


@pytest.mark.parametrize("workload", ["parity-2048.orbit", "parity-2048.live"])
def test_a_small_run_on_the_cpu_counts_no_step_on_the_card(workload):
    # the plain ops on the CPU: no single step on the card, none prepared
    from cudafluidsimulation_tpu_torch.models import pipelines

    before = dict(pipelines.STEP_STATS)
    assert small.run_small(workload)["correct"]
    assert pipelines.STEP_STATS == before
