"""The per-layer metric of H4's passes over device memory a call, on the
CPU: each of its two names reads the port's counters at the end of the run,
and gives None where the port keeps no such counter (an older port) or made
no such call, without raising."""

import os
import subprocess
import sys
from pathlib import Path

import pytest

from fluidbench import spec
from fluidbench.tests import small

ROOT = Path(__file__).resolve().parents[2]

PASSES = ("kernels.pressure_passes_per_call", "kernels.pressure_passes_per_call.live")


@pytest.mark.parametrize("name", PASSES)
def test_pressure_passes_per_call_is_the_ports_ratio(monkeypatch, name):
    from cudafluidsimulation_tpu_torch.ops import jacobi_cuda

    monkeypatch.setattr(jacobi_cuda, "PRESSURE_STATS", {"pressure_calls": 400, "pressure_passes": 1600})
    assert spec.reader(name)({"kind": "rollout"}) == pytest.approx(4.0)
    monkeypatch.setattr(jacobi_cuda, "PRESSURE_STATS", {"pressure_calls": 3, "pressure_passes": 5})
    assert spec.reader(name)({"kind": "frames"}) == pytest.approx(5 / 3)


@pytest.mark.parametrize("name", PASSES)
def test_pressure_passes_per_call_is_none_without_a_call(monkeypatch, name):
    from cudafluidsimulation_tpu_torch.ops import jacobi_cuda

    monkeypatch.setattr(jacobi_cuda, "PRESSURE_STATS", {"pressure_calls": 0, "pressure_passes": 0})
    assert spec.reader(name)({"kind": "rollout"}) is None


@pytest.mark.parametrize("name", PASSES)
def test_pressure_passes_per_call_is_none_for_a_port_without_the_counters(tmp_path, name):
    # an older port: counters() with the build counters and H3's alone
    utils = tmp_path / "cudafluidsimulation_tpu_torch" / "utils"
    utils.mkdir(parents=True)
    (utils.parent / "__init__.py").write_text("")
    (utils / "__init__.py").write_text("")
    (utils / "trace.py").write_text(
        "def counters():\n    return {'build_s': 1.5, 'builds': 0, 'loads': 6, "
        "'diffuse_calls': 400, 'diffuse_passes': 800}\n")
    code = ("import sys; from fluidbench import spec; "
            f"print(spec.reader({name!r})({{'kind': 'rollout'}}))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env={**os.environ, "PYTHONPATH": f"{tmp_path}{os.pathsep}{ROOT}"},
                         cwd=tmp_path, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "None"


@pytest.mark.parametrize("workload,name", [("parity-2048.orbit", PASSES[0]),
                                           ("parity-2048.live", PASSES[1])])
def test_each_cell_reports_the_passes_of_the_metric_it_moves(workload, name):
    traced = {m["name"]: m for m in spec.metrics_for(small.BENCH, workload, True)}
    assert name in traced and set(PASSES) - {name} - set(traced) == set(PASSES) - {name}
    e2e = [m["name"] for m in spec.metrics_for(small.BENCH, workload, False)]
    assert traced[name]["moves"] in e2e
