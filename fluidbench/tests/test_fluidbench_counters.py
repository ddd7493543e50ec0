"""The per-layer metrics that read the port's own counters, on the CPU:
each reads the port's counter at the end of the run, and gives None where
the port keeps no such counter (an older port), without raising."""

import os
import subprocess
import sys
from pathlib import Path

import pytest

from fluidbench import spec
from fluidbench.tests import small

ROOT = Path(__file__).resolve().parents[2]


def test_build_load_is_the_ports_build_seconds(monkeypatch):
    from cudafluidsimulation_tpu_torch.ops import _build

    monkeypatch.setattr(_build, "BUILD_STATS", {"build_s": 12.5, "builds": 6, "loads": 6})
    assert spec.reader("build.load_s")({"kind": "rollout"}) == pytest.approx(12.5)
    assert spec.reader("build.load_s")({"kind": "frames"}) == pytest.approx(12.5)


def test_build_load_is_none_for_a_port_without_counters(tmp_path):
    # an older port: the package and its utils, but no utils/trace.py
    utils = tmp_path / "cudafluidsimulation_tpu_torch" / "utils"
    utils.mkdir(parents=True)
    (utils.parent / "__init__.py").write_text("")
    (utils / "__init__.py").write_text("")
    code = ("import sys; from fluidbench import spec; "
            "print(spec.reader('build.load_s')({'kind': 'rollout'}))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env={**os.environ, "PYTHONPATH": f"{tmp_path}{os.pathsep}{ROOT}"},
                         cwd=tmp_path, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "None"


@pytest.mark.parametrize("workload", [c["name"] for c in small.BENCH["workloads"]])
def test_every_cell_reports_build_load_when_traced(workload):
    traced = [m["name"] for m in spec.metrics_for(small.BENCH, workload, True)]
    untraced = [m["name"] for m in spec.metrics_for(small.BENCH, workload, False)]
    assert "build.load_s" in traced and "build.load_s" not in untraced
