"""On the card: each cell's command, one short run each, exits 0 with
``correct`` true and every metric of the cell (untraced and traced)."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

from fluidbench import spec
from fluidbench.tests import small

ROOT = Path(__file__).resolve().parents[2]


@pytest.mark.card
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("workload", [c["name"] for c in small.BENCH["workloads"]])
def test_the_command_runs_a_cell(card, workload, trace):
    out = subprocess.run([sys.executable, "-m", "fluidbench.run", "--workload", workload,
                          "--seed", "2147483999", "--seconds", "1", "--trace", str(trace)],
                         cwd=ROOT, capture_output=True, text=True, timeout=360)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] is True, res["checks"]
    want = {m["name"] for m in spec.metrics_for(small.BENCH, workload, bool(trace))}
    assert set(res["metrics"]) == want
    assert res["device"]["platform"] == "gpu" and res["device"]["count"] == 1
