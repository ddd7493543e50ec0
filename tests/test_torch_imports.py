"""The port imports neither JAX nor the JAX package.

Every module of ``cudafluidsimulation_tpu_torch`` is imported in a fresh
interpreter (a subprocess: this test process has JAX loaded), which then
reports any ``jax`` or ``cudafluidsimulation_tpu`` module in
``sys.modules``.  The examples of the port are checked the same way.
"""

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent

PROBE = r"""
import importlib, json, pkgutil, runpy, sys
import cudafluidsimulation_tpu_torch as pkg
names = sorted(m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."))
for name in names:
    importlib.import_module(name)
for path in sys.argv[1:]:
    runpy.run_path(path, run_name="not_main")
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "jaxlib" or m.startswith("jaxlib.")
             or m == "cudafluidsimulation_tpu" or m.startswith("cudafluidsimulation_tpu."))
print(json.dumps({"modules": names, "bad": bad}))
"""

EXPECTED = {"utils.trace", "cli", "config", "entry", "interop", "state", "models.app",
            "models.ensemble", "models.pipelines", "models.simulation", "utils.http_view",
            "utils.native_sink", "utils.term_input", "utils.term_view", "utils.png", "utils.video",
            "ops.cuda_kernels", "ops.ref", "parallel.mesh", "parallel.halo",
            "parallel.shardmap_step", "parallel.shardmap2d", "parallel.sharded"}


@pytest.fixture(scope="module")
def probe():
    examples = sorted(str(p) for p in (ROOT / "examples").glob("*_torch.py"))
    run = subprocess.run([sys.executable, "-c", PROBE, *examples], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr
    return json.loads(run.stdout.strip().splitlines()[-1]), examples


def test_every_module_is_imported(probe):
    found, _ = probe
    short = {m.split(".", 1)[1] for m in found["modules"]}
    assert EXPECTED <= short, EXPECTED - short


def test_the_port_imports_no_jax(probe):
    found, examples = probe
    assert len(examples) >= 2
    assert found["bad"] == []
