"""The port's benchmarks (``cudafluidsimulation_tpu_torch/bench.py``,
``bench_torch.py``, ``scripts/bench_suite_torch.py``) against the JAX
package's ``bench.py`` and ``scripts/bench_suite.py``, on the CPU.

The rows run on the ``ref`` backend at small sizes; what they measure on
the card is not measured here.  What is held: the headline's configuration
and stream are ``bench.py``'s own (read from ``bench.py``'s ``main``), the
realized displacement equals JAX's ``run_displacement``, the solver
frontier's residuals equal JAX's, the ensemble's viscosities and streams
are the JAX suite's, the three traffic-model rows equal JAX's
``measure_halo_traffic`` exactly, two windows of a row end in bit-equal
states, the headline line carries every key of ``bench.py``'s, and without
a card both scripts raise before printing anything.
"""

import ast
import dataclasses
import importlib.util
import json
import runpy
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cudafluidsimulation_tpu as jpkg
import cudafluidsimulation_tpu.utils.impulse as jimpulse
from cudafluidsimulation_tpu import FluidConfig as JConfig
from cudafluidsimulation_tpu import Simulation as JSimulation
from cudafluidsimulation_tpu.models.ensemble import batched_impulse as jbatched_impulse
from cudafluidsimulation_tpu.ops import ref as jref
from cudafluidsimulation_tpu.ops.multigrid import pressure_solve_mg as jmg
from cudafluidsimulation_tpu.ops.multigrid import residual_norm as jresidual
from cudafluidsimulation_tpu.parallel.halo import measure_halo_traffic as jmeasure
from cudafluidsimulation_tpu.parallel.shardmap2d import make_mesh2d as jmesh2d
from cudafluidsimulation_tpu.parallel.shardmap2d import make_shardmap2d_step as jstep2d
from cudafluidsimulation_tpu.parallel.sharded import make_mesh as jmake_mesh

from cudafluidsimulation_tpu_torch import FluidConfig, Simulation, bench, interop
from cudafluidsimulation_tpu_torch.ops import backend
from cudafluidsimulation_tpu_torch.utils.impulse import Impulse

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
RTOL_DISPLACEMENT = 1e-5  # float32 differences grow ~10x a step in this flow
RTOL_RESIDUAL = 1e-4


def _ctx():
    return bench.context("ref", "cpu")


@pytest.fixture(scope="module")
def line():
    return bench.headline(_ctx(), n=64, steps=4)


class _Stop(Exception):
    pass


def _bench_py_parity(monkeypatch, on_tpu):
    """(config, stream) of ``bench.py``'s parity row, read from its
    ``main`` on a TPU (2048², 200 steps) or off it (256², 10 steps)."""
    spec = importlib.util.spec_from_file_location("jax_bench", ROOT / "bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    seen = {}
    real_orbit = jimpulse.orbit_impulse

    class Sim:
        def __init__(self, cfg):
            seen["cfg"] = cfg

    def orbit(*args, **kwargs):
        seen["imp"] = real_orbit(*args, **kwargs)
        raise _Stop

    monkeypatch.setattr(jax, "default_backend", lambda: "tpu" if on_tpu else "cpu")
    monkeypatch.setattr(jpkg, "Simulation", Sim)
    monkeypatch.setattr(jimpulse, "orbit_impulse", orbit)
    with pytest.raises(_Stop):
        mod.main()
    return seen["cfg"], seen["imp"]


@pytest.mark.parametrize("on_tpu", [True, False])
def test_parity_config_and_stream_are_bench_pys(monkeypatch, on_tpu):
    jcfg, jimp = _bench_py_parity(monkeypatch, on_tpu)
    n, steps = jcfg.nx, int(jimp.pressed.shape[0])
    assert (n, steps) == ((2048, 200) if on_tpu else (256, 10))
    cfgs = bench.headline_configs(n)
    assert cfgs["parity"] == interop.config_from_jax(jcfg)
    imp = bench.headline_stream(n, steps, cfgs["parity"].dt)
    for name in Impulse._fields:
        np.testing.assert_array_equal(getattr(imp, name).numpy(), np.asarray(getattr(jimp, name)))


def test_variant_configs_are_bench_pys():
    # bench.py's variants: FluidConfig.quality and the parity config with
    # the three fast modes (bench.py:111-118)
    cfgs = bench.headline_configs(2048)
    assert cfgs["quality"] == interop.config_from_jax(JConfig.quality(nx=2048, ny=2048,
                                                                      backend="auto"))
    assert cfgs["fast"] == interop.config_from_jax(JConfig.gpu_reference(
        nx=2048, ny=2048, pressure_iters=40, backend="auto", max_displacement=31,
        fast_dye=True, fast_velocity=True, fast_diffuse=True))


def test_realized_displacement_matches_jax(line):
    jcfg = JConfig.gpu_reference(nx=64, ny=64, pressure_iters=40, backend="ref",
                                 max_displacement=31)
    jsim = JSimulation(jcfg)
    _, (dx, dy) = jsim.run_displacement(
        jsim.init(), jimpulse.orbit_impulse(4, jcfg.dt, center=(32, 32), radius=8, omega=3.0))
    assert line["realized_max_displacement"] > 0
    assert line["realized_max_displacement"] == pytest.approx(max(float(dx), float(dy)),
                                                              rel=RTOL_DISPLACEMENT)
    # no single-device path of the port clamps a backtrace
    assert line["exact"] is True
    assert bench.exact(40.0, 40.0, 31, "cuda") is True


def _bench_py_keys():
    """Every key of ``bench.py``'s printed dict (bench.py:144-158) and of
    the variants it spreads into it."""
    tree = ast.parse((ROOT / "bench.py").read_text())
    keys = set()
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and any(getattr(t, "id", None) == "result" for t in node.targets)):
            keys |= {k.value for k in node.value.keys if isinstance(k, ast.Constant)}
        if isinstance(node, ast.For) and isinstance(node.iter, ast.Tuple):
            keys |= {e.elts[0].value for e in node.iter.elts
                     if isinstance(e, ast.Tuple) and isinstance(e.elts[0], ast.Constant)}
    return keys


def test_headline_carries_every_key_of_bench_py(line):
    keys = _bench_py_keys()
    assert {"metric", "value", "unit", "vs_baseline", "quiet_steps_per_sec",
            "quality_steps_per_sec", "fast_steps_per_sec", "max_displacement",
            "realized_max_displacement", "exact"} == keys
    assert keys <= set(line)
    assert {"device", "power_limit_w", "windows", "setup_s", "best_value",
            "best_quiet_steps_per_sec", "best_quality_steps_per_sec",
            "best_fast_steps_per_sec"} <= set(line)
    assert "backend=ref" in line["metric"] and line["unit"] == "steps/s"
    assert line["device"] == "cpu" and line["power_limit_w"] is None
    assert all(line[k] > 0 for k in bench.HEADLINE_RATES)
    assert line["vs_baseline"] == pytest.approx(line["value"] * 64 * 64 / 1e9 / 0.056)
    for row in line["rows"].values():
        assert len(row["window_s"]) == row["windows"] == line["windows"] == 5
        assert row["device_busy_share"] is None  # no card, no device time


def test_a_failing_variant_is_null_and_the_exit_code_one(monkeypatch, capsys):
    real = bench.Simulation

    def failing(cfg, device=None):
        if cfg.pressure_solver == "multigrid":
            raise RuntimeError("quality variant broke")
        return real(cfg, device)

    small = bench.headline
    monkeypatch.setattr(bench, "Simulation", failing)
    monkeypatch.setattr(bench, "headline", lambda ctx: small(ctx, n=32, steps=2))
    assert bench.headline_main(_ctx()) == 1
    out, err = capsys.readouterr()
    printed = json.loads(out.strip())
    assert printed["quality_steps_per_sec"] is None and printed["value"] > 0
    assert "quality variant broke" in err


def test_frontier_residuals_match_jax():
    rng = np.random.default_rng(0)
    div = rng.standard_normal((64, 64)).astype(np.float32)
    div -= div.mean()  # a consistent Neumann problem
    cfg_q = FluidConfig.quality(nx=64, ny=64, backend="ref")
    got = bench.frontier_residuals(backend.get_ops(cfg_q), torch.from_numpy(div), cfg_q)
    d = jnp.asarray(div)
    exp = {
        "zero": jresidual(jnp.zeros_like(d), d),
        "jacobi": jresidual(jref.pressure_solve(d, 40), d),
        "multigrid": jresidual(jmg(d, 2), d),
        "quality": jresidual(jmg(d, 2, tol=0.05, max_cycles=8), d),
    }
    for key, value in exp.items():
        assert got[key] == pytest.approx(float(value), rel=RTOL_RESIDUAL), key
    # the quality preset stops at its first cycle under mg_tol, which may
    # leave more than two fixed cycles do
    assert got["multigrid"] < got["jacobi"] < got["zero"] and got["quality"] < cfg_q.mg_tol


def test_ensemble_inputs_are_the_jax_suites():
    cfg = FluidConfig.gpu_reference(nx=512, ny=512, backend="ref")
    diffs, imp = bench.ensemble_inputs(cfg, 64, 100)
    jcfg = JConfig.gpu_reference(nx=512, ny=512, backend="ref")
    jimp = jbatched_impulse(
        jimpulse.orbit_impulse(100, jcfg.dt, center=(256.0, 256.0), radius=64.0), 64,
        jitter_pos=np.random.default_rng(0).uniform(-8, 8, (64, 2)))
    for name in Impulse._fields:
        np.testing.assert_array_equal(getattr(imp, name).numpy(), np.asarray(getattr(jimp, name)))
    # jnp.linspace blends the ends in float32 (start * (1 - s) + stop * s,
    # XLA's division for s), so it lies a few float32 steps from the
    # correctly rounded values, which differ by backend: 2 ulps of the
    # largest viscosity bound them
    jd = np.asarray(jnp.linspace(0.2, 1.5, 64))
    assert diffs.dtype == np.float32 and diffs[0] == jd[0] and diffs[-1] == jd[-1]
    np.testing.assert_allclose(diffs, jd, rtol=0, atol=2 * np.spacing(np.float32(1.5)))


def test_traffic_rows_equal_jax():
    got = bench.traffic_rows(_ctx())
    cpu = jax.devices("cpu")
    rows = jmake_mesh(8, ens=1, devices=cpu)
    n = 8192
    cfg = JConfig.gpu_reference(nx=n, ny=n, pressure_iters=100, backend="pallas")
    first = jmeasure(cfg, rows)
    first["ref_backend_exchange_pairs_per_step"] = jmeasure(
        dataclasses.replace(cfg, backend="ref"), rows)["exchange_pairs_per_step"]
    exp = [first,
           jmeasure(cfg, jmesh2d(2, 4, devices=cpu), step_builder=jstep2d),
           jmeasure(dataclasses.replace(cfg, pressure_solver="multigrid", mg_cycles=2), rows)]
    assert [g["config"] for g in got] == [
        "sharded 8192^2 (8-shard rows mesh model)",
        "sharded 8192^2 (2x4 rows-x-cols mesh model)",
        "sharded 8192^2 multigrid mg_cycles=2 (rows mesh model)"]
    for g, e in zip(got, exp):
        assert {k: g[k] for k in e} == e, g["config"]
        assert g["ici_mb_per_step_per_device"] == e["ici_bytes_per_step_per_device"] / 1e6
    assert [g["exchange_pairs_per_step"] for g in got] == [18, 36, 55]


def test_two_windows_end_in_bit_equal_states():
    cfg = bench.headline_configs(32, "ref")["parity"]
    sim = Simulation(cfg, "cpu")
    w = bench.sim_workload("parity", sim, bench.headline_stream(32, 3, cfg.dt), 32 * 32)
    _, event_s, first = bench.window(w)
    _, _, second = bench.window(w)
    assert event_s is None
    assert int(first.step) == 3
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_every_suite_row_runs_on_the_cpu():
    ctx = _ctx()
    plan = [
        ("cpu", lambda: bench.cpu_parity_row(ctx, 32, 2)),
        ("reference", lambda: bench.reference_row(ctx, 48, 27, 2)),
        ("single", lambda: bench.single_row(ctx, 32, 2, 8)),
        ("render", lambda: bench.render_row(ctx, 32, 2)),
        ("ensemble", lambda: bench.ensemble_row(ctx, 3, 32, 2)),
        ("frontier", lambda: bench.frontier_rows(ctx, 32, 2)),
        ("sharded", lambda: bench.sharded_row(ctx, 128, 1, 8)),
    ]
    lines = list(bench.suite(plan))
    assert len(lines) == 9
    for rec in lines:
        assert rec["steps_per_sec"] > 0 and rec["device"] == "cpu", rec
        assert rec["gcell_per_sec"] == pytest.approx(rec["vs_ref_gpu_gcell"] * 0.056)
        assert rec["best_steps_per_sec"] >= rec["steps_per_sec"]
    by = {rec["config"]: rec for rec in lines}
    assert by["ensemble 3 x 32^2 x2 viscosity sweep"]["member_steps_per_sec"] == pytest.approx(
        3 * by["ensemble 3 x 32^2 x2 viscosity sweep"]["steps_per_sec"])
    assert by["reference-workload 48x27 x2 (20/30 iters)"]["vs_ref_gpu_fps"] > 0
    frontier = [rec for rec in lines if rec["config"].startswith("solver-frontier")]
    assert [rec["residual_vs_jacobi40"] >= 1 for rec in frontier] == [True] * 3
    assert "over 8 shards on 1 cpu device(s)" in lines[-1]["config"]


def test_a_failing_suite_row_is_reported_and_the_rest_run(capsys):
    def broken():
        raise ValueError("row broke")

    plan = [("broken", broken), ("cpu", lambda: bench.cpu_parity_row(_ctx(), 16, 1))]
    assert bench.suite_main(plan) == 1
    out, err = capsys.readouterr()
    first, second = (json.loads(s) for s in out.strip().splitlines())
    assert first == {"config": "broken", "steps_per_sec": None, "error": "ValueError('row broke')"}
    assert second["steps_per_sec"] > 0
    assert "row broke" in err


@pytest.mark.parametrize("script", ["bench_torch.py", "scripts/bench_suite_torch.py"])
def test_without_a_card_the_scripts_raise_and_print_nothing(monkeypatch, capsys, script):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        runpy.run_path(str(ROOT / script), run_name="__main__")
    assert capsys.readouterr().out == ""


def test_no_card_context_names_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name in ("auto", "cuda"):
        with pytest.raises(RuntimeError, match="CUDA device"):
            bench.context(name)
    assert bench.card(torch.device("cpu")) == {"device": "cpu", "power_limit_w": None,
                                               "smi": None}
