"""The harness on the CPU: discovery by name, the metric arithmetic, the
generator, the imports it may not make, BENCHMARK.json's shape, and whole
runs of each cell at a small size on the port's plain ops."""

import ast
import json
import math
import re
import shutil
from pathlib import Path

import pytest

from fluidbench import generator, roofline, run, spec, trace
from fluidbench.tests import small

HERE = Path(__file__).resolve().parent.parent
CELLS = [c["name"] for c in small.BENCH["workloads"]]


# -- discovery by name -------------------------------------------------------


def test_a_dropped_config_mix_limits_and_metric_are_found(tmp_path):
    root = tmp_path / "fluidbench"
    for d in ("configs", "traffic", "limits", "metrics"):
        shutil.copytree(HERE / d, root / d)
    conf = dict(spec.config("parity-2048"), preset="gpu_reference")
    (root / "configs" / "new-cfg.json").write_text(json.dumps(conf))
    (root / "traffic" / "new-mix.json").write_text(json.dumps({"kind": "rollout", "n": 3}))
    (root / "limits" / "new-cfg.new-mix.json").write_text(json.dumps({"counters": 0.0}))
    (root / "metrics" / "steps.total.py").write_text("def read(r):\n    return r['steps']\n")
    assert spec.config("new-cfg", root)["fluid"]["nx"] == 2048
    assert spec.traffic("new-mix", root)["n"] == 3
    assert spec.limits("new-cfg.new-mix", root) == {"counters": 0.0}
    assert spec.reader("steps.total", root)({"steps": 41}) == 41
    assert spec.reader("gcell_per_s", root) is not None


def test_metrics_for_takes_a_cells_own_and_the_unlisted():
    bench = {"end_to_end": [{"name": "a", "workloads": ["x"]}, {"name": "b"},
                            {"name": "c", "workloads": ["y"]}],
             "per_layer": [{"name": "d", "workloads": ["x", "y"]}]}
    assert [m["name"] for m in spec.metrics_for(bench, "x", False)] == ["a", "b"]
    assert [m["name"] for m in spec.metrics_for(bench, "y", True)] == ["d"]


# -- the metric arithmetic ---------------------------------------------------


def _read(name, rec):
    return spec.reader(name)(rec)


def test_rates_are_over_the_whole_window():
    rec = {"kind": "rollout", "cells": 2048 * 2048, "steps": 2000, "window_s": 2.0,
           "frame_s": [], "setup_s": 5.0}
    assert _read("gcell_per_s", rec) == pytest.approx(2048 * 2048 * 1000 / 1e9)
    assert _read("frames_per_s", rec) is None
    frames = {"kind": "frames", "frame_s": [0.001] * 900, "window_s": 1.5, "setup_s": 5.0}
    assert _read("frames_per_s", frames) == pytest.approx(600.0)  # not 1 / 1 ms
    assert _read("gcell_per_s", frames) is None
    assert _read("setup_s", frames) == 5.0


def test_p95_is_over_every_frame():
    frame_s = [k / 1000.0 for k in range(1, 101)]  # 1 .. 100 ms
    rec = {"kind": "frames", "frame_s": frame_s[::-1], "window_s": 5.0}
    assert _read("frame_ms_p95", rec) == pytest.approx(95.0)
    rec["frame_s"] = [0.001] * 94 + [0.010] * 6  # six slow frames of a hundred
    assert _read("frame_ms_p95", rec) == pytest.approx(10.0)


def test_idle_is_one_minus_the_union_of_device_intervals():
    dev = [("k1", 0.0, 2.0), ("k2", 1.0, 3.0), ("Memcpy DtoH (Device -> Pinned)", 5.0, 6.0),
           ("k3", 9.0, 12.0)]
    host = [("cudaEventSynchronize", 3.0, 5.0), ("aten::add", 6.5, 7.0),
            ("outer", 6.0, 9.0)]
    s = trace.summarize((0.0, 10.0), dev, host)
    assert s["busy_s"] == pytest.approx(3.0 + 1.0 + 1.0)  # overlap counted once, k3 clipped
    assert s["kernel_s"] == pytest.approx(2.0 + 2.0 + 1.0)
    assert s["readback_s"] == pytest.approx(1.0)
    assert dict(s["idle_gaps"]) == {"cudaEventSynchronize": pytest.approx(2.0),
                                    "outer": pytest.approx(3.0)}
    rec = {"kind": "rollout", "trace": s, "traced_steps": 10, "step_bound_s": 0.25}
    assert _read("device_idle_share.headless", rec) == pytest.approx(50.0)
    assert _read("kernel_roofline_share.headless", rec) == pytest.approx(50.0)
    assert _read("device_idle_share.live", rec) is None
    live = dict(rec, kind="frames", traced_frames=4)
    assert _read("device_idle_share.live", live) == pytest.approx(50.0)
    assert _read("view.readback_ms_per_frame", live) == pytest.approx(250.0)


def test_union_merges_touching_and_nested():
    assert trace.union([(3, 4), (0, 2), (1, 1.5), (2, 2.5)]) == [(0, 2.5), (3, 4)]


def test_the_step_bound_at_2048_is_the_stage_sum():
    fluid = spec.config("parity-2048")["fluid"]
    bound = roofline.step_bound_s(fluid, "NVIDIA H100 80GB HBM3")
    # H1 0.0501 + H2 0.020 + H3 0.050 + H4 0.025 ms: each bound by bytes
    assert bound * 1e3 == pytest.approx(0.145, rel=0.01)
    assert roofline.step_bound_s(fluid, "some other card") is None
    for nbytes, ops in roofline.stages(fluid).values():
        assert nbytes / 3.35e12 > ops / 67e12


def test_enqueue_is_the_median_of_segments():
    rec = {"kind": "rollout", "enqueue_ms": [0.5, 0.4, 9.0, 0.45, 0.41]}
    assert _read("host_enqueue_ms_per_step.headless", rec) == pytest.approx(0.45)
    assert _read("host_enqueue_ms_per_step.headless", dict(rec, kind="frames")) is None


# -- the generator -----------------------------------------------------------


def test_units_repeat_by_seed_and_keep_their_sizes():
    mix = spec.traffic("orbit-headless")
    fluid = spec.config("parity-2048")["fluid"]
    big = 2 ** 31 + 12345
    assert generator.unit(mix, fluid, big, 3) == generator.unit(mix, fluid, big, 3)
    a, b = generator.unit(mix, fluid, big, 0), generator.unit(mix, fluid, big + 1, 0)
    assert a != b and (a.steps, a.radius, a.omega) == (b.steps, b.radius, b.omega)
    for k in range(50):
        u = generator.unit(mix, fluid, -k, k)
        assert 2 <= u.probe < u.steps
        assert all(abs(c - 1024) <= mix["centre_offset"] for c in u.centre)
        assert 0 <= u.phase < 2 * math.pi
    pos, last, pressed, dt = a.stream(fluid["dt"])
    assert pos.shape == (200, 2) and pressed.all() and (last[1:] == pos[:-1]).all()


# -- imports ------------------------------------------------------------------


def _imported_names(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
    return names


SOURCES = sorted(p for p in HERE.rglob("*.py") if "tests" not in p.parts)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_module_imports_jax_or_the_jax_package(path):
    for name in _imported_names(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "flax", "cudafluidsimulation_tpu"), name
        assert not re.fullmatch(r"(bench|bench_torch|chip_\w+|scripts)", top), name
        assert not name.startswith("cudafluidsimulation_tpu_torch.bench"), name
        if "reference" in path.parts:
            assert top in ("__future__", "typing", "numpy", "torch", "fluidbench"), name
            assert not name.startswith("fluidbench.") or name.startswith(
                "fluidbench.reference"), name


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    import sys

    import cudafluidsimulation_tpu_torch  # noqa: F401  (its name begins with the JAX package's)

    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "cudafluidsimulation_tpu.config", object())
    assert run.forbidden_modules() == ["cudafluidsimulation_tpu"]


# -- BENCHMARK.json ------------------------------------------------------------

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")


def benchmark_json_names_files_that_exist(b=small.BENCH, root=HERE):
    """``b`` (a benchmark's table) names files that exist under ``root``
    and holds every cell to what each cell reports."""
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    for c in b["configs"]:
        assert NAME.fullmatch(c["name"]) and Path(root.parent / c["file"]).is_file()
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert spec.config(c["name"], root)["source"] == c["source"]
    pairs = set()
    for w in b["workloads"]:
        assert NAME.fullmatch(w["name"]) and w["chips"] == 1 and len(w["why"]) <= 200
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        spec.traffic(w["traffic"], root)
        spec.limits(w["name"], root)
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.fullmatch(m["name"]) and (root / "metrics" / f"{m['name']}.py").is_file()
        assert set(m["workloads"]) <= {w["name"] for w in b["workloads"]} if "workloads" in m \
            else True
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for w in b["workloads"]:
        e2e = spec.metrics_for(b, w["name"], False)
        assert "setup_s" in [m["name"] for m in e2e] and len(e2e) >= 2
        assert spec.metrics_for(b, w["name"], True)


def test_benchmark_json_names_files_that_exist():
    benchmark_json_names_files_that_exist()


def config_is_its_preset_as_run(name, root=HERE):
    conf = spec.config(name, root)
    cfg = run.port_config(conf, "ref")
    assert cfg.nx == conf["fluid"]["nx"] and conf["reduced"] == []


@pytest.mark.parametrize("name", [c["name"] for c in small.BENCH["configs"]])
def test_each_config_is_its_preset_as_run(name):
    config_is_its_preset_as_run(name)


# -- whole runs on the CPU ----------------------------------------------------


def small_run_is_correct(workload, root=spec.HERE, bench=small.BENCH):
    """A whole small run of the cell, its parts under ``root``: correct,
    with every end-to-end metric of the cell; the result for the caller."""
    res = small.run_small(workload, root=root, bench=bench)
    assert res["correct"] is True, res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert list(res)[-1] == "checks"
    e2e = {m["name"] for m in spec.metrics_for(bench, workload, False)}
    assert set(res["metrics"]) == e2e
    assert all(v["value"] > 0 for v in res["metrics"].values())
    assert all(c["value"] == 0 for c in res["checks"].values())  # plain ops both sides
    return res


@pytest.mark.parametrize("workload", CELLS)
def test_a_small_run_is_correct_and_reports_its_metrics(workload):
    small_run_is_correct(workload)
