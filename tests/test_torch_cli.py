"""The port's headless CLI (``cudafluidsimulation_tpu_torch.cli``) on the CPU.

- The same flags through the port's CLI and the JAX package's give fields
  within 1e-5 of each field's largest magnitude (gpu parity, the quality
  preset, the cpu variant), over 4 steps: the gpu-reference parameters are
  chaotic (float32 rounding differences grow ~10x a step past the fourth),
  so the runs are kept short.
- The port's CLI equals its own ``Simulation.run`` over the same impulse
  bit for bit, however the rollout is segmented.
- The parser has JAX's option strings and defaults; ``--backend`` takes
  ``auto | ref | cuda`` (``pallas`` is taken as ``cuda``).
- ``--mesh`` runs the sharded rollout (against the JAX CLI's:
  tests/test_torch_mesh_cli.py; ``--view``: tests/test_torch_view_cli.py);
  without ``--backend`` on a machine without a card the CLI exits and names
  ``--backend ref``.
- The flags the JAX package's tests drive (tests/test_harness.py): impulse
  scripts, periodic checkpoints with rotation, the health check and its
  salvage, ``--resume``, both report modes (bucket names and order equal
  JAX's), ``--profile-dir`` (one trace; its pad of spin kernels is the
  card's alone), ``--apng`` and ``--video``.
"""

import json
import re
import struct

import numpy as np
import pytest
import torch

from cudafluidsimulation_tpu import cli as jcli

from cudafluidsimulation_tpu_torch import FluidConfig, Simulation, cli
from cudafluidsimulation_tpu_torch.utils import impulse as timp
from cudafluidsimulation_tpu_torch.utils.checkpoint import load_state, prev_path

torch.set_num_threads(1)

RTOL = 1e-5
FIELDS = ("u", "v", "dye", "pressure")
BASE = ["--grid", "64", "--backend", "ref", "--impulse", "center"]
# a cheaper parameter set for the runs that test the harness, not physics
LIGHT = ["--diffusion-iters", "2", "--pressure-iters", "2"]


def _fields(path):
    with np.load(path) as d:
        return {k: d[k] for k in FIELDS}


def _buckets(text):
    return re.findall(r"^(.+) compute time: [-\d.]+ms$", text, flags=re.M)


def _center_run(cfg, steps):
    """The port's rollout over the CLI's ``--impulse center`` stream."""
    nx, ny = cfg.nx, cfg.ny
    sim = Simulation(cfg)
    imp = timp.constant_impulse(steps, cfg.dt, pos=(nx / 2, ny / 2),
                                last_pos=(nx / 2 - 3, ny / 2 - 2))
    return sim.run(sim.init(), imp)


def _assert_bit_equal(fields, state):
    for k in FIELDS:
        np.testing.assert_array_equal(fields[k], getattr(state, k).numpy(), err_msg=k)


@pytest.mark.parametrize("extra", [[], ["--preset", "quality"], ["--variant", "cpu"]],
                         ids=["gpu-parity", "quality", "cpu-variant"])
def test_cli_matches_jax_cli(tmp_path, extra):
    argv = BASE + ["--steps", "4"] + extra
    assert jcli.main(argv + ["--save-fields", str(tmp_path / "jax.npz")]) == 0
    assert cli.main(argv + ["--save-fields", str(tmp_path / "port.npz")]) == 0
    exp, got = _fields(tmp_path / "jax.npz"), _fields(tmp_path / "port.npz")
    for k in FIELDS:
        assert got[k].dtype == exp[k].dtype == np.float32
        scale = max(float(np.abs(exp[k]).max()), 1.0)
        np.testing.assert_allclose(got[k], exp[k], rtol=0, atol=RTOL * scale, err_msg=k)
    assert np.abs(got["dye"]).max() > 0


@pytest.mark.parametrize("extra", [
    [],
    ["--frame-every", "3", "--frames-dir", "{tmp}/frames"],
    ["--health", "--health-every", "2"],
    ["--checkpoint", "{tmp}/c.npz", "--checkpoint-every", "4"],
    ["--report", "--report-mode", "decomposed"],
], ids=["whole", "frames", "health", "checkpoints", "report"])
def test_cli_equals_its_rollout(tmp_path, extra):
    steps = 7
    extra = [a.replace("{tmp}", str(tmp_path)) for a in extra]
    out = tmp_path / "f.npz"
    assert cli.main(BASE + LIGHT + ["--steps", str(steps), "--save-fields", str(out)]
                    + extra) == 0
    cfg = FluidConfig.gpu_reference(nx=64, ny=64, backend="ref", diffusion_iters=2,
                                    pressure_iters=2)
    _assert_bit_equal(_fields(out), _center_run(cfg, steps))


def _options(parser):
    return {a.dest: a for a in parser._actions}


def test_parser_matches_jax():
    got, exp = _options(cli.build_parser()), _options(jcli.build_parser())
    assert got.keys() == exp.keys()
    for dest, a in exp.items():
        b = got[dest]
        assert b.option_strings == a.option_strings, dest
        assert (b.default, b.nargs, b.const, b.metavar) == (a.default, a.nargs, a.const,
                                                            a.metavar), dest
        if dest != "backend":
            assert b.choices == a.choices, dest
    assert got["backend"].choices == ["auto", "ref", "cuda"]
    args = cli.build_parser().parse_args(["--backend", "pallas"])
    assert args.backend == "cuda"


@pytest.mark.parametrize("argv, message", [
    (["--mesh", "rows"], "mesh: 1 devices, rows-only decomposition"),
    (["--mesh", "2d"], "mesh: 1 devices, 1x1 rows x cols"),
])
def test_unported_flags_exit(capsys, argv, message):
    # --mesh is ported: it runs the sharded rollout, here over the one
    # visible (CPU) device, and exits 0
    assert cli.main(BASE + argv + ["--steps", "1"]) == 0
    assert message in capsys.readouterr().out


@pytest.mark.parametrize("backend", [None, "auto", "cuda", "pallas"])
def test_no_card_exits_naming_backend_ref(monkeypatch, tmp_path, backend):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["--grid", "64", "--steps", "2", "--save-fields", str(tmp_path / "f.npz")]
    if backend is not None:
        argv += ["--backend", backend]
    with pytest.raises(SystemExit, match="pass --backend ref"):
        cli.main(argv)
    assert not (tmp_path / "f.npz").exists()


def test_cli_runs_as_a_module_and_exits_without_a_card():
    """``python -m cudafluidsimulation_tpu_torch.cli`` with no card visible
    and no ``--backend``: a non-zero exit that names ``--backend ref``."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    run = subprocess.run([sys.executable, "-m", "cudafluidsimulation_tpu_torch.cli",
                          "--grid", "64", "--steps", "2"],
                         cwd=Path(__file__).resolve().parent.parent, env=env,
                         capture_output=True, text=True, timeout=120)
    assert run.returncode != 0
    assert "pass --backend ref" in run.stderr


@pytest.mark.parametrize("form", ["list", "dict"])
def test_cli_impulse_file(tmp_path, form):
    if form == "list":
        events = [[30.0 + i, 32.0, i % 3 != 2] for i in range(5)]
    else:
        events = [{"pos": [30.0 + i, 32.0 - i], "pressed": i != 1, "dt": 0.01 + 0.002 * i}
                  for i in range(5)]
    script = tmp_path / "s.json"
    script.write_text(json.dumps(events))
    out = tmp_path / "f.npz"
    assert cli.main(["--grid", "64", "--backend", "ref", "--impulse-file", str(script),
                     "--steps", "99", "--save-fields", str(out)] + LIGHT) == 0
    cfg = FluidConfig.gpu_reference(nx=64, ny=64, backend="ref", diffusion_iters=2,
                                    pressure_iters=2)
    sim = Simulation(cfg)
    state = sim.run(sim.init(), timp.impulse_from_file(str(script), cfg.dt))
    assert int(state.step) == 5
    _assert_bit_equal(_fields(out), state)
    assert np.abs(state.dye.numpy()).max() > 0


def test_cli_checkpoint_every_rotates(tmp_path):
    ck = tmp_path / "c.npz"
    assert cli.main(BASE + LIGHT + ["--steps", "10", "--checkpoint", str(ck),
                                    "--checkpoint-every", "4"]) == 0
    # saves at steps 4 and 8, then the final save at 10 rotates 8's away
    assert int(load_state(str(ck), "cpu").step) == 10
    assert int(load_state(prev_path(str(ck)), "cpu").step) == 8
    assert sorted(p.name for p in tmp_path.iterdir()) == ["c.npz", "c.prev.npz"]


def test_cli_health_segments(capsys):
    assert cli.main(BASE + LIGHT + ["--steps", "12", "--health", "--health-every", "4"]) == 0
    assert _buckets(capsys.readouterr().out) == ["Min frame", "Max frame"]


def test_cli_health_failure_saves_last_good(tmp_path):
    ck = tmp_path / "salvage.npz"
    with pytest.raises(SystemExit, match="health check failed: velocity blow-up"):
        cli.main(BASE + LIGHT + ["--steps", "12", "--health", "1e-6", "--health-every", "4",
                                 "--checkpoint", str(ck)])
    # the first check fails, so the salvage is the (healthy) initial state
    st = load_state(str(ck), "cpu")
    assert int(st.step) == 0 and float(st.u.abs().max()) == 0.0


def test_cli_health_salvages_the_segment_before_a_blowup(tmp_path, monkeypatch):
    """A failure after healthy segments salvages the last healthy one, and
    that state is whole (the step never writes into its input)."""
    from cudafluidsimulation_tpu_torch.utils import health

    calls = []
    real = health.check_health

    def fails_third(state, max_speed=None):
        calls.append(int(state.step))
        if len(calls) == 3:
            raise health.HealthError("injected")
        return real(state, max_speed)

    monkeypatch.setattr(cli, "check_health", fails_third)
    ck = tmp_path / "salvage.npz"
    with pytest.raises(SystemExit, match="health check failed: injected"):
        cli.main(BASE + LIGHT + ["--steps", "12", "--health", "--health-every", "4",
                                 "--checkpoint", str(ck)])
    assert calls == [4, 8, 12]
    cfg = FluidConfig.gpu_reference(nx=64, ny=64, backend="ref", diffusion_iters=2,
                                    pressure_iters=2)
    st = load_state(str(ck), "cpu")
    assert int(st.step) == 8
    _assert_bit_equal({k: getattr(st, k).numpy() for k in FIELDS}, _center_run(cfg, 8))


def test_cli_resume(tmp_path):
    ck, out = tmp_path / "c.npz", tmp_path / "f.npz"
    assert cli.main(BASE + LIGHT + ["--steps", "5", "--checkpoint", str(ck)]) == 0
    assert cli.main(BASE + LIGHT + ["--steps", "3", "--impulse", "none", "--resume",
                                    str(ck), "--save-fields", str(out)]) == 0
    cfg = FluidConfig.gpu_reference(nx=64, ny=64, backend="ref", diffusion_iters=2,
                                    pressure_iters=2)
    sim = Simulation(cfg)
    state = sim.run_steps(load_state(str(ck), "cpu"), 3)
    assert int(state.step) == 8
    _assert_bit_equal(_fields(out), state)
    with pytest.raises(SystemExit, match="does not match requested --grid 32x32"):
        cli.main(["--grid", "32", "--backend", "ref", "--steps", "2", "--resume", str(ck)])


@pytest.mark.parametrize("mode", ["sampled", "decomposed"])
@pytest.mark.parametrize("extra", [[], ["--variant", "cpu"], ["--pressure-solver", "multigrid"]],
                         ids=["gpu", "cpu", "multigrid"])
def test_cli_report_buckets_match_jax(capsys, mode, extra):
    argv = BASE + LIGHT + ["--steps", "2", "--report", "--report-mode", mode] + extra
    assert jcli.main(argv) == 0
    exp = _buckets(capsys.readouterr().out)
    assert cli.main(argv) == 0
    got = _buckets(capsys.readouterr().out)
    assert got == exp
    assert got[-2:] == ["Min frame", "Max frame"]


def test_cli_profile_dir_writes_a_trace(tmp_path):
    prof = tmp_path / "prof"
    assert cli.main(BASE + LIGHT + ["--steps", "2", "--profile-dir", str(prof)]) == 0
    traces = list(prof.glob("*.json"))
    assert len(traces) == 1
    assert "traceEvents" in json.loads(traces[0].read_text())


def test_cli_profile_pad_is_the_cards_alone(tmp_path, monkeypatch):
    """On the CPU the trace's pad launches nothing and waits for nothing:
    ``--backend ref`` still writes exactly one trace, with no spin kernel."""
    def card_only(*a, **kw):
        raise AssertionError("the profiler pad touched the card on the CPU")

    monkeypatch.setattr(torch.cuda, "_sleep", card_only)
    monkeypatch.setattr(torch.cuda, "synchronize", card_only)
    cli._pad(torch.device("cpu"))
    prof = tmp_path / "prof"
    assert cli.main(BASE + LIGHT + ["--steps", "3", "--report", "--profile-dir", str(prof)]) == 0
    traces = list(prof.glob("*.json"))
    assert len(traces) == 1
    events = json.loads(traces[0].read_text())["traceEvents"]
    assert not any("spin_kernel" in str(e.get("name", "")) for e in events)
    assert not any(e.get("cat") == "kernel" for e in events)
    assert f"{cli.PROFILE_PAD} spin kernels" in cli.build_parser().format_help()


def test_cli_apng_and_video_frame_counts(tmp_path):
    apng, avi = tmp_path / "run.png", tmp_path / "run.avi"
    frames = tmp_path / "frames"
    assert cli.main(BASE + LIGHT + ["--steps", "12", "--frame-every", "4", "--apng", str(apng),
                                    "--video", str(avi), "--video-codec", "rgb",
                                    "--frames-dir", str(frames)]) == 0
    assert len(list(frames.glob("frame_*.png"))) == 3
    data = apng.read_bytes()
    actl = data.index(b"acTL") + 4
    assert struct.unpack(">II", data[actl:actl + 8]) == (3, 0)
    assert data.count(b"fcTL") == 3
    data = avi.read_bytes()
    avih = data.index(b"avih") + 8
    assert struct.unpack("<14I", data[avih:avih + 56])[4] == 3
    idx = data.index(b"idx1")
    assert struct.unpack("<I", data[idx + 4:idx + 8])[0] == 16 * 3
