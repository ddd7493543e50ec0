"""The port's utilities against the JAX package's, on the CPU.

- Checkpoints (``utils/checkpoint.py``): the cases of
  tests/test_checkpoint.py, and checkpoints cross-loading between the two
  packages with bit-equal arrays and dtypes; a run resumed in the port from
  a JAX checkpoint stays within 1e-5 of each field's scale of JAX's.
- Health (``utils/health.py``): the cases of tests/test_health.py; the
  port's single-device advection is unbounded, so ``clamp_axes`` is ''
  where the JAX package's Pallas backend says 'y'.
- Writers: ``png_bytes``, ``write_apng`` and the RGB AVI give the JAX
  package's bytes; ``jpeg_bytes`` and the MJPEG AVI too where ``g++``
  builds the encoder (the same source and flags).
- ``StageReport.format()`` gives the JAX package's text; the impulse
  scripts and concatenation give its arrays; the stage timer threads its
  carry; ``stage_timings`` has its buckets.
- ``run_instrumented`` on ``ref`` equals the plain rollout bit for bit, and
  a step leaves its input state's tensors unchanged.
"""

import json
import os

import numpy as np
import pytest
import torch

from cudafluidsimulation_tpu import FluidConfig as JConfig
from cudafluidsimulation_tpu import Simulation as JSimulation
from cudafluidsimulation_tpu.utils import checkpoint as jckpt
from cudafluidsimulation_tpu.utils import health as jhealth
from cudafluidsimulation_tpu.utils import impulse as jimp
from cudafluidsimulation_tpu.utils import jpeg as jjpeg
from cudafluidsimulation_tpu.utils import png as jpng
from cudafluidsimulation_tpu.utils import timing as jtiming
from cudafluidsimulation_tpu.utils import video as jvideo

from cudafluidsimulation_tpu_torch import FluidConfig, FluidState, Simulation, interop
from cudafluidsimulation_tpu_torch.models.pipelines import make_step
from cudafluidsimulation_tpu_torch.ops.backend import get_ops
from cudafluidsimulation_tpu_torch.utils import impulse as timp
from cudafluidsimulation_tpu_torch.utils import jpeg, native_sink, png, video
from cudafluidsimulation_tpu_torch.utils.checkpoint import (
    load_state, load_state_with_fallback, prev_path, save_state)
from cudafluidsimulation_tpu_torch.utils.health import (
    Health, HealthError, check_health, clamp_axes, displacement_check, run_checked)
from cudafluidsimulation_tpu_torch.utils.instrument import (
    StageSpans, run_instrumented, timed_ops)
from cudafluidsimulation_tpu_torch.utils.timing import StageReport, cuda_times_ms, time_stage

torch.set_num_threads(1)

RTOL = 1e-5
FIELDS = ("u", "v", "dye", "pressure", "vel_stats")


def _cfg(**kw):
    return FluidConfig.gpu_reference(nx=64, ny=64, backend="ref", diffusion_iters=2,
                                     pressure_iters=2, **kw)


def _state(steps=0):
    sim = Simulation(_cfg())
    state = sim.init()
    if steps:
        state = sim.run(state, timp.constant_impulse(steps, sim.config.dt, pos=(32.0, 32.0),
                                                     last_pos=(29.0, 30.0)))
    return state


def _assert_states_equal(a, b):
    for k in FluidState._fields:
        x, y = getattr(a, k), getattr(b, k)
        assert x.dtype == y.dtype, k
        assert torch.equal(x, y), k


# -- checkpoints: tests/test_checkpoint.py's cases ---------------------------


def test_save_leaves_no_tmp_files(tmp_path):
    path = str(tmp_path / "ck.npz")
    save_state(path, _state())
    assert os.listdir(tmp_path) == ["ck.npz"]


def test_round_trip_is_bit_equal_and_keeps_dtypes(tmp_path):
    path = str(tmp_path / "ck.npz")
    s = _state(3)
    save_state(path, s)
    out = load_state(path, "cpu")
    _assert_states_equal(out, s)
    assert out.step.dtype == torch.int32 and out.u.dtype == torch.float32
    with np.load(path) as d:
        assert sorted(d.files) == sorted(FluidState._fields)


def test_rotation_keeps_previous_checkpoint(tmp_path):
    path = str(tmp_path / "ck.npz")
    s1, s2 = _state(), _state(3)
    save_state(path, s1)
    save_state(path, s2)
    _assert_states_equal(load_state(path, "cpu"), s2)
    _assert_states_equal(load_state(prev_path(path), "cpu"), s1)


def test_crash_mid_write_preserves_existing_checkpoint(tmp_path, monkeypatch):
    path = str(tmp_path / "ck.npz")
    s1 = _state()
    save_state(path, s1)

    def boom(f, **kw):
        f.write(b"partial garbage")
        raise RuntimeError("simulated kill mid-write")

    monkeypatch.setattr(np, "savez_compressed", boom)
    with pytest.raises(RuntimeError):
        save_state(path, _state(3))
    monkeypatch.undo()
    _assert_states_equal(load_state(path, "cpu"), s1)
    assert sorted(os.listdir(tmp_path)) == ["ck.npz"]


@pytest.mark.parametrize("damage", [b"\x00" * 100, b"PK\x03\x04 torn zip"], ids=["zeros", "torn-zip"])
def test_damaged_checkpoint_falls_back_to_prev(tmp_path, damage):
    path = str(tmp_path / "ck.npz")
    s1 = _state()
    save_state(path, s1)
    save_state(path, _state(3))
    with open(path, "wb") as f:
        f.write(damage)
    with pytest.raises(Exception):
        load_state(path, "cpu")
    _assert_states_equal(load_state_with_fallback(path, "cpu"), s1)


def test_fallback_raises_when_no_prev(tmp_path):
    path = str(tmp_path / "ck.npz")
    with open(path, "wb") as f:
        f.write(b"not a checkpoint")
    with pytest.raises(ValueError):
        load_state_with_fallback(path, "cpu")


def test_extensionless_path_normalization(tmp_path):
    path = str(tmp_path / "ck")
    s = _state()
    save_state(path, s)
    _assert_states_equal(load_state(path, "cpu"), s)
    save_state(path, _state(2))
    assert os.path.exists(str(tmp_path / "ck.prev.npz"))


def test_save_creates_parent_directory(tmp_path):
    st = FluidConfig.gpu_reference(nx=64, ny=32, backend="ref")
    dst = tmp_path / "deep" / "nested" / "c.npz"
    save_state(str(dst), Simulation(st).init())
    assert load_state(str(dst), "cpu").u.shape == (32, 64)


def test_load_state_needs_a_card_unless_asked_for_the_cpu(tmp_path, monkeypatch):
    path = str(tmp_path / "ck.npz")
    save_state(path, _state())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_state(path)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_state_with_fallback(path)
    assert load_state(path, "cpu").u.device.type == "cpu"


def test_old_checkpoint_without_vel_stats_gets_the_bound(tmp_path):
    s = _state(3)
    arrays = interop.state_to_numpy(s)
    del arrays["vel_stats"]
    path = str(tmp_path / "old.npz")
    np.savez_compressed(path, **arrays)
    out = load_state(path, "cpu")
    expect = torch.stack([s.u.abs().max(), s.v.abs().max()])
    assert torch.equal(out.vel_stats, expect)
    assert out.vel_stats.dtype == torch.float32


def _jax_state(steps):
    cfg = JConfig.gpu_reference(nx=64, ny=64, backend="ref", diffusion_iters=2, pressure_iters=2)
    sim = JSimulation(cfg)
    imp = jimp.constant_impulse(steps, cfg.dt, pos=(32.0, 32.0), last_pos=(29.0, 30.0))
    return sim.run(sim.init(), imp)


def test_jax_checkpoint_loads_in_the_port(tmp_path):
    js = _jax_state(3)
    path = str(tmp_path / "jax.npz")
    jckpt.save_state(path, js)
    got = interop.state_to_numpy(load_state(path, "cpu"))
    for k, x in js._asdict().items():
        x = np.asarray(x)
        assert got[k].dtype == x.dtype, k
        np.testing.assert_array_equal(got[k], x, err_msg=k)


def test_port_checkpoint_loads_in_jax(tmp_path):
    s = _state(3)
    path = str(tmp_path / "port.npz")
    save_state(path, s)
    js = jckpt.load_state(path)
    exp = interop.state_to_numpy(s)
    for k, x in js._asdict().items():
        x = np.asarray(x)
        assert x.dtype == exp[k].dtype, k
        np.testing.assert_array_equal(x, exp[k], err_msg=k)


def test_resume_from_a_jax_checkpoint_tracks_jax(tmp_path):
    path = str(tmp_path / "jax.npz")
    jckpt.save_state(path, _jax_state(3))
    jcfg = JConfig.gpu_reference(nx=64, ny=64, backend="ref")
    jsim = JSimulation(jcfg)
    more = jimp.constant_impulse(3, jcfg.dt, pos=(34.0, 30.0), last_pos=(33.0, 31.0))
    exp = jsim.run(jckpt.load_state(path), more)
    sim = Simulation(interop.config_from_jax(jcfg))
    got = sim.run(load_state(path, "cpu"),
                  timp.Impulse(*(torch.from_numpy(np.array(f)) for f in more)))
    got = interop.state_to_numpy(got)
    for k in FIELDS:
        e = np.asarray(getattr(exp, k))
        scale = max(float(np.abs(e).max()), 1.0)
        np.testing.assert_allclose(got[k], e, rtol=0, atol=RTOL * scale, err_msg=k)
    assert int(got["step"]) == 6


# -- health: tests/test_health.py's cases -------------------------------------


def test_healthy_run_passes():
    sim = Simulation(_cfg())
    imp = timp.constant_impulse(25, sim.config.dt, pos=(32.0, 32.0), last_pos=(30.0, 31.0))
    state = run_checked(sim, sim.init(), imp, segment=10)
    assert int(state.step) == 25
    h = check_health(state)
    assert h.ok and h.max_speed > 0


@pytest.mark.parametrize("field", ["u", "v", "dye", "pressure"])
@pytest.mark.parametrize("value", [float("nan"), float("inf")])
def test_non_finite_detected(field, value):
    s = _state()
    bad = s._replace(**{field: torch.full_like(getattr(s, field), value)})
    with pytest.raises(HealthError, match="non-finite fields at step 0"):
        check_health(bad)


def test_speed_limit_detected():
    sim = Simulation(_cfg())
    imp = timp.constant_impulse(30, sim.config.dt, pos=(32.0, 32.0), last_pos=(20.0, 28.0))
    with pytest.raises(HealthError, match="blow-up"):
        run_checked(sim, sim.init(), imp, segment=10, max_speed=1.0)


def test_health_equals_jax_and_reports_realized_displacement():
    js = _jax_state(20)
    s = interop.state_from_numpy({k: np.asarray(x) for k, x in js._asdict().items()})
    h, jh = check_health(s), jhealth.check_health(js)
    assert h.finite and jh.finite
    np.testing.assert_allclose(h[1:], jh[1:], rtol=1e-6)
    dt = 1.0 / 60.0
    dx, dy = h.realized_displacement(dt)
    assert dx > 0 and dy > 0
    assert dx == pytest.approx(h.max_abs_u * dt)
    assert h.max_abs_u == float(s.u.abs().max())


def test_displacement_check_matches_jax():
    cases = [(Health(True, 10.0, 1.0, max_abs_u=1200.0, max_abs_v=60.0), 15),
             (Health(True, 10.0, 1.0, max_abs_u=0.0, max_abs_v=1320.0), 15),
             (Health(True, 10.0, 1.0, max_abs_u=0.0, max_abs_v=1320.0), 31)]
    for h, bound in cases:
        for axes in ("y", "xy"):
            exp = jhealth.displacement_check(jhealth.Health(*h), 1.0 / 60.0, bound, axes)
            assert displacement_check(h, 1.0 / 60.0, bound, axes) == exp
    warn = displacement_check(cases[0][0], 1.0 / 60.0, 15, "xy")
    assert "|u|*dt" in warn and "max_displacement=15" in warn and "21" in warn


def test_clamp_axes_matrix():
    # the departure: the port's single-device advection clamps no axis
    assert jhealth.clamp_axes("pallas") == "y"
    assert clamp_axes("cuda") == "" and clamp_axes("ref") == ""
    assert jhealth.clamp_axes("ref") == clamp_axes("ref")
    # the meshes (not yet ported) keep the JAX package's answers
    for backend in ("ref", "cuda"):
        for mesh in ("rows", "2d"):
            assert clamp_axes(backend, mesh) == jhealth.clamp_axes("ref", mesh)


def test_run_displacement_scans_per_step_maxima():
    sim = Simulation(_cfg())
    dt = sim.config.dt
    hot = timp.constant_impulse(10, dt, pos=(32.0, 32.0), last_pos=(24.0, 28.0))
    imp = timp.concat_impulses(hot, timp.no_impulse(30, dt))
    final, (dx, dy) = sim.run_displacement(sim.init(), imp)
    fx, fy = check_health(final).realized_displacement(dt)
    assert dx >= fx and dy >= fy and dx > 0


# -- byte equality of the writers ---------------------------------------------


def _frames(rng, n=3, h=16, w=24):
    return [rng.integers(0, 255, (h, w, 4), dtype=np.uint8) for _ in range(n)]


def test_png_bytes_equal_jax(tmp_path, rng):
    img = _frames(rng, 1, 32, 48)[0]
    assert png.png_bytes(img) == jpng.png_bytes(img)
    png.write_png(str(tmp_path / "a.png"), img)
    assert (tmp_path / "a.png").read_bytes() == jpng.png_bytes(img)
    # a flipped (non-contiguous) view, as Simulation.render returns
    assert png.png_bytes(img[::-1]) == jpng.png_bytes(np.ascontiguousarray(img[::-1]))
    with pytest.raises(ValueError):
        png.png_bytes(img[..., :3])


def test_apng_bytes_equal_jax(tmp_path, rng):
    frames = _frames(rng, 4)
    png.write_apng(str(tmp_path / "p.png"), frames, fps=20)
    jpng.write_apng(str(tmp_path / "j.png"), frames, fps=20)
    assert (tmp_path / "p.png").read_bytes() == (tmp_path / "j.png").read_bytes()


def test_rgb_avi_bytes_equal_jax(tmp_path, rng):
    frames = _frames(rng, 3, 16, 23)  # 23 * 3 bytes pads each row
    assert video.write_avi(str(tmp_path / "p.avi"), frames, fps=20, codec="rgb") == "rgb"
    jvideo.write_avi(str(tmp_path / "j.avi"), frames, fps=20, codec="rgb")
    assert (tmp_path / "p.avi").read_bytes() == (tmp_path / "j.avi").read_bytes()


def test_explicit_mjpeg_fails_fast_without_encoder(tmp_path, monkeypatch):
    monkeypatch.setattr(jpeg, "native_available", lambda: False)
    with pytest.raises(RuntimeError, match="native JPEG encoder"):
        video.AviWriter(str(tmp_path / "x.avi"), 16, 16, codec="mjpeg")
    frames = [np.zeros((16, 16, 4), np.uint8)]
    assert video.write_avi(str(tmp_path / "y.avi"), frames, codec="auto") == "rgb"


def _need_encoder():
    if not (jpeg.native_available() and jjpeg.native_available()):
        pytest.skip("no C++ toolchain to build the native JPEG encoder")


def test_jpeg_bytes_equal_jax(rng):
    _need_encoder()
    h, w = 40, 56
    yy, xx = np.mgrid[0:h, 0:w]
    grad = np.stack([xx * 255 // w, yy * 255 // h, (xx + yy) * 255 // (w + h)], -1)
    for frame in (grad.astype(np.uint8), rng.integers(0, 255, (33, 47, 4), dtype=np.uint8)):
        for quality, threads in ((90, 1), (50, 3), (95, 0)):
            got = jpeg.jpeg_bytes(frame, quality=quality, threads=threads)
            assert got[:2] == b"\xff\xd8" and got[-2:] == b"\xff\xd9"
            assert got == jjpeg.jpeg_bytes(frame, quality=quality, threads=threads)


def test_mjpeg_avi_bytes_equal_jax(tmp_path, rng):
    _need_encoder()
    frames = _frames(rng, 3, 32, 48)
    assert video.write_avi(str(tmp_path / "p.avi"), frames, fps=20, quality=80) == "mjpeg"
    jvideo.write_avi(str(tmp_path / "j.avi"), frames, fps=20, quality=80)
    assert (tmp_path / "p.avi").read_bytes() == (tmp_path / "j.avi").read_bytes()


def test_native_library_builds_into_the_port():
    _need_encoder()
    lib = native_sink.library_path("libjpegenc.so")
    assert lib.parent == native_sink.BUILD and lib.is_file()
    assert lib.name.startswith("libjpegenc-") and lib.suffix == ".so"


# -- report, impulses, stage timer -------------------------------------------


def test_stage_report_format_equals_jax():
    stages = {"Advect": 0.1234, "Pressure+Project": 3.5, "Min frame": 1.0}
    for total in (0.5, 0.0):
        got = StageReport(grid="64x32", steps=7, total_s=total, stage_ms=dict(stages))
        exp = jtiming.StageReport(grid="64x32", steps=7, total_s=total, stage_ms=dict(stages))
        assert got.format() == exp.format()
        assert got.steps_per_sec == exp.steps_per_sec


def test_impulse_from_file_and_concat_equal_jax(tmp_path):
    path = tmp_path / "script.json"
    path.write_text(json.dumps([
        [10.0, 20.0, True],
        [12.0, 21.0, 0],
        {"pos": [14.0, 22.0], "pressed": False, "dt": 0.02},
        {"pos": [15.5, 23.0]},
    ]))
    got, exp = timp.impulse_from_file(str(path), 1 / 60), jimp.impulse_from_file(str(path), 1 / 60)
    both = (timp.concat_impulses(got, timp.no_impulse(2, 0.01)),
            jimp.concat_impulses(exp, jimp.no_impulse(2, 0.01)))
    for g, e in ((got, exp), both):
        for a, b in zip(g, e):
            b = np.asarray(b)
            assert a.numpy().dtype == b.dtype
            np.testing.assert_array_equal(a.numpy(), b)
    np.testing.assert_array_equal(got.last_pos[0].numpy(), [10.0, 20.0])
    path.write_text("[]")
    with pytest.raises(ValueError, match="empty impulse script"):
        timp.impulse_from_file(str(path), 1 / 60)


def test_time_stage_threads_its_carry():
    seen = []

    def body(c):
        seen.append(int(c[0]))
        return (c[0] + 1,)

    sec = time_stage(body, (torch.zeros(()),), n=5, iters=2, warmup=1)
    assert sec >= 0.0
    # three windows (one warm-up), each threading 0..4 from the given carry
    assert seen == list(range(5)) * 3


def test_cuda_times_ms_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        cuda_times_ms(lambda: None)


@pytest.mark.parametrize("variant, kw", [
    ("gpu", {}),
    ("gpu", {"pressure_solver": "multigrid", "mg_tol": 0.05}),
    ("gpu", {"color_diffusion_enabled": False}),
    ("cpu", {}),
], ids=["gpu", "multigrid", "no-color-diffusion", "cpu"])
def test_stage_timings_buckets_equal_jax(variant, kw):
    maker, jmaker = ((FluidConfig.cpu_reference, JConfig.cpu_reference) if variant == "cpu"
                     else (FluidConfig.gpu_reference, JConfig.gpu_reference))
    rep = Simulation(maker(nx=32, ny=32, backend="ref", **kw)).stage_timings(iters=2)
    jrep = JSimulation(jmaker(nx=32, ny=32, backend="ref", **kw)).stage_timings(iters=2)
    assert list(rep.stage_ms) == list(jrep.stage_ms)
    assert all(ms >= 0 for ms in rep.stage_ms.values())
    assert rep.steps == 1 and rep.total_s == pytest.approx(sum(rep.stage_ms.values()) / 1e3)


# -- the decomposed report and the step's inputs -------------------------------


CONFIGS = {
    "gpu": lambda: _cfg(),
    "cpu": lambda: FluidConfig.cpu_reference(nx=64, ny=64, backend="ref"),
    "multigrid": lambda: _cfg(pressure_solver="multigrid", mg_tol=0.05),
}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_run_instrumented_equals_the_plain_rollout(name):
    cfg = CONFIGS[name]()
    sim = Simulation(cfg)
    imp = timp.constant_impulse(4, cfg.dt, pos=(32.0, 32.0), last_pos=(30.0, 31.0))
    state, report = run_instrumented(cfg, sim.init(), imp)
    _assert_states_equal(state, sim.run(sim.init(), imp))
    assert list(report.stage_ms) == ["Advect", "Vorticity", "Diffuse", "Force", "Pressure",
                                     "Project"]
    assert report.steps == 4 and "Advect compute time" in report.format()


def test_advect_both_decomposes_into_advect_billing():
    import types

    base = get_ops(_cfg())
    spans = StageSpans("cpu")
    assert not hasattr(timed_ops(base, spans), "advect_both")
    fused = types.SimpleNamespace(**vars(base))
    fused.advect_both = lambda *a, **k: pytest.fail("the fused op must be decomposed")
    wrapped = timed_ops(fused, spans)
    z = torch.zeros((64, 64))
    dye = torch.rand((3, 64, 64), generator=torch.Generator().manual_seed(0))
    u2, v2, dye2 = wrapped.advect_both(z + 3.0, z, dye, 1 / 60, 1.2)
    assert torch.equal(dye2, base.advect_dye(dye, u2, v2, 1 / 60, 1.2))
    *_, st = wrapped.advect_both(z + 3.0, z, dye, 1 / 60, 1.2, return_stats=True)
    assert st.tolist() == [pytest.approx(3.0 / (1 + 1.2 / 60)), 0.0]
    assert spans.seconds()["Advect"] > 0.0


@pytest.mark.parametrize("name, kw", [
    ("gpu", {}), ("cpu", {}), ("multigrid", {}),
    ("gpu", dict(fast_dye=True, fast_velocity=True, fast_diffuse=True)),
], ids=["gpu", "cpu", "multigrid", "fast-flags"])
def test_a_step_leaves_its_input_unchanged(name, kw):
    import dataclasses

    cfg = dataclasses.replace(CONFIGS[name](), **kw)
    step = make_step(cfg)
    sim = Simulation(cfg)
    state = sim.run(sim.init(), timp.constant_impulse(3, cfg.dt, pos=(32.0, 32.0),
                                                      last_pos=(29.0, 30.0)))
    before = FluidState(*(t.clone() for t in state))
    imp = timp.slice_step(timp.constant_impulse(1, cfg.dt, pos=(20.0, 40.0),
                                                last_pos=(22.0, 38.0)), 0)
    out = step(state, imp)
    _assert_states_equal(state, before)
    for k in ("u", "v", "dye", "pressure", "vel_stats"):
        assert getattr(out, k).data_ptr() != getattr(state, k).data_ptr(), k
