"""The port's frame loop and terminal views against the JAX package's, on
the CPU.

- ``FluidApp`` over 4 frames (``orbit_source``, and ``replay_source`` of a
  script made from a numpy seed) against JAX's ``FluidApp`` with the same
  config: the state within 1e-5 of each field's largest magnitude, each
  frame within 1 of JAX's in uint8 (the render truncates), the same report
  keys.  At the shipped vorticity (50) the confinement's normalised
  gradient magnifies float32 rounding: one step from the same 64² state,
  with 2 diffusion and 2 pressure sweeps, lands ~2e-5 of scale from JAX's
  (with vorticity 0 or 0.5, ~4e-7), and 4 steps ~2e-4.  So the frame loop
  is held at the mild parameters of tests/test_torch_pipeline.py
  (vorticity 0.5, force 500).
- Pipelined frames equal plain ones bit for bit; ``on_frame`` checkpoints;
  an empty script raises; the readback hands the sink
  ``Simulation.frame_image``'s bytes.
- ``frame_to_ansi`` / ``TermViewer`` text equal to JAX's, and ``TermInput``
  fed the byte scripts of tests/test_term_input.py (and a seeded fuzz
  script) with its state and source equal to JAX's after every feed.
"""

import io
import json

import numpy as np
import pytest
import torch

from cudafluidsimulation_tpu import FluidConfig as JConfig
from cudafluidsimulation_tpu.models import app as japp
from cudafluidsimulation_tpu.utils import impulse as jimp
from cudafluidsimulation_tpu.utils import term_input as jterm_input
from cudafluidsimulation_tpu.utils import term_view as jterm_view

from cudafluidsimulation_tpu_torch import FluidConfig, Simulation
from cudafluidsimulation_tpu_torch.models import app
from cudafluidsimulation_tpu_torch.utils import impulse as timp
from cudafluidsimulation_tpu_torch.utils import term_input, term_view
from cudafluidsimulation_tpu_torch.utils.checkpoint import load_state, save_state

torch.set_num_threads(1)

RTOL = 1e-5
FIELDS = ("u", "v", "dye", "pressure")
DT = 1 / 60
CFG = dict(nx=64, ny=64, backend="ref", diffusion_iters=2, pressure_iters=2)
MILD = dict(vorticity=0.5, force_scale=500.0)


def _configs(**kw):
    return JConfig.gpu_reference(**CFG, **kw), FluidConfig.gpu_reference(**CFG, **kw)


def _script(tmp_path, n=6, seed=0):
    """A JSON impulse script from a numpy seed: [x, y, pressed] a step."""
    rng = np.random.default_rng(seed)
    events = [[float(x), float(y), bool(p)] for x, y, p in
              zip(rng.uniform(4, 60, n), rng.uniform(4, 60, n), rng.random(n) < 0.7)]
    path = tmp_path / "script.json"
    path.write_text(json.dumps(events))
    return str(path)


def _assert_state_close(got, exp):
    for k in FIELDS:
        e = np.asarray(getattr(exp, k))
        g = getattr(got, k).numpy()
        scale = max(float(np.abs(e).max()), 1.0)
        np.testing.assert_allclose(g, e, rtol=0, atol=RTOL * scale, err_msg=k)


@pytest.mark.parametrize("source", ["orbit", "replay"])
def test_fluid_app_matches_jax(tmp_path, source):
    jcfg, tcfg = _configs(**MILD)
    if source == "orbit":
        jsrc, tsrc = japp.orbit_source(jcfg), app.orbit_source(tcfg)
    else:
        script = _script(tmp_path)
        jsrc = japp.replay_source(jimp.impulse_from_file(script, DT))
        tsrc = app.replay_source(timp.impulse_from_file(script, DT))
    jframes, tframes = [], []
    jr = japp.FluidApp(jcfg, input_source=jsrc, frame_sink=jframes.append, fixed_dt=DT)
    tr = app.FluidApp(tcfg, input_source=tsrc, frame_sink=tframes.append, fixed_dt=DT)
    jrep, trep = jr.run(max_frames=4), tr.run(max_frames=4)
    assert tr.frames == jr.frames == 4
    _assert_state_close(tr.state, jr.state)
    assert int(tr.state.step) == int(jr.state.step) == 4
    assert len(tframes) == len(jframes) == 4
    for g, e in zip(tframes, jframes):
        assert g.shape == e.shape == (64, 64, 4) and g.dtype == np.uint8
        assert np.abs(g.astype(int) - np.asarray(e).astype(int)).max() <= 1
    assert tframes[-1][..., :3].max() > 0
    assert list(trep.stage_ms) == list(jrep.stage_ms) == ["Min frame", "Max frame"]
    assert (trep.grid, trep.steps) == (jrep.grid, jrep.steps)


def test_sources_equal_jax(tmp_path):
    """The orbit and replay sources give JAX's (pos, last, pressed) for the
    same times, past the script's end too."""
    jcfg, tcfg = _configs()
    script = _script(tmp_path, n=3, seed=1)
    pairs = [(japp.orbit_source(jcfg), app.orbit_source(tcfg)),
             (japp.replay_source(jimp.impulse_from_file(script, DT)),
              app.replay_source(timp.impulse_from_file(script, DT)))]
    for jsrc, tsrc in pairs:
        for t in np.arange(1, 6) * DT:
            assert tsrc(t) == jsrc(t)


def test_pipelined_equals_plain():
    _, cfg = _configs()
    plain, piped = [], []
    a = app.FluidApp(cfg, frame_sink=plain.append, fixed_dt=DT)
    b = app.FluidApp(cfg, frame_sink=piped.append, fixed_dt=DT)
    a.run(max_frames=6)
    rep = b.run(max_frames=6, pipelined=True)
    assert len(plain) == len(piped) == 6  # the drained tail frame included
    for f, g in zip(plain, piped):
        np.testing.assert_array_equal(f, g)
    for k in FIELDS:
        assert torch.equal(getattr(a.state, k), getattr(b.state, k)), k
    assert rep.stage_ms["Max frame"] >= rep.stage_ms["Min frame"] > 0


def test_app_without_sink_equals_the_rollout():
    """The frame loop's state is ``Simulation.run`` over the impulses its
    source gave, bit for bit."""
    _, cfg = _configs()
    seen = []
    orbit = app.orbit_source(cfg)

    def src(t):
        seen.append(orbit(t))
        return seen[-1]

    a = app.FluidApp(cfg, input_source=src, fixed_dt=DT)
    a.run(max_frames=5)
    imp = timp.Impulse(*(torch.stack(f) for f in zip(*(timp.single(p, l, q, DT)
                                                       for p, l, q in seen))))
    sim = Simulation(cfg)
    exp = sim.run(sim.init(), imp)
    for k in FIELDS:
        assert torch.equal(getattr(a.state, k), getattr(exp, k)), k


def test_readback_is_frame_image():
    _, cfg = _configs()
    sim = Simulation(cfg)
    state = sim.run(sim.init(), timp.orbit_impulse(3, DT, (32, 32), 8, omega=3.0))
    frame = sim.render_fn(state)
    image, done = app.queue_readback(frame)
    assert done is None
    got = app.finish_readback((image, done))
    exp = np.moveaxis(frame.numpy(), 0, -1)[::-1]
    np.testing.assert_array_equal(got, exp)
    np.testing.assert_array_equal(sim.render(state), exp)
    assert got.flags["C_CONTIGUOUS"]


def test_on_frame_hook_periodic_checkpoint(tmp_path):
    _, cfg = _configs()
    path = str(tmp_path / "ck.npz")
    seen = []

    def on_frame(state, n):
        seen.append(n)
        if n % 2 == 0:
            save_state(path, state)

    a = app.FluidApp(cfg, fixed_dt=DT)
    a.run(max_frames=5, on_frame=on_frame)
    assert seen == [1, 2, 3, 4, 5]
    assert int(load_state(path, "cpu").step) == 4  # the last periodic save


def test_replay_source_rejects_empty_script():
    with pytest.raises(ValueError, match="empty impulse script"):
        app.replay_source(timp.no_impulse(0, DT))


def test_stop_when_and_seconds():
    _, cfg = _configs()
    a = app.FluidApp(cfg, fixed_dt=DT)
    a.run(max_frames=100, stop_when=lambda: a.frames >= 3)
    assert a.frames == 3
    a.run(seconds=0.0)
    assert a.frames == 3


def test_app_needs_a_card_unless_the_config_asks_for_the_cpu(monkeypatch):
    _, cfg = _configs()
    a = app.FluidApp(cfg, fixed_dt=DT)
    a.run(max_frames=2)
    assert a.state.u.device.type == "cpu" and a.frames == 2
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="ref"):
        app.FluidApp(FluidConfig.gpu_reference(nx=32, ny=32))


def _rgba(h, w, seed):
    return np.random.default_rng(seed).integers(0, 256, (h, w, 4), dtype=np.uint8)


@pytest.mark.parametrize("shape, cols, rows", [((64, 64), 16, 8), ((48, 80), 33, 7),
                                               ((7, 5), 12, 9), ((256, 256), 120, 48)])
def test_frame_to_ansi_equals_jax(shape, cols, rows):
    frame = _rgba(*shape, seed=cols)
    got = term_view.frame_to_ansi(frame, cols, rows)
    assert got == jterm_view.frame_to_ansi(frame, cols, rows)
    assert got.count("\n") == rows - 1


def test_term_viewer_output_equals_jax():
    outs = []
    for mod in (term_view, jterm_view):
        out = io.StringIO()
        viewer = mod.TermViewer(cols=10, rows=6, stream=out)
        for seed in range(3):
            viewer(_rgba(32, 40, seed))
        outs.append(out.getvalue())
    assert outs[0] == outs[1]
    assert "\x1b[6F" in outs[0]  # repainted in place after the first frame


def _fuzz_script(seed=0, n=60):
    """Feeds of escape fragments, keys and raw bytes from a numpy seed."""
    rng = np.random.default_rng(seed)
    pieces = [b"\x1b", b"[", b"<", b"0;", b"32;", b"17;", b"8", b"M", b"m", b"\x1b[<0;10;5M",
              b"\x1b[M", bytes([32, 81 + 32, 40]), b"\x1bO", b"A", b"B", b"w", b"a", b"s",
              b"d", b" ", b"q", b"\x03", b"\x1b[1;5D", b"x", b"\x1b[<64;1;1M"]
    feeds = []
    for _ in range(n):
        k = int(rng.integers(1, 4))
        feeds.append(b"".join(pieces[int(i)] for i in rng.integers(0, len(pieces), k)))
    return feeds


TERM_SCRIPTS = {
    "sgr_press_drag_release": [b"\x1b[<0;32;8M", b"\x1b[<32;33;8M", b"\x1b[<0;33;8m"],
    "viewer_corners": [b"\x1b[<0;1;1M", b"\x1b[<0;64;16M"],
    "keys_toggle_quit": [b"d", b"\x1b[A", b" ", b" ", b"q"],
    "split_escape": [b"\x1b[<0;10", b";10M"],
    "scroll_wheel": [b"\x1b[<64;5;5M"],
    "source_tracks_last": [b"dd", b"w"],
    "clamped": [b"a" * 500, b"\x1b[B" * 500],
    "unknown_csi": [b"\x1b[1;5D", b"\x1b[0q", b"\x1b[6n", b"q"],
    "x10": [b"\x1b[M" + bytes([32, 113, 40]), b"\x1b[M" + bytes([35, 113, 40]),
            b"\x1b[M" + bytes([32]), bytes([72, 40])],
    "ss3_alt": [b"\x1bOA", b"\x1bq"],
    "unterminated_sgr": [b"\x1b[<" + b"1;" * 20, b"q", b"\x1b[<0;10;10M"],
    "fuzz": _fuzz_script(),
}


@pytest.mark.parametrize("name", list(TERM_SCRIPTS))
def test_term_input_equals_jax(name):
    """After every feed of a script: the same cursor, press, quit flag and
    buffered bytes as JAX's TermInput, and the same source output."""
    got, exp = term_input.TermInput(128, 64, 64, 16), jterm_input.TermInput(128, 64, 64, 16)
    gsrc, esrc = got.source(), exp.source()
    assert gsrc(0.0) == esrc(0.0)
    for i, data in enumerate(TERM_SCRIPTS[name]):
        got.feed(data)
        exp.feed(data)
        assert (got.pos, got.pressed, got.quit, got._buf) == \
            (exp.pos, exp.pressed, exp.quit, exp._buf), (name, i)
        assert gsrc(0.1 * (i + 1)) == esrc(0.1 * (i + 1))
        if got.quit:  # a quit keeps its flag; clear it as the JAX tests do
            got.quit = exp.quit = False


def test_term_input_steers_the_app():
    """A scripted press drives the frame loop; dye lands at the cursor and
    the quit key stops the loop before any further frame."""
    _, cfg = _configs()
    t = term_input.TermInput(64, 64, 32, 16)
    t.feed(b"\x1b[<0;16;8M")  # press near the middle
    a = app.FluidApp(cfg, input_source=t.source(), fixed_dt=DT)
    a.run(max_frames=5, stop_when=lambda: t.quit)
    x, y = t.pos
    dye = a.state.dye.numpy()
    assert dye.max() > 0.1
    assert dye[:, int(y) - 3:int(y) + 4, int(x) - 3:int(x) + 4].max() == dye.max()
    t.feed(b"q")
    a.run(max_frames=50, stop_when=lambda: t.quit)
    assert a.frames == 5
