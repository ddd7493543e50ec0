"""The port's CLI ``--view`` on the CPU, against the JAX package's CLI.

- ``--view term`` with ``--impulse-file``, with ``--impulse orbit
  --video`` and ``--view http --interactive`` (a client holding a press)
  give ``--save-fields`` within 1e-5 of each field's largest magnitude of
  the JAX CLI's with the same flags.  The CLI runs the shipped
  gpu-reference parameters, whose confinement magnifies float32 rounding
  (vorticity 50, tests/test_torch_views.py): at 64² the orbit source lands
  1.7e-5 of scale from JAX by its third frame, the held press 1.1e-5 at its
  fourth.  So the video run takes the centre impulse over 4 frames (as
  tests/test_torch_cli.py), the held press 3 frames, the script 4; the
  orbit source is held against JAX's at mild parameters in
  tests/test_torch_views.py.
- The frame loop's state equals ``FluidApp``'s over the same source bit for
  bit, pipelined or not; ``--video`` holds one frame a frame;
  ``--checkpoint-every`` saves through ``on_frame``; a press then ``q``
  from a client ends an unbounded ``--view http --interactive`` session.
- The notes for the flags the view ignores; ``--mesh`` with ``--view`` is
  a note, without it an exit; without a card ``--view`` exits naming
  ``--backend ref``.
"""

import json
import struct
import threading
import urllib.request

import numpy as np
import pytest
import torch

from cudafluidsimulation_tpu import cli as jcli
from cudafluidsimulation_tpu.utils import http_view as jhttp_view

from cudafluidsimulation_tpu_torch import FluidConfig, cli
from cudafluidsimulation_tpu_torch.models.app import FluidApp, orbit_source
from cudafluidsimulation_tpu_torch.utils import http_view
from cudafluidsimulation_tpu_torch.utils.checkpoint import load_state, prev_path

torch.set_num_threads(1)

RTOL = 1e-5
FIELDS = ("u", "v", "dye", "pressure")
BASE = ["--grid", "64", "--backend", "ref"]
LIGHT = ["--diffusion-iters", "2", "--pressure-iters", "2"]


def _fields(path):
    with np.load(path) as d:
        return {k: d[k] for k in FIELDS}


def _assert_close_to_jax(got_path, exp_path):
    got, exp = _fields(got_path), _fields(exp_path)
    for k in FIELDS:
        scale = max(float(np.abs(exp[k]).max()), 1.0)
        np.testing.assert_allclose(got[k], exp[k], rtol=0, atol=RTOL * scale, err_msg=k)
    assert np.abs(got["dye"]).max() > 0


def _both(tmp_path, argv):
    """The JAX CLI and the port's with ``argv`` and their own
    ``--save-fields``."""
    assert jcli.main(argv + ["--save-fields", str(tmp_path / "jax.npz")]) == 0
    assert cli.main(argv + ["--save-fields", str(tmp_path / "port.npz")]) == 0
    return tmp_path / "port.npz", tmp_path / "jax.npz"


def _avi_frames(path):
    data = path.read_bytes()
    avih = data.index(b"avih") + 8
    return struct.unpack("<14I", data[avih:avih + 56])[4]


def test_view_term_impulse_file_matches_jax(tmp_path):
    rng = np.random.default_rng(0)
    events = [[float(x), float(y), bool(p)] for x, y, p in
              zip(rng.uniform(8, 56, 4), rng.uniform(8, 56, 4), [True, True, False, True])]
    script = tmp_path / "s.json"
    script.write_text(json.dumps(events))
    port, jax = _both(tmp_path, BASE + ["--view", "term", "--impulse-file", str(script),
                                        "--steps", "99"])
    _assert_close_to_jax(port, jax)


def test_view_term_video_matches_jax(tmp_path, capsys):
    argv = BASE + ["--view", "term", "--impulse", "center", "--steps", "4",
                   "--video-codec", "rgb"]
    assert jcli.main(argv + ["--video", str(tmp_path / "jax.avi"),
                             "--save-fields", str(tmp_path / "jax.npz")]) == 0
    assert cli.main(argv + ["--video", str(tmp_path / "port.avi"),
                            "--save-fields", str(tmp_path / "port.npz")]) == 0
    _assert_close_to_jax(tmp_path / "port.npz", tmp_path / "jax.npz")
    assert _avi_frames(tmp_path / "port.avi") == _avi_frames(tmp_path / "jax.avi") == 4
    out = capsys.readouterr().out
    assert "recorded 4-frame RGB AVI of the session" in out
    assert "\x1b[38;2;" in out  # the terminal view painted


def _get(url):
    with urllib.request.urlopen(url, timeout=5) as r:
        return r.status


def _pressing(base):
    """``base`` (an HttpViewer class) that, once open, holds a press at
    image (20, 40) as the page's keepalive does (~30 Hz), from before the
    loop's first frame until it closes."""

    class Pressing(base):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.press = "input?x=20&y=40&p=1"
            _get(self.url + self.press)
            self._stop = threading.Event()
            self._keep = threading.Thread(target=self._keepalive, daemon=True)
            self._keep.start()

        def _keepalive(self):
            while not self._stop.wait(0.02):
                _get(self.url + self.press)

        def close(self):
            self._stop.set()
            self._keep.join(timeout=5)
            super().close()

    return Pressing


def test_view_http_interactive_matches_jax(tmp_path, monkeypatch):
    monkeypatch.setattr(jhttp_view, "HttpViewer", _pressing(jhttp_view.HttpViewer))
    monkeypatch.setattr(http_view, "HttpViewer", _pressing(http_view.HttpViewer))
    port, jax = _both(tmp_path, BASE + ["--view", "http", "--interactive", "--steps", "3"])
    _assert_close_to_jax(port, jax)
    dye = _fields(port)["dye"]
    assert dye[:, 20:27, 17:24].max() == dye.max()  # under the press: grid (20, 23)


def test_view_http_press_then_quit(tmp_path, monkeypatch, capsys):
    """An unbounded session (``--steps 0`` under a cap here) ends on the
    client's q; the state reaches --save-fields and --checkpoint."""
    viewers = []

    class Recorded(http_view.HttpViewer):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            viewers.append(self)
            self.bound = self.port

    monkeypatch.setattr(http_view, "HttpViewer", Recorded)
    done = threading.Event()

    def client():
        # wait for the server, press, let 3 frames arrive (the second
        # polled its input after the press), then quit
        while not viewers:
            if done.wait(0.01):
                return
        hv = viewers[0]
        _get(hv.url + "input?x=32&y=32&p=1")
        pressed_at = hv.frames
        while hv.frames < pressed_at + 3 and not done.wait(0.005):
            pass
        _get(hv.url + "input?x=32&y=32&p=0&q=1")

    t = threading.Thread(target=client, daemon=True)
    t.start()
    out = tmp_path / "f.npz"
    try:
        assert cli.main(BASE + LIGHT + ["--view", "http", "--interactive", "--steps", "2000",
                                        "--save-fields", str(out),
                                        "--checkpoint", str(tmp_path / "c.npz")]) == 0
    finally:
        done.set()
        t.join(timeout=10)
    text = capsys.readouterr().out
    assert f"live view: http://localhost:{viewers[0].bound}/" in text
    steps = int(load_state(str(tmp_path / "c.npz"), "cpu").step)
    assert 3 <= steps < 2000
    assert f"Steps: {steps}" in text
    assert np.abs(_fields(out)["dye"]).max() > 0


@pytest.mark.parametrize("pipelined", [False, True], ids=["plain", "pipelined"])
def test_view_state_equals_the_frame_loop(tmp_path, pipelined):
    out = tmp_path / "f.npz"
    assert cli.main(BASE + LIGHT + ["--view", "term", "--impulse", "orbit", "--steps", "5",
                                    "--save-fields", str(out)]
                    + (["--pipelined"] if pipelined else [])) == 0
    cfg = FluidConfig.gpu_reference(nx=64, ny=64, backend="ref", diffusion_iters=2,
                                    pressure_iters=2)
    app = FluidApp(cfg, input_source=orbit_source(cfg), fixed_dt=1 / 60)
    app.run(max_frames=5)
    got = _fields(out)
    for k in FIELDS:
        np.testing.assert_array_equal(got[k], getattr(app.state, k).numpy(), err_msg=k)


@pytest.mark.parametrize("impulse", ["center", "none"])
def test_view_impulse_sources(tmp_path, impulse):
    out = tmp_path / "f.npz"
    assert cli.main(BASE + LIGHT + ["--view", "term", "--impulse", impulse, "--steps", "3",
                                    "--save-fields", str(out)]) == 0
    dye = np.abs(_fields(out)["dye"]).max()
    assert (dye > 0) == (impulse == "center")


def test_view_checkpoint_every(tmp_path):
    ck = tmp_path / "c.npz"
    assert cli.main(BASE + LIGHT + ["--view", "term", "--steps", "5", "--checkpoint", str(ck),
                                    "--checkpoint-every", "2"]) == 0
    # periodic saves after frames 2 and 4, then the final save rotates 4 away
    assert int(load_state(str(ck), "cpu").step) == 5
    assert int(load_state(prev_path(str(ck)), "cpu").step) == 4


def test_view_term_interactive_without_a_tty(tmp_path):
    """Without a terminal no input arrives: the session runs its frames."""
    out = tmp_path / "f.npz"
    assert cli.main(BASE + LIGHT + ["--view", "term", "--interactive", "--steps", "3",
                                    "--save-fields", str(out)]) == 0
    assert np.abs(_fields(out)["dye"]).max() == 0  # never pressed


def test_view_notes_for_ignored_flags(tmp_path, capsys):
    assert cli.main(BASE + LIGHT + ["--view", "term", "--steps", "1", "--mesh", "rows",
                                    "--frames-dir", str(tmp_path / "fr"), "--apng",
                                    str(tmp_path / "a.png"), "--health",
                                    "--checkpoint-every", "3"]) == 0
    out = capsys.readouterr().out
    for note in ["--mesh is ignored with --view term",
                 "--frames-dir is ignored with --view term",
                 "--apng is ignored with --view term",
                 "--health is ignored with --view term",
                 "--checkpoint-every needs --checkpoint; ignored"]:
        assert f"note: {note}" in out
    assert not (tmp_path / "fr").exists() and not (tmp_path / "a.png").exists()


@pytest.mark.parametrize("view", ["term", "http"])
def test_view_without_a_card_exits_naming_backend_ref(monkeypatch, view):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="pass --backend ref"):
        cli.main(["--grid", "64", "--steps", "2", "--view", view])
