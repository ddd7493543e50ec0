"""The port's HTTP live view against the JAX package's, on the CPU.

Both servers (the native one, ``native/httpview.cpp`` built into the
port's build directory, and the Python ``http.server`` fallback) on an
ephemeral port: the canonical page, ``/frame`` (PNG on both; 503 before
any push; its bytes equal the JAX server's for the same frame), ``/stream``
(JPEG parts from the native server, PNG from the fallback), ``/input`` and
its quit flag, the lazy open on the first push, the stale press released,
and ``input_source``'s mapping equal to JAX's for the same requests.
"""

import http.client
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from cudafluidsimulation_tpu.utils import http_view as jhttp_view

from cudafluidsimulation_tpu_torch import FluidConfig
from cudafluidsimulation_tpu_torch.models.app import FluidApp
from cudafluidsimulation_tpu_torch.utils import http_view, native_sink
from cudafluidsimulation_tpu_torch.utils.png import png_bytes

torch.set_num_threads(1)

BACKENDS = pytest.mark.parametrize("force_python", [False, True], ids=["native", "python"])


def _frame(h=16, w=24, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (h, w, 4), dtype=np.uint8)


def _get(url, timeout=5):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return r.status, r.headers, r.read()


def _need(force_python, *mods):
    if not force_python and not all(m.native_available() for m in mods):
        pytest.skip("no C++ toolchain to build the native HTTP server")


def _decode_png_rgba(data, h, w):
    import zlib

    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    idat = data.index(b"IDAT") + 4
    n = int.from_bytes(data[idat - 8:idat - 4], "big")
    rows = np.frombuffer(zlib.decompress(data[idat:idat + n]), np.uint8).reshape(h, 1 + w * 4)
    assert (rows[:, 0] == 0).all()
    return rows[:, 1:].reshape(h, w, 4)


def test_page_equals_jax():
    assert http_view.PAGE_HTML == jhttp_view.PAGE_HTML


def test_native_server_builds_into_the_port():
    assert http_view.native_available(), "native httpview failed to build/load"
    lib = native_sink.library_path("libhttpview.so")
    assert lib.parent == native_sink.BUILD and lib.is_file()


@BACKENDS
def test_page_frame_and_stream(force_python):
    _need(force_python, http_view)
    with http_view.HttpViewer(width=24, height=16, force_python=force_python) as hv:
        assert hv.port > 0 and hv.url == f"http://localhost:{hv.port}/"
        assert hv.urls == [hv.url]  # loopback bind: localhost alone
        status, _, body = _get(hv.url)
        assert status == 200 and body == http_view.PAGE_HTML
        with pytest.raises(urllib.error.HTTPError) as exc:
            _get(hv.url + "frame")
        assert exc.value.code == 503  # nothing pushed yet

        hv.push(_frame())
        last = _frame(seed=1)
        hv.push(last)
        assert hv.frames == 2
        status, headers, png = _get(hv.url + "frame")
        assert status == 200 and headers["Content-Type"] == "image/png"
        np.testing.assert_array_equal(_decode_png_rgba(png, 16, 24), last)
        if force_python:
            assert png == png_bytes(last)

        conn = http.client.HTTPConnection("localhost", hv.port, timeout=5)
        conn.request("GET", "/stream")
        resp = conn.getresponse()
        assert resp.status == 200
        assert "multipart/x-mixed-replace" in resp.headers["Content-Type"]
        hv.push(_frame(seed=2))  # a part after the connect
        chunk = resp.fp.read(512)
        want = b"image/png" if force_python else b"image/jpeg"
        assert b"--frame" in chunk and want in chunk
        body = chunk[chunk.index(b"\r\n\r\n") + 4:]
        assert body[:2] == (b"\x89P" if force_python else b"\xff\xd8")  # PNG / JPEG SOI
        conn.close()


@BACKENDS
def test_frame_bytes_equal_jax(force_python):
    _need(force_python, http_view, jhttp_view)
    frame = _frame(32, 40, seed=3)
    served = []
    for mod in (http_view, jhttp_view):
        with mod.HttpViewer(width=40, height=32, force_python=force_python) as hv:
            hv.push(frame)
            served.append(_get(hv.url + "frame")[2])
    assert served[0] == served[1]


@BACKENDS
def test_input_route_and_quit(force_python):
    _need(force_python, http_view)
    with http_view.HttpViewer(width=24, height=16, force_python=force_python) as hv:
        assert hv.poll_input() == (0, 0.0, 0.0, 0)
        assert not hv.quit_requested
        _get(hv.url + "input?x=10.5&y=3.25&p=1")
        seq, x, y, p = hv.poll_input()
        assert (seq, p) == (1, 1)
        assert x == pytest.approx(10.5) and y == pytest.approx(3.25)
        _get(hv.url + "input?q=1")  # quit without a position: seq stays
        assert hv.quit_requested and hv.poll_input()[0] == 1


INPUTS = ["input?x=10.5&y=3.25&p=1", "input?x=999&y=-5&p=0", "input?x=0.25&y=15&p=1",
          "input?p=1", "input?x=7&y=7", "input?x=3&y=4&p=0&q=1"]


@BACKENDS
def test_input_source_equals_jax(force_python):
    """The same /input requests to the port's and JAX's viewers: the same
    (pos, last, pressed) from both sources after each."""
    _need(force_python, http_view, jhttp_view)
    with http_view.HttpViewer(width=24, height=16, force_python=force_python) as got, \
            jhttp_view.HttpViewer(width=24, height=16, force_python=force_python) as exp:
        gsrc, esrc = got.input_source(24, 16), exp.input_source(24, 16)
        assert gsrc(0.0) == esrc(0.0) == ((12.0, 8.0), (12.0, 8.0), False)
        for i, req in enumerate(INPUTS):
            _get(got.url + req)
            _get(exp.url + req)
            g, e = gsrc(0.1 * (i + 1)), esrc(0.1 * (i + 1))
            np.testing.assert_allclose(np.array(g[:2]), np.array(e[:2]), rtol=0, atol=0)
            assert g[2] == e[2]
        assert got.quit_requested and exp.quit_requested


@BACKENDS
def test_input_source_releases_stale_press(force_python):
    _need(force_python, http_view)
    with http_view.HttpViewer(width=24, height=16, force_python=force_python) as hv:
        src = hv.input_source(24, 16, press_timeout=0.05)
        _get(hv.url + "input?x=5&y=5&p=1")
        assert src(0.0)[2]
        time.sleep(0.12)  # no keepalive arrives
        assert not src(0.1)[2]
        _get(hv.url + "input?x=6&y=5&p=1")  # a fresh press re-arms it
        assert src(0.2)[2]


@BACKENDS
def test_push_before_dimensions_opens_lazily(force_python):
    _need(force_python, http_view)
    hv = http_view.HttpViewer(force_python=force_python)
    try:
        assert hv.port == 0 and hv.frames == 0
        hv.push(_frame())
        assert hv.port > 0
        status, _, png = _get(hv.url + "frame")
        assert status == 200 and png[:8] == b"\x89PNG\r\n\x1a\n"
        with pytest.raises(ValueError, match="viewer is 24x16"):
            hv.push(_frame(8, 8))
        with pytest.raises(ValueError, match="expected"):
            hv.push(np.zeros((16, 24, 3), np.uint8))
    finally:
        hv.close()


def test_native_close_with_connected_stream_client():
    """close() must not hang while a stream client is connected."""
    _need(False, http_view)
    hv = http_view.HttpViewer(width=8, height=8)
    hv.push(_frame(8, 8))
    conn = http.client.HTTPConnection("localhost", hv.port, timeout=5)
    conn.request("GET", "/stream")
    assert conn.getresponse().status == 200
    t = threading.Thread(target=hv.close)
    t.start()
    t.join(timeout=10)
    assert not t.is_alive(), "hv_close hung with a connected client"
    conn.close()


@BACKENDS
def test_interactive_app_via_http_input(force_python):
    """Input posted to the server steers the frame loop (the CLI's --view
    http --interactive wiring): the splat lands under the press, and q
    stops the loop before any further frame."""
    _need(force_python, http_view)
    cfg = FluidConfig.gpu_reference(nx=64, ny=64, backend="ref", diffusion_iters=2,
                                    pressure_iters=2, force_scale=500.0, vorticity=0.5)
    with http_view.HttpViewer(width=64, height=64, force_python=force_python) as hv:
        _get(hv.url + "input?x=20&y=40&p=1")  # image row 40 = grid y 23
        app = FluidApp(cfg, input_source=hv.input_source(64, 64), frame_sink=hv,
                       fixed_dt=1 / 60)
        app.run(max_frames=4, stop_when=lambda: hv.quit_requested)
        assert app.frames == 4 and hv.frames == 4
        dye = app.state.dye.numpy()
        assert np.isfinite(dye).all()
        assert dye[:, 20:27, 17:24].max() == dye.max() > 0  # around (20, 23)
        _get(hv.url + "input?x=0&y=0&p=0&q=1")
        app.run(max_frames=100, stop_when=lambda: hv.quit_requested)
        assert app.frames == 4
