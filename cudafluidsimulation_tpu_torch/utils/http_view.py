"""Live browser viewer: HTTP multipart-PNG streaming.

The reference displays the fluid in an OpenGL window (Main.cpp:166-180);
headless GPU hosts have no display, so this serves the live view to a
browser as a ``multipart/x-mixed-replace`` stream (the MJPEG idiom).
The server binds 127.0.0.1 by default — the ``/input`` route accepts
impulses and a quit request, so exposing it to the network
(``host="0.0.0.0"`` / CLI ``--http-host 0.0.0.0``) is deliberately opt-in.  Push is a frame copy; PNG encoding happens lazily in the
viewer's connection thread (cached per frame), so the simulation thread
never pays for encoding — with no viewer attached a push costs one memcpy.
The native backend is native/httpview.cpp (built by ``utils.native_sink``
into the port's build directory, like the frame sink) and serves JPEG; a
pure Python ``http.server`` fallback serves PNG and keeps the feature
available without a toolchain.  ``PAGE_HTML`` and both servers' routes are
the JAX package's.

The served page also captures pointer drags and posts them back to
``/input`` — ``poll_input()`` / ``input_source(nx, ny)`` turn that into a
live FluidApp input source (the reference's mouse capture, Main.cpp:213-243,
browser edition; CLI ``--view http --interactive``).

Usage: CLI ``--view http [--http-port N] [--interactive]``, or::

    with HttpViewer(width=512, height=512) as hv:
        print(hv.url)          # e.g. http://localhost:40123/
        hv.push(frame)         # (H, W, 4) uint8, as often as you like
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional

import numpy as np

from cudafluidsimulation_tpu_torch.utils.native_sink import load_native_lib

# The ONE canonical "/" page, served by BOTH server backends (pushed into
# the native server via hv_set_page): live stream <img> + pointer-capture
# JS that posts drags back to /input (image pixel coords; q quits) — the
# reference's mouse capture (Main.cpp:213-243), browser edition.
PAGE_HTML = (
    b"<!doctype html><html><head><title>tpu-stable-fluids</title>"
    b"<style>body{background:#111;color:#ddd;font-family:monospace;"
    b"text-align:center}img{image-rendering:pixelated;margin-top:1em;"
    b"max-width:96vw;max-height:88vh;touch-action:none;cursor:crosshair}"
    b"</style></head><body>"
    b"<div>tpu-stable-fluids &mdash; live "
    b"(drag to splat &middot; q quits)</div>"
    b"<img id='v' src='/stream' alt='live stream' draggable='false'>"
    b"<script>"
    b"var img=document.getElementById('v'),down=false,px=0,py=0;"
    b"function upd(e){var r=img.getBoundingClientRect();"
    b"px=(e.clientX-r.left)*(img.naturalWidth||r.width)/r.width;"
    b"py=(e.clientY-r.top)*(img.naturalHeight||r.height)/r.height;}"
    b"function send(p,q){fetch('/input?x='+px.toFixed(2)+'&y='+"
    b"py.toFixed(2)+'&p='+p+(q?'&q=1':''));}"
    b"img.addEventListener('pointerdown',function(e){down=true;"
    b"img.setPointerCapture(e.pointerId);upd(e);send(1,0);"
    b"e.preventDefault();});"
    b"img.addEventListener('pointermove',function(e){"
    b"if(down)upd(e);});"
    b"window.addEventListener('pointerup',function(e){if(down){"
    b"down=false;upd(e);send(0,0);}});"
    b"setInterval(function(){if(down)send(1,0);},33);"  # hold keepalive
    b"window.addEventListener('keydown',function(e){"
    b"if(e.key==='q')send(0,1);});"
    b"</script></body></html>")


def _bind(lib: ctypes.CDLL) -> None:
    lib.hv_open.restype = ctypes.c_void_p
    lib.hv_open.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                            ctypes.c_char_p]
    lib.hv_port.restype = ctypes.c_int
    lib.hv_port.argtypes = [ctypes.c_void_p]
    lib.hv_push.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.hv_set_page.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.hv_input.restype = ctypes.c_uint64
    lib.hv_input.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int),
    ]
    lib.hv_quit.restype = ctypes.c_int
    lib.hv_quit.argtypes = [ctypes.c_void_p]
    lib.hv_clients.restype = ctypes.c_int
    lib.hv_clients.argtypes = [ctypes.c_void_p]
    lib.hv_frames.restype = ctypes.c_uint64
    lib.hv_frames.argtypes = [ctypes.c_void_p]
    lib.hv_close.argtypes = [ctypes.c_void_p]


def _load() -> Optional[ctypes.CDLL]:
    return load_native_lib("libhttpview.so", _bind)


def native_available() -> bool:
    return _load() is not None


class _PyHttpView:
    """http.server fallback with the same routes and semantics as the
    native server: push is a copy, PNG encoding happens lazily in the
    client's handler thread (cached per frame), stream handlers observe a
    closing flag so close() leaks no threads."""

    def __init__(self, port: int, width: int, height: int,
                 host: str = "127.0.0.1"):
        import http.server
        import socketserver

        from cudafluidsimulation_tpu_torch.utils.png import png_bytes

        view = self
        view._raw = None
        view._seq = 0
        view._png = b""
        view._png_seq = 0
        view._closing = False
        view._cond = threading.Condition()
        view._png_bytes = png_bytes
        view._clients = 0
        view._frames = 0
        view._input = (0.0, 0.0, 0)  # x, y, pressed (image pixel coords)
        view._input_seq = 0
        view._quit = False

        page = PAGE_HTML  # ONE canonical page for both backends

        def latest_png():
            """Encode-on-demand with a per-seq cache (see native server)."""
            with view._cond:
                if view._raw is None:
                    return b"", 0
                if view._png_seq == view._seq:
                    return view._png, view._png_seq
                raw, s = view._raw, view._seq
            data = view._png_bytes(raw)
            with view._cond:
                if s >= view._png_seq:
                    view._png, view._png_seq = data, s
            return data, s

        class Handler(http.server.BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def do_GET(self):
                if self.path == "/":
                    self.send_response(200)
                    self.send_header("Content-Type", "text/html")
                    self.send_header("Content-Length", str(len(page)))
                    self.end_headers()
                    self.wfile.write(page)
                elif self.path.startswith("/input") and (
                        len(self.path) == 6 or self.path[6] == "?"):
                    import urllib.parse

                    q = urllib.parse.parse_qs(
                        urllib.parse.urlsplit(self.path).query)

                    def val(k, default=None):
                        try:
                            return float(q[k][0])
                        except (KeyError, ValueError, IndexError):
                            return default

                    with view._cond:
                        x, y = val("x"), val("y")
                        if x is not None and y is not None:
                            view._input = (x, y,
                                           1 if val("p", 0.0) else 0)
                            view._input_seq += 1
                        if val("q", 0.0):
                            view._quit = True
                    self.send_response(204)
                    self.end_headers()
                elif self.path == "/frame":
                    data, _ = latest_png()
                    self.send_response(200 if data else 503)
                    self.send_header("Content-Type", "image/png")
                    self.send_header("Content-Length", str(len(data)))
                    self.end_headers()
                    self.wfile.write(data)
                elif self.path == "/stream":
                    self.send_response(200)
                    self.send_header(
                        "Content-Type",
                        "multipart/x-mixed-replace; boundary=frame")
                    self.end_headers()
                    with view._cond:
                        view._clients += 1
                    last = 0
                    try:
                        while True:
                            with view._cond:
                                view._cond.wait_for(
                                    lambda: view._closing or view._seq > last,
                                    timeout=0.25)
                                if view._closing:
                                    break
                                if view._seq == last:
                                    continue
                            data, last = latest_png()
                            if not data:
                                continue
                            self.wfile.write(
                                b"--frame\r\nContent-Type: image/png\r\n"
                                + f"Content-Length: {len(data)}\r\n\r\n".encode()
                                + data + b"\r\n")
                    except (BrokenPipeError, ConnectionResetError):
                        pass
                    finally:
                        with view._cond:
                            view._clients -= 1
                else:
                    self.send_error(404)

        class Server(socketserver.ThreadingMixIn, http.server.HTTPServer):
            daemon_threads = True

        self._srv = Server((host, port), Handler)
        self.port = self._srv.server_address[1]
        self._thread = threading.Thread(target=self._srv.serve_forever,
                                        daemon=True)
        self._thread.start()

    @property
    def clients(self) -> int:
        with self._cond:
            return self._clients

    @property
    def frames(self) -> int:
        with self._cond:
            return self._frames

    def poll_input(self):
        with self._cond:
            x, y, p = self._input
            return self._input_seq, x, y, p

    @property
    def quit_requested(self) -> bool:
        with self._cond:
            return self._quit

    def push(self, frame: np.ndarray) -> None:
        raw = np.ascontiguousarray(frame, dtype=np.uint8).copy()
        with self._cond:
            self._raw = raw
            self._seq += 1
            self._frames += 1
            self._cond.notify_all()

    def close(self) -> None:
        with self._cond:
            self._closing = True
            self._cond.notify_all()
        self._srv.shutdown()
        self._srv.server_close()


class HttpViewer:
    """Frame sink that serves a live multipart-PNG stream over HTTP.

    ``port=0`` binds an ephemeral port (read ``.port``/``.url``).  Pushing
    never blocks on viewers; slow clients skip frames (latest-wins).

    ``host`` defaults to loopback; pass ``"0.0.0.0"`` to accept remote
    browsers (opt-in: ``/input`` steers and can quit the session)."""

    def __init__(self, port: int = 0, width: int = 0, height: int = 0,
                 force_python: bool = False, host: str = "127.0.0.1"):
        self._w, self._h = width, height
        self._host = host
        self._lib = None if force_python else _load()
        self._handle = None
        self._py = None
        if self._lib is not None and width and height:
            self._open_native(port)
        elif width and height:
            self._py = _PyHttpView(port, width, height, host=host)
        self._want_port = port

    def _open_native(self, port: int) -> None:
        self._handle = ctypes.c_void_p(
            self._lib.hv_open(port, self._w, self._h,
                              self._host.encode("ascii")))
        if self._lib.hv_port(self._handle) == 0:
            self._lib.hv_close(self._handle)  # bind failed
            self._handle = None
            self._py = _PyHttpView(port, self._w, self._h, host=self._host)
        else:
            self._lib.hv_set_page(self._handle, PAGE_HTML)

    @property
    def port(self) -> int:
        if self._handle is not None:
            return int(self._lib.hv_port(self._handle))
        return self._py.port if self._py is not None else 0

    @property
    def url(self) -> str:
        return f"http://localhost:{self.port}/"

    @property
    def urls(self) -> list:
        """All likely-reachable URLs: just localhost on the (default)
        loopback bind; plus this host's addresses when bound wider."""
        import socket

        hosts = ["localhost"]
        if self._host not in ("127.0.0.1", "localhost", "::1"):
            try:
                hosts.append(socket.gethostbyname(socket.gethostname()))
            except OSError:
                pass
        return [f"http://{h}:{self.port}/" for h in dict.fromkeys(hosts)]

    @property
    def clients(self) -> int:
        if self._handle is not None:
            return int(self._lib.hv_clients(self._handle))
        return self._py.clients if self._py is not None else 0

    @property
    def frames(self) -> int:
        if self._handle is not None:
            return int(self._lib.hv_frames(self._handle))
        return self._py.frames if self._py is not None else 0

    def poll_input(self):
        """Latest browser pointer state as ``(seq, x, y, pressed)``.

        ``seq`` is 0 until any ``/input`` request arrives; ``x``/``y`` are
        image pixel coordinates (origin top-left) as sent by the page's
        pointer-capture script."""
        if self._handle is not None:
            x = ctypes.c_float()
            y = ctypes.c_float()
            p = ctypes.c_int()
            seq = self._lib.hv_input(self._handle, ctypes.byref(x),
                                     ctypes.byref(y), ctypes.byref(p))
            return int(seq), float(x.value), float(y.value), int(p.value)
        if self._py is not None:
            return self._py.poll_input()
        return 0, 0.0, 0.0, 0

    @property
    def quit_requested(self) -> bool:
        """True once a viewer pressed ``q`` (sent as ``/input?...&q=1``)."""
        if self._handle is not None:
            return bool(self._lib.hv_quit(self._handle))
        return self._py.quit_requested if self._py is not None else False

    def input_source(self, nx: int, ny: int, press_timeout: float = 0.75):
        """An ``InputSource`` for :class:`~..models.app.FluidApp`: polls the
        latest browser pointer state each frame and maps image pixels to
        grid coordinates (the frame image is y-flipped: row 0 is the grid's
        top row, see Simulation.frame_image).  The reference's mouse capture
        (Main.cpp:213-243), browser edition.

        The page posts keepalive presses at ~30 Hz while dragging, so a
        press whose seq has not advanced for ``press_timeout`` seconds means
        the browser went away mid-drag (closed tab, lost network) — treat it
        as released rather than splatting at the stale position forever."""
        import time as _time

        state = {"pos": (nx / 2.0, ny / 2.0), "last": (nx / 2.0, ny / 2.0),
                 "pressed": False, "seq": 0, "seq_t": 0.0}

        def src(t: float):
            seq, x, y, p = self.poll_input()
            now = _time.monotonic()
            if seq != state["seq"]:
                state["seq"], state["seq_t"] = seq, now
                gx = min(max(x, 0.0), nx - 1.0)
                gy = min(max(ny - 1.0 - y, 0.0), ny - 1.0)
                state["pos"] = (gx, gy)
                state["pressed"] = bool(p)
            elif state["pressed"] and now - state["seq_t"] > press_timeout:
                state["pressed"] = False  # browser vanished mid-drag
            last = state["last"]
            state["last"] = state["pos"]
            return state["pos"], last, state["pressed"]

        return src

    def push(self, frame: np.ndarray) -> None:
        """Publish an (H, W, 4) uint8 frame (lazily opens on first frame
        when constructed without dimensions — the FluidApp sink pattern)."""
        frame = np.ascontiguousarray(frame, dtype=np.uint8)
        if frame.ndim != 3 or frame.shape[2] != 4:
            raise ValueError(f"expected (H, W, 4) uint8, got {frame.shape}")
        if self._handle is None and self._py is None:
            self._h, self._w = frame.shape[:2]
            if self._lib is not None:
                self._open_native(self._want_port)
            else:
                self._py = _PyHttpView(self._want_port, self._w, self._h)
        if frame.shape[:2] != (self._h, self._w):
            raise ValueError(
                f"frame is {frame.shape[1]}x{frame.shape[0]}, viewer is "
                f"{self._w}x{self._h}")
        if self._handle is not None:
            # hv_push copies the frame before it returns: no bytes copy here
            self._lib.hv_push(self._handle, frame.ctypes.data_as(ctypes.c_char_p))
        else:
            self._py.push(frame)

    # FluidApp frame_sink interface
    def __call__(self, frame: np.ndarray) -> None:
        self.push(frame)

    def close(self) -> None:
        if self._handle is not None:
            self._lib.hv_close(self._handle)
            self._handle = None
        if self._py is not None:
            self._py.close()
            self._py = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
