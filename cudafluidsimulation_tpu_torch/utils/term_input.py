"""Live terminal input: raw-mode keyboard + SGR mouse tracking.

The real-input analog of the reference's GLFW cursor capture
(Main.cpp:213-243, glfwGetCursorPos/glfwGetMouseButton polling): stdin is
switched to cbreak mode and drained without blocking once per frame, xterm
SGR mouse reporting (``\\x1b[?1002h`` + ``\\x1b[?1006h``) turns click-drags
into press+position events exactly like the reference's mouse, and
WASD/arrow keys move a virtual cursor on terminals without mouse support.

Controls:
    mouse drag      press + move (splats force and dye, like the reference)
    w/a/s/d, arrows move the virtual cursor
    space           toggle the press (terminals do not report key-up)
    q / Ctrl-C      quit

Pair with :class:`~.term_view.TermViewer` via ``FluidApp``: the
``--interactive`` CLI flag wires all three together.  The port's copy of
the JAX package's module, which imports no JAX: the same state for the
same bytes.
"""

from __future__ import annotations

import os
import select
import sys
from typing import Optional, Tuple

ENABLE_MOUSE = "\x1b[?1002h\x1b[?1006h"  # button-event tracking + SGR coords
DISABLE_MOUSE = "\x1b[?1006l\x1b[?1002l"

_ARROWS = {b"A": (0.0, 1.0), b"B": (0.0, -1.0), b"C": (1.0, 0.0),
           b"D": (-1.0, 0.0)}
_WASD = {b"w": (0.0, 1.0), b"s": (0.0, -1.0), b"d": (1.0, 0.0),
         b"a": (-1.0, 0.0)}


class TermInput:
    """Polled input source over a raw-mode terminal.

    ``cols``/``rows`` must match the paired TermViewer so mouse cells map
    onto the same grid coordinates the viewer renders (the viewer shows the
    y-flipped frame: terminal row 1 is the grid's TOP row).
    """

    def __init__(self, nx: int, ny: int, cols: int, rows: int,
                 step_cells: float = 0.0, mouse: bool = True,
                 stream=None, stdin=None):
        self.nx, self.ny = nx, ny
        self.cols, self.rows = max(1, cols), max(1, rows)
        # one viewer cell per keypress by default
        self.step = step_cells or max(nx / self.cols, ny / (2 * self.rows))
        self.mouse = mouse
        self.quit = False
        self.pressed = False
        self.pos: Tuple[float, float] = (nx / 2.0, ny / 2.0)
        self._buf = b""
        self._saved = None
        self._stream = stream if stream is not None else sys.stdout
        self._stdin = stdin if stdin is not None else sys.stdin

    # -- terminal mode management -------------------------------------------

    def __enter__(self):
        if self._stdin.isatty():
            import termios
            import tty

            fd = self._stdin.fileno()
            self._saved = termios.tcgetattr(fd)
            tty.setcbreak(fd)
            if self.mouse:
                self._stream.write(ENABLE_MOUSE)
                self._stream.flush()
        return self

    def __exit__(self, *exc):
        if self._saved is not None:
            import termios

            if self.mouse:
                self._stream.write(DISABLE_MOUSE)
                self._stream.flush()
            termios.tcsetattr(self._stdin.fileno(), termios.TCSADRAIN,
                              self._saved)
            self._saved = None
        return False

    # -- event parsing --------------------------------------------------------

    def _cell_to_grid(self, cx: int, cy: int) -> Tuple[float, float]:
        """1-based terminal cell -> grid coords (grid y up, viewer flipped)."""
        gx = (cx - 0.5) * self.nx / self.cols
        gy = self.ny * (1.0 - (cy - 0.5) / self.rows)
        return (min(max(gx, 0.0), self.nx - 1.0),
                min(max(gy, 0.0), self.ny - 1.0))

    def feed(self, data: bytes) -> None:
        """Parse raw bytes into cursor/press state (exposed for tests)."""
        buf = self._buf + data
        i = 0
        n = len(buf)
        while i < n:
            c = buf[i:i + 1]
            if c == b"\x1b":
                seq = buf[i:]
                if seq.startswith(b"\x1b[<"):  # SGR mouse: \x1b[<B;X;Y(M|m)
                    end = -1
                    for j in range(3, min(len(seq), 24)):
                        if seq[j:j + 1] in (b"M", b"m"):
                            end = j
                            break
                    if end < 0:
                        if len(seq) >= 24:
                            # no terminator within the longest legal SGR
                            # sequence: garbage (e.g. pasted text) — skip
                            # the ESC and resync instead of wedging forever
                            i += 1
                            continue
                        break  # genuinely incomplete: keep for the next feed
                    body = seq[3:end].split(b";")
                    try:
                        btn, cx, cy = (int(x) for x in body)
                    except ValueError:
                        i += end + 1
                        continue
                    final = seq[end:end + 1]
                    if btn & 64:  # scroll wheel: ignore
                        i += end + 1
                        continue
                    self.pos = self._cell_to_grid(cx, cy)
                    # press (M) and motion-with-button (bit 32) hold the
                    # splat; release (m) ends it — Main.cpp:224-236 semantics
                    self.pressed = final == b"M"
                    i += end + 1
                    continue
                if seq.startswith(b"\x1b[M"):
                    # legacy X10 mouse report (terminal honors mode 1002
                    # but not SGR 1006): ESC [ M btn+32 x+32 y+32.  Parse it
                    # — its payload bytes are raw values that must NEVER be
                    # replayed as keystrokes (col 81 encodes as 'q'!)
                    if len(seq) < 6:
                        break  # incomplete: keep for the next feed
                    btn = seq[3] - 32
                    cx, cy = seq[4] - 32, seq[5] - 32
                    if not btn & 64:  # ignore scroll wheel
                        if cx > 0 and cy > 0:
                            self.pos = self._cell_to_grid(cx, cy)
                        # release encodes as low bits 3; press/drag holds
                        self.pressed = (btn & 3) != 3
                    i += 6
                    continue
                if (len(seq) >= 3 and seq[1:2] in (b"[", b"O")
                        and seq[2:3] in _ARROWS):  # CSI or SS3 arrows
                    dx, dy = _ARROWS[seq[2:3]]
                    self._nudge(dx, dy)
                    i += 3
                    continue
                if len(seq) < 3:
                    break  # possibly incomplete: keep
                if seq[1:2] == b"[":
                    # unknown CSI (ctrl-arrows, terminal replies, ...):
                    # consume THROUGH its final byte (0x40-0x7E) so the
                    # parameter bytes are not replayed as WASD/quit keys
                    end = -1
                    for j in range(2, min(len(seq), 24)):
                        if 0x40 <= seq[j] <= 0x7E:
                            end = j
                            break
                    if end < 0:
                        if len(seq) >= 24:
                            i += 1  # garbage: skip the ESC and resync
                            continue
                        break  # genuinely incomplete: keep for next feed
                    i += end + 1
                    continue
                i += 2  # other escape (alt-key, ESC O ...): skip both bytes
                continue
            if c in (b"q", b"Q", b"\x03"):
                self.quit = True
                i += 1
                continue
            if c == b" ":
                self.pressed = not self.pressed
                i += 1
                continue
            if c.lower() in _WASD:
                dx, dy = _WASD[c.lower()]
                self._nudge(dx, dy)
                i += 1
                continue
            i += 1
        self._buf = buf[i:] if i < n else b""

    def _nudge(self, dx: float, dy: float) -> None:
        x, y = self.pos
        self.pos = (min(max(x + dx * self.step, 0.0), self.nx - 1.0),
                    min(max(y + dy * self.step, 0.0), self.ny - 1.0))

    def _drain_stdin(self) -> bytes:
        if not self._stdin.isatty():
            return b""
        fd = self._stdin.fileno()
        out = b""
        while select.select([fd], [], [], 0)[0]:
            chunk = os.read(fd, 4096)
            if not chunk:
                break
            out += chunk
        return out

    # -- InputSource interface -------------------------------------------------

    def source(self):
        """An ``InputSource`` for FluidApp: polls pending input each frame
        and returns (pos, last_pos, pressed) like GLFW cursor polling."""
        state = {"last": self.pos}

        def src(t: float):
            data = self._drain_stdin()
            if data:
                self.feed(data)
            last = state["last"]
            state["last"] = self.pos
            return self.pos, last, self.pressed

        return src
