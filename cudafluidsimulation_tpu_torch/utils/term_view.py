"""Terminal live viewer: ANSI truecolor half-block rendering.

A dependency-free stand-in for the reference's OpenGL window (Main.cpp:70,
166-180): each character cell shows two vertical pixels via the upper
half-block glyph with separate fg/bg colors.  Works over ssh; pair with
models.app.FluidApp as its frame_sink for an interactive-equivalent demo.
The port's copy of the JAX package's numpy-only module: the same text for
the same frames, built from Python ints.
"""

from __future__ import annotations

import shutil
import sys

import numpy as np


def _resample(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    h, w = img.shape[:2]
    ys = (np.arange(out_h) * (h / out_h)).astype(int)
    xs = (np.arange(out_w) * (w / out_w)).astype(int)
    return img[ys[:, None], xs[None, :]]


def frame_to_ansi(rgba: np.ndarray, cols: int = 0, rows: int = 0) -> str:
    """(H, W, 4) uint8 -> ANSI string (two image rows per text row)."""
    if cols <= 0 or rows <= 0:
        size = shutil.get_terminal_size((80, 24))
        cols = cols or min(size.columns, 120)
        rows = rows or min(size.lines - 2, 48)
    # as Python ints: indexing and formatting numpy scalars cell by cell
    # takes several times as long for the same text
    img = _resample(rgba[..., :3], rows * 2, cols).tolist()
    out = []
    for top, bottom in zip(img[0::2], img[1::2]):
        line = [f"\x1b[38;2;{tr};{tg};{tb}m\x1b[48;2;{br};{bg_};{bb}m▀"
                for (tr, tg, tb), (br, bg_, bb) in zip(top, bottom)]
        out.append("".join(line) + "\x1b[0m")
    return "\n".join(out)


class TermViewer:
    """Frame sink that repaints the terminal in place."""

    def __init__(self, cols: int = 0, rows: int = 0, stream=None):
        self.cols = cols
        self.rows = rows
        self.stream = stream or sys.stdout
        self._first = True

    def __call__(self, frame: np.ndarray) -> None:
        text = frame_to_ansi(frame, self.cols, self.rows)
        n_lines = text.count("\n") + 1
        if not self._first:
            self.stream.write(f"\x1b[{n_lines}F")  # cursor back up
        self._first = False
        self.stream.write(text + "\n")
        self.stream.flush()
