"""Minimal dependency-free PNG writer (stdlib zlib only).

Replaces the reference's OpenGL texture upload + window blit
(Main.cpp:109-119, 166-180) for headless runs: frames become PNG files.
The bytes are the JAX package's for the same frames: zlib level 6, the
same chunks.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def _chunk(tag: bytes, payload: bytes) -> bytes:
    return (
        struct.pack(">I", len(payload))
        + tag
        + payload
        + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF)
    )


def _scanlines(rgba: np.ndarray) -> bytes:
    # filter byte 0 (None) per scanline
    return b"".join(b"\x00" + rgba[y].tobytes() for y in range(rgba.shape[0]))


def _check(rgba: np.ndarray) -> np.ndarray:
    rgba = np.ascontiguousarray(rgba)
    if rgba.dtype != np.uint8 or rgba.ndim != 3 or rgba.shape[2] != 4:
        raise ValueError(f"expected (H, W, 4) uint8, got {rgba.shape} {rgba.dtype}")
    return rgba


def png_bytes(rgba: np.ndarray) -> bytes:
    """Encode an (H, W, 4) uint8 array as RGBA PNG bytes."""
    rgba = _check(rgba)
    h, w = rgba.shape[:2]
    out = b"\x89PNG\r\n\x1a\n"
    out += _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 6, 0, 0, 0))
    out += _chunk(b"IDAT", zlib.compress(_scanlines(rgba), 6))
    out += _chunk(b"IEND", b"")
    return out


def write_png(path: str, rgba: np.ndarray) -> None:
    """Write an (H, W, 4) uint8 array as an RGBA PNG."""
    with open(path, "wb") as f:
        f.write(png_bytes(rgba))


def write_apng(path: str, frames, fps: float = 30.0, loops: int = 0) -> None:
    """Write a sequence of (H, W, 4) uint8 frames as an animated PNG.

    The dependency-free animation export (no ffmpeg needed): APNG plays
    in every modern browser/viewer and degrades to the first
    frame elsewhere.  ``loops=0`` means loop forever.
    """
    frames = [_check(f) for f in frames]
    if not frames:
        raise ValueError("no frames")
    h, w = frames[0].shape[:2]
    for f in frames:
        if f.shape[:2] != (h, w):
            raise ValueError("all frames must share one size")

    delay_num, delay_den = max(1, round(1000.0 / fps)), 1000
    out = b"\x89PNG\r\n\x1a\n"
    out += _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 6, 0, 0, 0))
    out += _chunk(b"acTL", struct.pack(">II", len(frames), loops))
    seq = 0

    def fctl(n):
        nonlocal seq
        payload = struct.pack(
            ">IIIIIHHBB", seq, w, h, 0, 0, delay_num, delay_den, 0, 0
        )
        seq += 1
        return _chunk(b"fcTL", payload)

    out += fctl(0)
    out += _chunk(b"IDAT", zlib.compress(_scanlines(frames[0]), 6))
    for f in frames[1:]:
        out += fctl(None)
        data = zlib.compress(_scanlines(f), 6)
        out += _chunk(b"fdAT", struct.pack(">I", seq) + data)
        seq += 1
    out += _chunk(b"IEND", b"")
    with open(path, "wb") as fobj:
        fobj.write(out)
