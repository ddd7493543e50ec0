"""Dependency-free video muxing: RIFF/AVI with MJPEG or uncompressed RGB.

The reference renders into an OpenGL window (Main.cpp:166-180); headless
runs here dump frames instead.  ``write_apng`` (utils.png) covers
browser-friendly animation; this module adds a REAL video container that
VLC, mpv, ffmpeg, and QuickTime all open, with zero external dependencies:

- ``codec="mjpeg"`` (default when the native encoder is available): each
  frame is a baseline JPEG (native/jpeg_encode.h via utils/jpeg.py) —
  ~20x smaller and ~9x faster to write than raw RGB at quality 90.
- ``codec="rgb"``: uncompressed 'DIB ' (BI_RGB) frames — lossless, huge,
  zero native-toolchain requirement.

Either way the writer streams frames straight to disk, so memory stays
flat; pipe through ffmpeg for mp4 when available:

    ffmpeg -i run.avi -c:v libx264 -pix_fmt yuv420p run.mp4
"""

from __future__ import annotations

import struct
from typing import Sequence

import numpy as np


def _fourcc(s: str) -> bytes:
    return s.encode("ascii")


class AviWriter:
    """Streaming AVI writer (MJPEG or uncompressed RGB).

    Frames are (H, W, 3|4) uint8 RGB(A), y-down (image convention — what
    ``Simulation.frame_image`` returns).  The 'DIB ' codec stores bottom-up
    BGR rows padded to 4 bytes; 'MJPG' stores one baseline JPEG per chunk.
    """

    def __init__(self, path: str, width: int, height: int, fps: float = 30.0,
                 codec: str = "auto", quality: int = 90):
        if codec not in ("auto", "rgb", "mjpeg"):
            raise ValueError(f"unknown codec {codec!r} (auto, rgb or mjpeg)")
        if codec != "rgb":
            # resolve 'auto' and fail FAST on an explicit 'mjpeg' request
            # without a toolchain — before any simulation work is invested
            from cudafluidsimulation_tpu_torch.utils.jpeg import (
                jpeg_bytes, native_available,
            )

            if native_available():
                codec = "mjpeg"
                self._encode = jpeg_bytes
            elif codec == "mjpeg":
                raise RuntimeError(
                    "codec='mjpeg' requested but the native JPEG encoder is "
                    "unavailable (no C++ toolchain?); use codec='rgb'")
            else:
                codec = "rgb"
        self.w, self.h = int(width), int(height)
        self.fps = float(fps)
        self.codec = codec
        self.quality = int(quality)
        self._stride = (self.w * 3 + 3) & ~3  # rows pad to 4-byte multiples
        self._rgb_bytes = self._stride * self.h
        self._max_chunk = self._rgb_bytes if codec == "rgb" else 0
        self._chunks = []  # (movi-relative offset, payload size) for idx1
        self._f = open(path, "wb")
        self._write_header(n_frames=0)  # placeholder counts, fixed in close()
        self._movi_start = self._f.tell() - 4  # position of 'movi' fourcc

    # -- container plumbing --------------------------------------------------

    def _write_header(self, n_frames: int) -> None:
        f = self._f
        f.seek(0)
        usec = int(round(1_000_000 / self.fps))
        rate = int(round(self.fps * 1000))
        scale = 1000
        mjpeg = self.codec == "mjpeg"
        handler = _fourcc("MJPG") if mjpeg else _fourcc("DIB ")
        compression = struct.unpack("<I", _fourcc("MJPG"))[0] if mjpeg else 0
        bufsize = max(self._max_chunk, 1)

        strf = struct.pack("<IiiHHIIiiII", 40, self.w, self.h, 1, 24,
                           compression, bufsize, 0, 0, 0, 0)
        strh = (
            _fourcc("vids") + handler
            + struct.pack("<IHHIIIIIIiI", 0, 0, 0, 0, scale, rate, 0,
                          n_frames, bufsize, -1, 0)
            + struct.pack("<hhhh", 0, 0, self.w, self.h)
        )
        strl = (
            _fourcc("LIST")
            + struct.pack("<I", 4 + 8 + len(strh) + 8 + len(strf))
            + _fourcc("strl")
            + _fourcc("strh") + struct.pack("<I", len(strh)) + strh
            + _fourcc("strf") + struct.pack("<I", len(strf)) + strf
        )
        avih = struct.pack(
            "<IIIIIIIIIIIIII",
            usec, bufsize * max(1, int(self.fps)), 0,
            0x10,  # AVIF_HASINDEX
            n_frames, 0, 1, bufsize, self.w, self.h, 0, 0, 0, 0,
        )
        hdrl = (
            _fourcc("LIST")
            + struct.pack("<I", 4 + 8 + len(avih) + len(strl))
            + _fourcc("hdrl")
            + _fourcc("avih") + struct.pack("<I", len(avih)) + avih
            + strl
        )
        riff_head = _fourcc("RIFF") + struct.pack("<I", 0) + _fourcc("AVI ")
        f.write(riff_head + hdrl)
        f.write(_fourcc("LIST") + struct.pack("<I", 0) + _fourcc("movi"))

    @property
    def _chunk_id(self) -> bytes:
        return _fourcc("00dc") if self.codec == "mjpeg" else _fourcc("00db")

    def add(self, frame: np.ndarray) -> None:
        frame = np.asarray(frame)
        if frame.dtype != np.uint8 or frame.ndim != 3:
            raise ValueError("frame must be (H, W, 3|4) uint8")
        if frame.shape[:2] != (self.h, self.w):
            raise ValueError(
                f"frame is {frame.shape[1]}x{frame.shape[0]}, "
                f"writer is {self.w}x{self.h}")
        if self.codec == "mjpeg":
            # threads=0 -> one restart-marker band per core (utils/jpeg.py);
            # recording must keep pace with the sim, same as the live view
            payload = self._encode(frame, quality=self.quality, threads=0)
        else:
            bgr = frame[::-1, :, 2::-1]  # bottom-up rows, RGB -> BGR
            rows = np.zeros((self.h, self._stride), np.uint8)
            rows[:, : self.w * 3] = bgr.reshape(self.h, self.w * 3)
            payload = rows.tobytes()
        self._chunks.append((self._f.tell() - self._movi_start, len(payload)))
        self._max_chunk = max(self._max_chunk, len(payload))
        self._f.write(self._chunk_id + struct.pack("<I", len(payload)))
        self._f.write(payload)
        if len(payload) & 1:
            self._f.write(b"\x00")  # RIFF chunks are word-aligned

    def close(self) -> None:
        if self._f.closed:
            return
        f = self._f
        movi_end = f.tell()
        # idx1: one keyframe entry per chunk, offsets relative to 'movi'
        f.write(_fourcc("idx1"))
        f.write(struct.pack("<I", 16 * len(self._chunks)))
        for off, size in self._chunks:
            f.write(self._chunk_id + struct.pack("<III", 0x10, off, size))
        riff_end = f.tell()

        # fix up the deferred sizes + frame counts (header rewrite first —
        # it re-zeroes the RIFF/movi size placeholders it contains)
        self._write_header(n_frames=len(self._chunks))
        f.seek(4)
        f.write(struct.pack("<I", riff_end - 8))
        f.seek(self._movi_start - 4)
        f.write(struct.pack("<I", movi_end - self._movi_start))
        f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def write_avi(path: str, frames: Sequence[np.ndarray], fps: float = 30.0,
              codec: str = "auto", quality: int = 90) -> str:
    """Write (N, H, W, 3|4) uint8 frames as an AVI; returns the codec used.

    ``codec="auto"`` picks MJPEG when the native encoder is available and
    falls back to uncompressed RGB otherwise (resolved by AviWriter)."""
    frames = list(frames)
    if not frames:
        raise ValueError("no frames")
    h, w = frames[0].shape[:2]
    with AviWriter(path, w, h, fps, codec=codec, quality=quality) as av:
        for fr in frames:
            av.add(fr)
        return av.codec
