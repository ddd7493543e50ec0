"""Native baseline-JPEG encoding (ctypes over native/jpeg_encode.h).

The port's own binding of ``jpg_encode`` and ``jpg_encode_mt``, built by
``utils.native_sink`` into the port's build directory from the same
source and flags as the JAX package's, so the bytes are its bytes.  The
frame sinks' compact codec: ~9x faster to encode and ~20x smaller than
PNG on rendered fluid frames (4:2:0 baseline JFIF at quality 90 is visually
lossless for this content).  Used by the MJPEG AVI writer (utils/video.py)
and available to any sink; PNG (utils/png.py) remains the lossless path and
the fallback when no C++ toolchain is present.

There is deliberately no pure-Python fallback: a Python DCT+Huffman encoder
would be slower than the PNG writer it is meant to beat.  Callers check
:func:`native_available` and fall back to PNG.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np

from cudafluidsimulation_tpu_torch.utils.native_sink import load_native_lib


def _bind(lib: ctypes.CDLL) -> None:
    lib.jpg_encode.restype = ctypes.c_long
    lib.jpg_encode.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_char_p, ctypes.c_long,
    ]
    lib.jpg_encode_mt.restype = ctypes.c_long
    lib.jpg_encode_mt.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_char_p, ctypes.c_long,
    ]


def _load() -> Optional[ctypes.CDLL]:
    return load_native_lib("libjpegenc.so", _bind)


def native_available() -> bool:
    return _load() is not None


def jpeg_bytes(frame: np.ndarray, quality: int = 90,
               threads: int = 1) -> bytes:
    """Encode an (H, W, 3|4) uint8 frame as baseline JFIF bytes.

    ``threads`` > 1 row-stripes the DCT+Huffman work over that many native
    worker threads (restart-marker bands, any baseline decoder accepts the
    stream); 0 = one thread per hardware core.  threads=1 keeps the
    bit-identical single-threaded stream.

    Raises RuntimeError when the native encoder is unavailable — callers
    that can degrade should check :func:`native_available` first."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native JPEG encoder unavailable (no toolchain?)")
    frame = np.ascontiguousarray(frame, dtype=np.uint8)
    if frame.ndim != 3 or frame.shape[2] not in (3, 4):
        raise ValueError(f"expected (H, W, 3|4) uint8, got {frame.shape}")
    if frame.shape[2] == 3:
        frame = np.concatenate(
            [frame, np.full(frame.shape[:2] + (1,), 255, np.uint8)], axis=2)
    h, w = frame.shape[:2]
    if threads == 0:
        import os

        threads = os.cpu_count() or 1
    cap = w * h * 4 + 4096
    buf = ctypes.create_string_buffer(cap)
    raw = frame.tobytes()
    n = lib.jpg_encode_mt(raw, w, h, int(quality), int(threads), buf, cap)
    if n <= 0:
        # -needed: capacity miss (only possible for pathological inputs,
        # where entropy coding expands past the raw size)
        if n < 0:
            cap = -int(n)
            buf = ctypes.create_string_buffer(cap)
            n = lib.jpg_encode_mt(raw, w, h, int(quality), int(threads),
                                  buf, cap)
        if n <= 0:
            raise RuntimeError(f"jpg_encode failed (rc={int(n)})")
    return buf.raw[:n]
