"""Build and bind the repository's native C++ libraries with ctypes, and
the asynchronous frame sink (``FrameSink``) on one of them.

The sources in ``native/`` are framework-free (the JAX package builds them
with ``make -C native``, into ``native/``).  The port compiles the ones it
uses itself, with ``g++`` and the Makefile's flags, into its own
``build/`` directory, so a build never races the JAX package's on the same
files.  A library's name carries a hash of its sources, the flags and what
``-march=native`` means on this machine's compiler: an edited source is
rebuilt, an unchanged one is reused, and a library built for another CPU
is never loaded.  The build writes a temporary file and renames it into
place, so processes building at once (test workers) each load a whole
library.

``FrameSink`` is the headless stand-in for the reference's native display
path (CUDA surface -> GL texture -> blit, GPUFluidSim.cu:594-601 /
Main.cpp:166-180): frames are pushed without blocking into a C++ ring
buffer (``native/framesink.cpp``) and a background thread PNG-encodes and
writes them, so the simulation loop never stalls on IO.  Without a
toolchain it writes through the pure-Python ``utils.png.write_png``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Callable, Dict, Optional

import numpy as np

_PACKAGE = Path(__file__).resolve().parent.parent
NATIVE = _PACKAGE.parent / "native"
BUILD = _PACKAGE / "build"
CXX = "g++"
# native/Makefile's CXXFLAGS
CXXFLAGS = ["-O3", "-march=native", "-Wall", "-shared", "-fPIC"]
# library -> (sources compiled, headers they include, link flags), as the
# Makefile's rules
LIBRARIES = {
    "libframesink.so": (["framesink.cpp"], ["png_encode.h"], ["-lz", "-pthread"]),
    "libhttpview.so": (["httpview.cpp"], ["png_encode.h", "jpeg_encode.h"], ["-lz", "-pthread"]),
    "libjpegenc.so": (["jpegenc.cpp"], ["jpeg_encode.h"], ["-pthread"]),
}

_load_lock = threading.Lock()
_loaded: Dict[str, Optional[ctypes.CDLL]] = {}  # None when the build failed


def _native_target() -> bytes:
    """What ``-march=native`` enables on this machine's compiler."""
    return subprocess.run([CXX, *CXXFLAGS[:2], "-Q", "--help=target"], check=True,
                          capture_output=True, timeout=60).stdout


def library_path(so_name: str) -> Path:
    """Where ``so_name`` is built for this machine."""
    sources, headers, link = LIBRARIES[so_name]
    h = hashlib.sha256()
    h.update(" ".join([CXX, *CXXFLAGS, *link]).encode())
    h.update(_native_target())
    for name in sources + headers:
        h.update(name.encode())
        h.update((NATIVE / name).read_bytes())
    return BUILD / f"{Path(so_name).stem}-{h.hexdigest()[:16]}.so"


def _build(so_name: str) -> Path:
    lib = library_path(so_name)
    if lib.is_file():
        return lib
    sources, _, link = LIBRARIES[so_name]
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = lib.parent / f"{lib.name}.{os.getpid()}.tmp"
    try:
        subprocess.run([CXX, *CXXFLAGS, *(str(NATIVE / s) for s in sources), "-o", str(tmp),
                        *link], check=True, capture_output=True, timeout=120)
        os.replace(tmp, lib)
    finally:
        tmp.unlink(missing_ok=True)
    return lib


def load_native_lib(so_name: str, bind: Callable[[ctypes.CDLL], None]) -> Optional[ctypes.CDLL]:
    """Build (when missing) and dlopen one of the native libraries, once per
    process, and call ``bind(lib)`` to declare its ctypes signatures.
    Returns None, latched so that the toolchain is probed once, when no
    compiler is found or the build or the load fails."""
    with _load_lock:
        if so_name in _loaded:
            return _loaded[so_name]
        try:
            lib = ctypes.CDLL(str(_build(so_name)))
            bind(lib)
        except (OSError, subprocess.SubprocessError, AttributeError):
            lib = None
        _loaded[so_name] = lib
        return lib


def _bind(lib: ctypes.CDLL) -> None:
    lib.fs_open.restype = ctypes.c_void_p
    lib.fs_open.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.fs_push.restype = ctypes.c_int
    lib.fs_push.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.fs_flush.argtypes = [ctypes.c_void_p]
    lib.fs_frames_written.restype = ctypes.c_uint64
    lib.fs_frames_written.argtypes = [ctypes.c_void_p]
    lib.fs_frames_dropped.restype = ctypes.c_uint64
    lib.fs_frames_dropped.argtypes = [ctypes.c_void_p]
    lib.fs_close.argtypes = [ctypes.c_void_p]


def _load() -> Optional[ctypes.CDLL]:
    return load_native_lib("libframesink.so", _bind)


def native_available() -> bool:
    return _load() is not None


class FrameSink:
    """Async PNG frame writer.  Push (H, W, 4) uint8 frames; they are
    written as frame_XXXXXXXX.png under ``directory`` by a native
    background thread.

    ``capacity`` bounds the in-flight queue; like a saturated real-time
    display, excess frames are dropped (count via ``dropped``).
    """

    def __init__(self, directory: str, width: int, height: int,
                 capacity: int = 16, force_python: bool = False):
        os.makedirs(directory, exist_ok=True)
        self._dir = directory
        self._w = width
        self._h = height
        self._count = 0
        self._lib = None if force_python else _load()
        self._handle = None
        if self._lib is not None:
            self._handle = ctypes.c_void_p(self._lib.fs_open(
                directory.encode(), width, height, capacity))

    def push(self, frame: np.ndarray) -> bool:
        """Enqueue a frame (always accepted); returns False when the queue
        was full and the OLDEST queued frame was evicted to make room
        (real-time display semantics: the newest content always survives)."""
        frame = np.ascontiguousarray(frame, dtype=np.uint8)
        if frame.shape != (self._h, self._w, 4):
            raise ValueError(f"expected ({self._h}, {self._w}, 4), got {frame.shape}")
        if self._handle is not None:
            # fs_push copies the frame before it returns: no bytes copy here
            return bool(self._lib.fs_push(self._handle, frame.ctypes.data_as(ctypes.c_char_p)))
        from cudafluidsimulation_tpu_torch.utils.png import write_png

        write_png(os.path.join(self._dir, f"frame_{self._count:08d}.png"), frame)
        self._count += 1
        return True

    def flush(self) -> None:
        if self._handle is not None:
            self._lib.fs_flush(self._handle)

    @property
    def written(self) -> int:
        if self._handle is not None:
            return int(self._lib.fs_frames_written(self._handle))
        return self._count

    @property
    def dropped(self) -> int:
        if self._handle is not None:
            return int(self._lib.fs_frames_dropped(self._handle))
        return 0

    def close(self) -> None:
        if self._handle is not None:
            self._lib.fs_close(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
