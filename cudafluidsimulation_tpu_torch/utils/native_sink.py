"""Build and bind the repository's native C++ libraries with ctypes.

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

Only the loader is here; the asynchronous frame sink (``FrameSink``) comes
with the live views.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Callable, Dict, Optional

_PACKAGE = Path(__file__).resolve().parent.parent
NATIVE = _PACKAGE.parent / "native"
BUILD = _PACKAGE / "build"
CXX = "g++"
# native/Makefile's CXXFLAGS
CXXFLAGS = ["-O3", "-march=native", "-Wall", "-shared", "-fPIC"]
# library -> (sources compiled, headers they include, link flags), as the
# Makefile's rules
LIBRARIES = {
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
