"""Build the CUDA sources in ``csrc/`` and bind them with ctypes.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface (no PyTorch headers, so a build
takes seconds).  The library lands in the package's ``build/`` directory
under a name keyed on the hash of the sources and flags, so an edited
source is rebuilt and an unchanged one is reused.  The build runs at first
use; :func:`build_all` starts one ``nvcc`` for each source at once.  A
missing ``nvcc`` or a failed build raises with the compiler's output.

No fast-math flag: the kernels' ``expf``/``powf``/``sqrtf`` and divisions
stay IEEE, and the dye's NaN saturation relies on ``fminf``.  ``-fmad=false``
keeps nvcc from contracting a multiply and an add into one FMA, so each
kernel rounds as its plain version (one PyTorch op per operation) does;
most kernels are bound by bytes, where the lost FMAs cost nothing
measurable, and H3's sweep loses one multiply-add a cell to it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, List, Optional

import torch

PACKAGE = Path(__file__).resolve().parent.parent
CSRC = PACKAGE / "csrc"
BUILD = PACKAGE / "build"
SOURCES = ("advect", "vorticity", "diffuse", "pressure", "multigrid", "sepdiffuse")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-fmad=false", "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_LIBS: Dict[str, ctypes.CDLL] = {}
# seconds spent hashing, compiling and loading the libraries, and how many
# were compiled and loaded in this process (``utils.trace.counters``)
BUILD_STATS = {"build_s": 0.0, "builds": 0, "loads": 0}
_STATS_LOCK = threading.Lock()
# one build or load at a time: the shards of a mesh (parallel/mesh.py) call
# the wrappers from one thread each
_LOAD_LOCK = threading.Lock()
# the shard (``parallel.mesh``) whose thread launches: its index in the
# mesh, or None outside a sharded run
_SHARD = threading.local()


def set_shard(index: Optional[int]) -> None:
    """Tag this thread's launches with shard ``index`` (None: untagged)."""
    _SHARD.index = index


def nvcc() -> str:
    """Path of ``nvcc``: $CUDA_HOME/bin, then $PATH, then the toolkit's
    default prefix."""
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if home and (Path(home) / "bin" / "nvcc").is_file():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.is_file():
        return str(default)
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels are built from csrc/ at first use")


def _library_path(name: str) -> Path:
    h = hashlib.sha256()
    h.update(" ".join(NVCC_FLAGS).encode())
    for src in [CSRC / f"{name}.cu"] + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all(names: Iterable[str] = SOURCES) -> Dict[str, Path]:
    """Compile every named source whose library is missing, all at once;
    return name -> library path.  Each compiler's output (``-Xptxas -v``:
    registers, shared memory, spills) is kept beside its library as
    ``.log``."""
    t0 = time.perf_counter()
    try:
        return _build_all(names)
    finally:
        _count(build_s=time.perf_counter() - t0)


def _count(**add) -> None:
    with _STATS_LOCK:
        for key, value in add.items():
            BUILD_STATS[key] += value


def _build_all(names: Iterable[str]) -> Dict[str, Path]:
    BUILD.mkdir(parents=True, exist_ok=True)
    paths = {name: _library_path(name) for name in names}
    missing = {name: lib for name, lib in paths.items() if not lib.is_file()}
    compiler = nvcc() if missing else None
    jobs: List[tuple] = []
    for name, lib in missing.items():
        tmp = lib.parent / f"{lib.name}.{os.getpid()}.tmp"
        cmd = [compiler, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs.append((name, lib, tmp, cmd, proc))
    failures = []
    for name, lib, tmp, cmd, proc in jobs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failures.append(f"$ {' '.join(cmd)}\n{out}")
            continue
        lib.with_suffix(".log").write_text(out)
        os.replace(tmp, lib)
        _count(builds=1)
    if failures:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failures))
    return paths


def build_log(name: str) -> str:
    """The compiler output kept for ``name``'s current library."""
    log = _library_path(name).with_suffix(".log")
    return log.read_text() if log.is_file() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built if needed."""
    with _LOAD_LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            path = build_all([name])[name]
            t0 = time.perf_counter()
            lib = ctypes.CDLL(str(path))
            lib.fluid_error_string.argtypes = [ctypes.c_int]
            lib.fluid_error_string.restype = ctypes.c_char_p
            _LIBS[name] = lib
            _count(build_s=time.perf_counter() - t0, loads=1)
        return lib


class Kernel:
    """One hand-written kernel: its library, its C entry points and the
    count of its launches.

    ``launches`` is a plain integer that :meth:`launch` adds one to each
    time a wrapper launches the kernel; nothing else changes it but
    :meth:`reset`.  ``by_shard`` counts the same launches by the shard
    (:func:`set_shard`) whose thread made them.
    """

    def __init__(self, name: str, entries: Dict[str, list]):
        self.name = name
        self.entries = entries
        self.launches = 0
        self.by_shard: Dict[int, int] = {}
        self._lib: Optional[ctypes.CDLL] = None
        self._count_lock = threading.Lock()

    def lib(self) -> ctypes.CDLL:
        if self._lib is None:
            lib = load(self.name)
            with _LOAD_LOCK:
                for fn, argtypes in self.entries.items():
                    getattr(lib, fn).argtypes = argtypes
                    getattr(lib, fn).restype = ctypes.c_int
                self._lib = lib
        return self._lib

    def launch(self, entry: str, *args) -> None:
        """Call C entry ``entry`` (which launches on the given stream and
        returns cudaGetLastError()); raise if it is not cudaSuccess."""
        lib = self.lib()
        code = getattr(lib, entry)(*args)
        if code != 0:
            msg = lib.fluid_error_string(code).decode()
            raise RuntimeError(f"{self.name}: {entry} failed: CUDA error {code} ({msg})")
        shard = getattr(_SHARD, "index", None)
        with self._count_lock:
            self.launches += 1
            if shard is not None:
                self.by_shard[shard] = self.by_shard.get(shard, 0) + 1

    def reset(self) -> None:
        with self._count_lock:
            self.launches = 0
            self.by_shard = {}


def stream_of(t: torch.Tensor) -> int:
    """The raw handle of PyTorch's current stream on ``t``'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream


def on_card(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on one CUDA device, False when every one
    lies on the CPU; raise otherwise."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"tensors on several devices: {sorted(map(str, devices))}")
    dev = devices.pop()
    if dev.type == "cuda":
        return True
    if dev.type == "cpu":
        return False
    raise ValueError(f"unsupported device {dev}")


def check_f32(name: str, t: torch.Tensor, shape) -> None:
    """Raise unless ``t`` is a contiguous float32 tensor of ``shape``."""
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: expected float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def check_planes(name: str, t: torch.Tensor, shape) -> None:
    """Raise unless ``t`` is a float32 tensor of ``shape`` whose trailing
    (H, W) planes are each contiguous, at any stride of the leading axes
    (a channel slice of a batched pack)."""
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: expected float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if t.stride(-1) != 1 or t.stride(-2) != t.shape[-1]:
        raise ValueError(f"{name}: expected contiguous (H, W) planes")
