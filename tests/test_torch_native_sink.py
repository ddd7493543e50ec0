"""The port's asynchronous frame sink against the JAX package's, on the CPU.

``FrameSink`` native (``native/framesink.cpp`` built into the port's build
directory) and Python (``utils.png.write_png``): the PNG round trip, the
capacity dropping the oldest frame, the shape check, and files byte-equal
to the JAX sink's for the same frames, backend for backend.
"""

import zlib

import numpy as np
import pytest
import torch

from cudafluidsimulation_tpu.utils import native_sink as jnative_sink

from cudafluidsimulation_tpu_torch import FluidConfig
from cudafluidsimulation_tpu_torch.models.app import FluidApp
from cudafluidsimulation_tpu_torch.utils import native_sink
from cudafluidsimulation_tpu_torch.utils.native_sink import FrameSink

torch.set_num_threads(1)

BACKENDS = pytest.mark.parametrize("force_python", [False, True], ids=["native", "python"])


def _need(force_python, *mods):
    if not force_python and not all(m.native_available() for m in mods):
        pytest.skip("no C++ toolchain to build the native frame sink")


def _decode_png_rgba(path, h, w):
    data = open(path, "rb").read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    idat = data.index(b"IDAT") + 4
    n = int.from_bytes(data[idat - 8:idat - 4], "big")
    rows = np.frombuffer(zlib.decompress(data[idat:idat + n]), np.uint8).reshape(h, 1 + w * 4)
    assert (rows[:, 0] == 0).all()
    return rows[:, 1:].reshape(h, w, 4)


def _frames(n, h, w, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (h, w, 4), dtype=np.uint8) for _ in range(n)]


def test_native_sink_builds_into_the_port():
    assert native_sink.native_available(), "native framesink failed to build/load"
    lib = native_sink.library_path("libframesink.so")
    assert lib.parent == native_sink.BUILD and lib.is_file()
    assert lib.name.startswith("libframesink-") and lib.suffix == ".so"


@BACKENDS
def test_push_flush_round_trip(tmp_path, force_python):
    _need(force_python, native_sink)
    h, w = 24, 32
    frames = _frames(5, h, w)
    with FrameSink(str(tmp_path), w, h, force_python=force_python) as sink:
        for f in frames:
            assert sink.push(f)
        sink.flush()
        assert (sink.written, sink.dropped) == (5, 0)
    for i, f in enumerate(frames):
        np.testing.assert_array_equal(
            _decode_png_rgba(str(tmp_path / f"frame_{i:08d}.png"), h, w), f)


@BACKENDS
def test_files_equal_the_jax_sinks(tmp_path, force_python):
    _need(force_python, native_sink, jnative_sink)
    frames = _frames(3, 40, 56, seed=1)
    # a y-flipped view, as Simulation.frame_image handed out before: the
    # sink takes any layout
    frames.append(frames[0][::-1])
    for name, mod in (("port", native_sink), ("jax", jnative_sink)):
        with mod.FrameSink(str(tmp_path / name), 56, 40, force_python=force_python) as sink:
            for f in frames:
                sink.push(f)
            sink.flush()
    for i in range(len(frames)):
        got = (tmp_path / "port" / f"frame_{i:08d}.png").read_bytes()
        assert got == (tmp_path / "jax" / f"frame_{i:08d}.png").read_bytes()


def test_capacity_drops_the_oldest(tmp_path):
    _need(False, native_sink)
    h, w, n = 512, 512, 200
    with FrameSink(str(tmp_path), w, h, capacity=2) as sink:
        for i in range(n):
            sink.push(np.full((h, w, 4), i % 251, np.uint8))  # content tags the index
        sink.flush()
        assert sink.written + sink.dropped == n
        assert sink.dropped > 0
        written = sink.written
    # drop-oldest: the newest frame always survives as the last file written
    last = _decode_png_rgba(str(tmp_path / f"frame_{written - 1:08d}.png"), h, w)
    assert int(last[0, 0, 0]) == (n - 1) % 251


@BACKENDS
def test_shape_check(tmp_path, force_python):
    _need(force_python, native_sink)
    with FrameSink(str(tmp_path), 16, 16, force_python=force_python) as sink:
        for bad in (np.zeros((8, 8, 4), np.uint8), np.zeros((16, 16, 3), np.uint8)):
            with pytest.raises(ValueError, match=r"expected \(16, 16, 4\)"):
                sink.push(bad)
        assert sink.written == 0


def test_frame_loop_into_the_sink(tmp_path):
    _need(False, native_sink)
    cfg = FluidConfig.gpu_reference(nx=64, ny=64, backend="ref", diffusion_iters=2,
                                    pressure_iters=2)
    with FrameSink(str(tmp_path), 64, 64) as sink:
        app = FluidApp(cfg, frame_sink=sink.push, fixed_dt=1 / 60)
        app.run(max_frames=5, pipelined=True)
        sink.flush()
        assert sink.written + sink.dropped == 5
