"""Interactive-style frame loop — the reference app shell, headless.

Mirrors Main.cpp's loop (Main.cpp:133-182): real wall-clock dt per frame,
an input source polled each frame (the mouse stand-in), per-frame compute-time
min/max/avg accumulation (Main.cpp:45-51, 159-164), a 2 Hz FPS readout
(Main.cpp:140-148), and the end-of-run report (Main.cpp:183-206).  Frames go
to a sink callback (native PNG sink, a viewer, or nothing) instead of an
OpenGL blit.

The loop runs on the port's ``Simulation``: on the card unless the config
asks for the CPU (``backend="ref"``).  On the card a frame's readback is
queued, not waited for: the render's layout change and flip run on the
device (``Simulation.frame_layout``), the image is copied into pinned host
memory with ``non_blocking=True``, and an event recorded after the copy is
the one thing the host waits on before it hands the image to the sink.  A
plain ``.cpu()`` would also wait for every kernel queued after the render,
so with ``pipelined`` the step just dispatched would no longer overlap the
previous frame's readback.

Spans (``utils.trace.span``, no-ops unless a profiler runs):
``fluid.session.setup`` around a session's set-up, ``fluid.frame`` around
each iteration of the loop (the frame's number as ``ident``) and inside it
``fluid.frame.input`` (the input source), the step's and the render's spans,
``fluid.frame.layout`` and ``fluid.frame.readback_queue`` (queueing the
readback), ``fluid.frame.readback_wait`` (the host waiting on the card) and
``fluid.frame.sink``.
"""

from __future__ import annotations

import math
import time
from typing import Callable, Optional

import numpy as np
import torch

from cudafluidsimulation_tpu_torch.config import FluidConfig
from cudafluidsimulation_tpu_torch.models.simulation import Simulation
from cudafluidsimulation_tpu_torch.state import FluidState
from cudafluidsimulation_tpu_torch.utils.impulse import single
from cudafluidsimulation_tpu_torch.utils.timing import StageReport
from cudafluidsimulation_tpu_torch.utils.trace import span

# An input source returns (pos, last_pos, pressed) in grid coords for a
# given frame time — the replacement for glfwGetCursorPos polling
# (Main.cpp:213-243).
InputSource = Callable[[float], tuple]


def orbit_source(cfg: FluidConfig, radius_frac: float = 0.125,
                 omega: float = 3.0) -> InputSource:
    cx, cy = cfg.nx / 2.0, cfg.ny / 2.0
    rad = min(cfg.nx, cfg.ny) * radius_frac
    state = {"last": (cx + rad, cy)}

    def src(t: float):
        pos = (cx + rad * math.cos(omega * t), cy + rad * math.sin(omega * t))
        last = state["last"]
        state["last"] = pos
        return pos, last, True

    return src


def replay_source(imp) -> InputSource:
    """Replay a scripted :class:`~..utils.impulse.Impulse` stream by frame
    index — lets ``--impulse-file`` scripts drive the interactive-style frame
    loop (term view).  Frames past the script's end release the press.

    The frame loop supplies its own dt (fixed or wall-clock), so any per-step
    dt recorded in the script is ignored here; replay through
    ``Simulation.run`` for exact dt reproduction.
    """
    pos = np.asarray(imp.pos, np.float32)
    last = np.asarray(imp.last_pos, np.float32)
    pressed = np.asarray(imp.pressed, bool)
    n = pos.shape[0]
    if n == 0:
        raise ValueError("empty impulse script: nothing to replay")
    counter = {"i": 0}

    def src(t: float):
        i = counter["i"]
        counter["i"] = i + 1
        if i >= n:
            tail = tuple(pos[-1])
            return tail, tail, False
        return tuple(pos[i]), tuple(last[i]), bool(pressed[i])

    return src


def _recorded(device: torch.device) -> Optional[torch.cuda.Event]:
    """An event recorded on ``device``'s current stream; None on the CPU,
    where the work is done when the call returns."""
    if device.type != "cuda":
        return None
    done = torch.cuda.Event()
    done.record(torch.cuda.current_stream(device))
    return done


def queue_readback(device_frame: torch.Tensor):
    """Queue the host copy of a rendered (4, H, W) frame: ``(image, event)``.

    ``image`` is the (H, W, 4) uint8 host image of ``Simulation.frame_image``
    (the same bytes), whole once ``event`` has completed; on the CPU it is
    the numpy image itself and ``event`` is None.  On the card ``image`` is
    a pinned tensor from PyTorch's caching host allocator: a block returns
    to the cache when the sink keeps no reference to it, so a loop cycles
    through two blocks, and a sink that keeps its frames keeps blocks no
    later copy writes into."""
    with span("fluid.frame.layout"):
        img = Simulation.frame_layout(device_frame)
    with span("fluid.frame.readback_queue"):
        if img.device.type != "cuda":
            return img.numpy(), None
        host = torch.empty(img.shape, dtype=img.dtype, pin_memory=True)
        host.copy_(img, non_blocking=True)
        return host, _recorded(img.device)


def finish_readback(pending) -> np.ndarray:
    """Wait for a queued readback (its event alone) and return its image."""
    image, done = pending
    if done is None:
        return image
    with span("fluid.frame.readback_wait"):
        done.synchronize()
    return image.numpy()


class FluidApp:
    """Frame-driven run loop with real dt and live frame emission."""

    def __init__(self, config: FluidConfig,
                 input_source: Optional[InputSource] = None,
                 frame_sink: Optional[Callable[[np.ndarray], None]] = None,
                 fixed_dt: Optional[float] = None,
                 log: Callable[[str], None] = lambda s: None):
        with span("fluid.session.setup"):
            self.sim = Simulation(config)
            self.config = config
            self.input_source = input_source or orbit_source(config)
            self.frame_sink = frame_sink
            self.fixed_dt = fixed_dt
            self.log = log
            self.state: FluidState = self.sim.init()
        self.frames = 0
        self.min_compute = float("inf")
        self.max_compute = 0.0
        self.total_compute = 0.0

    def run(self, seconds: Optional[float] = None,
            max_frames: Optional[int] = None,
            pipelined: bool = False,
            stop_when: Optional[Callable[[], bool]] = None,
            on_frame: Optional[Callable[[FluidState, int], None]] = None,
            ) -> StageReport:
        """Run the frame loop.

        ``pipelined`` overlaps the next step's dispatch with the previous
        frame's device->host readback (one frame of display latency): the
        host waits on the previous frame's copy alone while the card runs
        the step just dispatched; per-frame compute times then measure wall
        time per frame.  Without it (or without a sink) the host waits for
        each step before the next.

        ``stop_when`` is polled each frame — the ESC-key analog
        (Main.cpp:215-216); interactive input sources pass their quit flag.

        ``on_frame(state, frame_count)`` is called after each completed
        frame — the CLI uses it for periodic checkpointing of long
        interactive sessions.
        """
        t_start = time.perf_counter()
        last_t = t_start
        fps_window_start = t_start
        fps_frames = 0
        sim_t = 0.0
        pending = None  # queued readback awaiting the sink (pipelined mode)
        device = self.sim.device

        def emit(readback):
            image = finish_readback(readback)
            with span("fluid.frame.sink"):
                self.frame_sink(image)

        while True:
            now = time.perf_counter()
            if seconds is not None and now - t_start >= seconds:
                break
            if max_frames is not None and self.frames >= max_frames:
                break
            if stop_when is not None and stop_when():
                break
            with span("fluid.frame", self.frames + 1):
                dt = self.fixed_dt if self.fixed_dt is not None else max(
                    1e-4, now - last_t)
                last_t = now
                sim_t += dt

                with span("fluid.frame.input"):
                    pos, last, pressed = self.input_source(sim_t)
                imp = single(pos, last, pressed, dt)

                c0 = time.perf_counter()
                self.state = self.sim.step(self.state, imp)
                stepped = _recorded(device)
                frame = None
                if self.frame_sink is not None:
                    frame = queue_readback(self.sim.render_fn(self.state))
                measured = True
                if pipelined and frame is not None:
                    if pending is not None:
                        emit(pending)  # waits on the PREVIOUS frame's copy
                    else:
                        measured = False  # first frame: nothing to wait on yet
                    pending = frame
                elif stepped is not None:
                    # without a sink there is nothing to pipeline against; always
                    # wait for the step so the host cannot run unboundedly ahead
                    with span("fluid.frame.readback_wait"):
                        stepped.synchronize()
                compute = time.perf_counter() - c0

                if not pipelined and frame is not None:
                    emit(frame)

                self.frames += 1
                fps_frames += 1
                if on_frame is not None:
                    on_frame(self.state, self.frames)
                if measured:
                    self.total_compute += compute
                    self.min_compute = min(self.min_compute, compute)
                    self.max_compute = max(self.max_compute, compute)

                if now - fps_window_start >= 0.5:  # 2 Hz readout, Main.cpp:143
                    self.log(
                        f"FPS: {fps_frames / (now - fps_window_start):.0f}     "
                        f"FRAME TIME: {1000.0 * (now - fps_window_start) / max(1, fps_frames):.2f}ms"
                    )
                    fps_window_start = now
                    fps_frames = 0

        if pending is not None:
            emit(pending)  # drain the pipelined tail frame

        report = StageReport(
            grid=f"{self.config.nx}x{self.config.ny}",
            steps=self.frames,
            total_s=self.total_compute,
        )
        report.stage_ms["Min frame"] = 1000.0 * (
            self.min_compute if self.frames else 0.0)
        report.stage_ms["Max frame"] = 1000.0 * self.max_compute
        return report
