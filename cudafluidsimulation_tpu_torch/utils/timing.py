"""Timing on the card and the end-of-run report.

Times come from CUDA events around work enqueued on the current stream,
after a warm-up.  :func:`cuda_times_ms` has no CPU fallback: a measurement
without a CUDA device raises.  :func:`time_stage` times where the work's
tensors lie: CUDA events for tensors on the card, ``time.perf_counter``
for tensors on the CPU (a simulation the caller built there, on the
``ref`` backend).
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List

import torch


@dataclass
class StageReport:
    grid: str
    steps: int
    total_s: float
    stage_ms: Dict[str, float] = field(default_factory=dict)

    @property
    def steps_per_sec(self) -> float:
        return self.steps / self.total_s if self.total_s > 0 else float("inf")

    def format(self) -> str:
        # Same shape as the reference's exit report (Main.cpp:195-206).
        lines = [
            "================ SIMULATION END ======================",
            f"Grid: {self.grid}   Steps: {self.steps}",
            "------------------------------------------------------",
            f"Average compute time: {1000.0 * self.total_s / max(1, self.steps):.3f}ms / step",
            f"Throughput: {self.steps_per_sec:.1f} steps/s",
            "------------------------------------------------------",
        ]
        for name, ms in self.stage_ms.items():
            lines.append(f"{name} compute time: {ms:.3f}ms")
        lines.append("======================================================")
        return "\n".join(lines)


def cuda_times_ms(fn: Callable[[], object], iters: int = 5,
                  warmup: int = 1) -> List[float]:
    """Milliseconds of each of ``iters`` calls of ``fn`` on the card, by
    CUDA events on the current stream, after ``warmup`` untimed calls."""
    if not torch.cuda.is_available():
        raise RuntimeError("timing needs a CUDA device")
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return times


def time_stage(body, carry: tuple, n: int = 24, iters: int = 3,
               warmup: int = 1) -> float:
    """Best-of seconds per application of ``body``: ``n`` applications with
    each output threaded back in as the next input (``body(carry) ->
    carry``), timed as one window, best of ``iters`` windows after
    ``warmup`` untimed ones.  The JAX package's ``time_scanned`` runs the
    same loop as one ``lax.scan``; eager PyTorch hoists nothing, so no
    formal dependence is needed, but the carry is threaded all the same so
    that a stage whose cost follows the flow sees the flow it made.

    CUDA events time tensors on the card (``carry[0]``'s device); on the
    CPU the work is synchronous and ``time.perf_counter`` times it."""
    on_card = carry[0].device.type == "cuda"

    def window() -> float:
        c = carry
        if on_card:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(n):
                c = body(c)
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / 1000.0
        t0 = time.perf_counter()
        for _ in range(n):
            c = body(c)
        return time.perf_counter() - t0

    with torch.cuda.device(carry[0].device) if on_card else contextlib.nullcontext():
        for _ in range(warmup):
            window()
        best = min(window() for _ in range(iters))
    return best / n
