"""Timing on the card and the end-of-run report.

Times come from CUDA events around work enqueued on the current stream,
after a warm-up; there is no CPU fallback: a measurement without a CUDA
device raises.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List

import torch


@dataclass
class StageReport:
    grid: str
    steps: int
    total_s: float

    @property
    def steps_per_sec(self) -> float:
        return self.steps / self.total_s if self.total_s > 0 else float("inf")


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
