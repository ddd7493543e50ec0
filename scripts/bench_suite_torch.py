#!/usr/bin/env python3
"""Benchmark suite of the PyTorch/CUDA port over the BASELINE.json configs,
on the card: ``scripts/bench_suite.py``'s rows.

    python3 scripts/bench_suite_torch.py                 # needs a CUDA device
    BENCH_16384=1 python3 scripts/bench_suite_torch.py   # adds 16384² x 8

One JSON line per row (``config``, ``steps_per_sec``, ``gcell_per_sec``,
``vs_ref_gpu_gcell`` and the row's extras, the card's name and power
limit, the windows, the best window's rates and the device busy time):

  1. 256² cpu parity, 100 steps, a splat held at the centre
  2. the reference's own 960x540 workload, 200 steps (``vs_ref_gpu_fps``)
  3. 1024² x 1000 steps, 40 pressure sweeps
  4. 2048² x 100 with an RGBA frame rendered every step
  5. the 64 x 512² viscosity-sweep ensemble, 100 steps
  6. 8192² x 24 on one card, 100 pressure sweeps (7. 16384² x 8 under
     ``BENCH_16384=1``)
  8. the solver frontier at 2048²: Jacobi-40, multigrid-2 and the quality
     preset, each with its pressure residual
  9. 8192² x 20 over 8 shards of a rows mesh on the visible cards, then the
     traffic models of one sharded step (rows, 2 x 4, multigrid) as counts

``cudafluidsimulation_tpu_torch/bench.py`` holds the rows and says how a
window is timed.  Without a CUDA device it raises; a row that fails prints
its ``config`` with ``steps_per_sec`` null and ``error``, and the exit code
is 1.
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from cudafluidsimulation_tpu_torch.bench import suite_main  # noqa: E402

if __name__ == "__main__":
    sys.exit(suite_main())
