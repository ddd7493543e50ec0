#!/usr/bin/env python3
"""Headline benchmark of the PyTorch/CUDA port: ``bench.py``'s line on the card.

    python3 bench_torch.py            # from the repository root; needs a CUDA device

Prints ONE JSON line with ``bench.py``'s keys (``metric``, ``value`` in
driven gpu-parity steps/s at 2048², ``vs_baseline``, the quiet, quality and
fast steps/s, ``max_displacement``, ``realized_max_displacement``,
``exact``) and beside them the card's name and power limit, the windows,
each rate's best window (``best_*``), ``setup_s`` and each row's windows
and device busy time (``rows``).  Each rate is the median of 5 windows
after a warm-up (``cudafluidsimulation_tpu_torch/bench.py`` says how a
window is timed).  Without a CUDA device it raises; a row that fails
leaves the line printed with that row null, and the exit code is 1.
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

from cudafluidsimulation_tpu_torch.bench import headline_main  # noqa: E402

if __name__ == "__main__":
    sys.exit(headline_main())
