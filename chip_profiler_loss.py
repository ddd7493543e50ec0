#!/usr/bin/env python3
"""How many device records a ``torch.profiler`` session on the card loses,
by the age of the process that opens it.

    python3 chip_profiler_loss.py [--seconds 180]    # needs one CUDA device

The process keeps the card busy with matrix products between sessions (as
a long script does) and every ~8 s opens a session (CPU and CUDA activity)
over 32 spin kernels, 20 elementwise kernels and 8 spin kernels, each group
after a synchronize.  One JSON line a session: the process's age, the spin
kernels recorded before the first elementwise one (32 when none was lost),
the device records of the 60 launched, and the card's name and power
limit.  ``chip_smoke.py`` and the CLI's ``--profile-dir`` pad their traces
with spin kernels at each end because of what this shows.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import torch


def session(x: torch.Tensor):
    """(spin kernels before the first elementwise record, device records)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(0.01)
        for _ in range(32):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        time.sleep(0.01)
        for _ in range(20):
            x.add_(1.0)
        torch.cuda.synchronize()
        for _ in range(8):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()
    recs = sorted((e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA),
                  key=lambda e: e.time_range.start)
    spin = ["spin_kernel" in e.name for e in recs]
    return (spin.index(False) if False in spin else len(spin)), len(recs)


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seconds", type=float, default=180.0)
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("chip_profiler_loss: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    t_proc = time.perf_counter()
    x = torch.randn(4096, 4096, device="cuda")
    while time.perf_counter() - t_proc < args.seconds:
        t_busy = time.perf_counter()
        while time.perf_counter() - t_busy < 8.0:
            x @ x
            torch.cuda.synchronize()
        lead, records = session(x)
        print(json.dumps({"age_s": time.perf_counter() - t_proc, "leading_spins": lead,
                          "device_records": records, "launched": 60, "smi": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
