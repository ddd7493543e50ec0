"""Readings for the limits of a cell's ``correct``, in one process.

    python3 -m fluidbench.calibrate --workload <name> --seeds 12 --first-seed <n>
        [--control 3] [--seconds 0.5]

For each of ``--seeds`` seeds it runs a short window of the cell's own
units at the cell's own size (at least one whole unit) and prints the
numbers ``check.judge`` compares for the window's last unit (the
program's readings); on the first ``--control`` seeds it also prints the
control's: the reference computed in bfloat16 put in the program's place,
from the same states.  The last line holds, for each number, the largest
program reading and the smallest control reading.  Benchmark runs never
run this; it is how the limits in ``limits/<workload>.json`` were read.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from fluidbench import check, run, spec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--first-seed", type=int, required=True)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=0.5)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("fluidbench.calibrate: no CUDA card", file=sys.stderr)
        return 2
    bench = spec.load_json(spec.BENCHMARK)
    cell = spec.workload(bench, args.workload)
    conf, mix = spec.config(cell["config"]), spec.traffic(cell["traffic"])
    cfg = run.port_config(conf, "cuda")
    ref = spec.reference(conf.get("reference"))
    params = ref.Params.from_fluid(conf["fluid"])
    make_driver = spec.driver(mix["kind"])
    lower, upper = {}, {}
    for i in range(args.seeds):
        seed = args.first_seed + i
        driver = make_driver(cfg, conf["fluid"], mix, seed)
        if i == 0:
            driver.units(2)
            torch.cuda.synchronize()
        rec = driver.window(args.seconds, torch.cuda.synchronize)
        cap = rec["capture"]  # or a list of captures, one a judged member
        first = cap[0] if isinstance(cap, (list, tuple)) else cap
        got = check.judge(cap, params, ref=ref)
        line = {"workload": args.workload, "seed": seed, "units": rec["units"],
                "probe": first.unit.probe, "program": got}
        for k, v in got.items():
            lower[k] = check.worse(v, lower.get(k, 0.0))
        if i < args.control:
            ctl = check.judge(cap, params, torch.bfloat16, ref)
            line["control"] = ctl
            for k, v in ctl.items():
                upper[k] = min(upper.get(k, float("inf")), v)
        print(json.dumps(line), flush=True)
        del driver, rec, cap
    print(json.dumps({"workload": args.workload, "seeds": args.seeds, "lower": lower,
                      "upper": upper, "kind": torch.cuda.get_device_name(),
                      "smi": run.power_limit()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
