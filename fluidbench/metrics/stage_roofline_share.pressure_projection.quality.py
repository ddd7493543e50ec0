"""Headless rollouts of the multigrid step solved to a residual target, its
pressure stage's kernels (H5 and H6): the stage's bounds (``stage_bound_s``,
from the configuration's reference's count) for the work the traced window
did, ``pressure_projection`` once a traced step and ``mg_cycle`` once a
traced ``fluid.mg.cycle`` span, over the device time of the operations
launched inside the port's ``fluid.step.pressure_projection`` spans and
every ``fluid.mg.*`` span in that window, in %.  None without a trace,
the two bounds or a ``fluid.mg.cycle`` span (a port without it)."""

STAGE, CYCLE = "pressure_projection", "mg_cycle"


def read(r):
    t, bound = r.get("trace"), r.get("stage_bound_s")
    if r["kind"] != "rollout" or not t or not bound or STAGE not in bound or CYCLE not in bound:
        return None
    spans = t.get("spans", {})
    cycles = spans.get("fluid.mg.cycle")
    if not cycles:
        return None
    device = spans.get("fluid.step." + STAGE, {}).get("device_s", 0.0) + sum(
        s["device_s"] for name, s in spans.items() if name.startswith("fluid.mg."))
    if device <= 0:
        return None
    return 100.0 * (bound[STAGE] * r["traced_steps"] + bound[CYCLE] * cycles["count"]) / device
