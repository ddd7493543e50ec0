"""Headless rollouts, the pressure stage's kernels (H4 on the parity
step): the stage's bound (``stage_bound_s``, from the configuration's
reference's count of its stages) times the steps traced, over the device
time of the operations launched inside the port's
``fluid.step.pressure_projection`` spans in the traced window, in %.  None
without a trace, a bound or the span."""

STAGE = "pressure_projection"


def read(r):
    t, bound = r.get("trace"), r.get("stage_bound_s")
    if r["kind"] != "rollout" or not t or not bound or STAGE not in bound:
        return None
    span = t.get("spans", {}).get("fluid.step." + STAGE)
    if not span or span["device_s"] <= 0:
        return None
    return 100.0 * bound[STAGE] * r["traced_steps"] / span["device_s"]
