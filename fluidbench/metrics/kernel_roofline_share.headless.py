"""Headless rollouts: the step's stage bounds (``roofline.py``) times the
steps traced, over the device time of the kernels in the traced window
(copies, memsets and markers left out), in %."""


def read(r):
    t = r.get("trace")
    if (r["kind"] != "rollout" or not t or t["kernel_s"] <= 0
            or r.get("step_bound_s") is None):
        return None
    return 100.0 * r["step_bound_s"] * r["traced_steps"] / t["kernel_s"]
