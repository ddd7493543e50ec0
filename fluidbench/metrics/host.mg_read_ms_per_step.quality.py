"""Headless rollouts of the multigrid step solved to a residual target:
the host time of the port's ``fluid.mg.stopping_read`` spans in the traced
window (each a copy of the residual's mean to the host, which waits for the
card) over the traced steps, in ms.  None without a trace or the span."""


def read(r):
    t = r.get("trace")
    if r["kind"] != "rollout" or not t or not r.get("traced_steps"):
        return None
    reads = t.get("spans", {}).get("fluid.mg.stopping_read")
    if not reads:
        return None
    return 1e3 * reads["host_s"] / r["traced_steps"]
