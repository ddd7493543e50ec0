"""Kernels: H4's passes over device memory a call, the launches of its
wavefront kernel over its calls on the card (the port's own counters,
``utils.trace.counters()["pressure_passes"]`` and ``["pressure_calls"]``,
read at the end of the run).  None where the port keeps no such counter
or made no such call."""


def read(r):
    try:
        from cudafluidsimulation_tpu_torch.utils import trace
    except ImportError:  # a port without the module
        return None
    c = trace.counters()
    calls, passes = c.get("pressure_calls"), c.get("pressure_passes")
    if not calls or passes is None:
        return None
    return passes / calls
