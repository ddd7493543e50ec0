"""The rollout loop and the kernel wrappers: the stage calls made through
a prepared launch a single step on the card, the port's own counters at
the end of the run (``utils.trace.counters()["planned_stages"]`` over
``["step_calls"]``; 4.0 where every stage of the parity step takes one).
None where the port keeps no such counter or made no such step."""


def read(r):
    try:
        from cudafluidsimulation_tpu_torch.utils import trace
    except ImportError:  # a port without the module
        return None
    c = trace.counters()
    steps, planned = c.get("step_calls"), c.get("planned_stages")
    if not steps or planned is None:
        return None
    return planned / steps
