"""Multigrid: V-cycles a solve, the port's completed cycles over its solves
(``utils.trace.counters()["mg_cycles"]`` and ``["mg_solves"]``, read at
the end of the run).  None where the port keeps no such counter or made no
solve."""


def read(r):
    try:
        from cudafluidsimulation_tpu_torch.utils import trace
    except ImportError:  # a port without the module
        return None
    c = trace.counters()
    solves, cycles = c.get("mg_solves"), c.get("mg_cycles")
    if not solves or cycles is None:
        return None
    return cycles / solves
