"""Build: the seconds this run's process spent hashing the kernels'
sources, compiling those not yet built and loading their libraries (the
port's own counter, ``utils.trace.counters()["build_s"]``, read at the end
of the run).  None where the port keeps no such counter."""


def read(r):
    try:
        from cudafluidsimulation_tpu_torch.utils import trace
    except ImportError:  # a port without the module
        return None
    return trace.counters()["build_s"]
