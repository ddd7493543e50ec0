"""Kernels, in the live cells: the same reading as
``kernels.pressure_passes_per_call`` (H4's passes over device memory a
call), under a name of its own for the metric it moves there."""

from fluidbench import spec


def read(r):
    return spec.reader("kernels.pressure_passes_per_call")(r)
