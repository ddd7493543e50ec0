"""The rollout loop and the kernel wrappers, in the live cells: the same
reading as ``host.planned_stages_per_step`` (the stage calls made through
a prepared launch a single step on the card), under a name of its own for
the metric it moves there."""

from fluidbench import spec


def read(r):
    return spec.reader("host.planned_stages_per_step")(r)
