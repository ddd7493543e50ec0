"""Seconds from the process's start to the window's start: imports, the
kernels' build or load, the configuration's step and the warm-up unit."""


def read(r):
    return r["setup_s"]
