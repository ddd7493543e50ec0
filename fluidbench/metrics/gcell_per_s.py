"""Headless rollouts: cells x steps completed in the window over the whole
window (host clock, closed by a synchronize), in billions a second."""


def read(r):
    if r["kind"] != "rollout":
        return None
    return r["cells"] * r["steps"] / r["window_s"] / 1e9
