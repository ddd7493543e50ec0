"""Live sessions: the 95th percentile (nearest rank) of every frame's time
in the window, from the previous frame's arrival at the sink (a session's
first frame: from its first loop iteration) to its own, in ms."""

import math


def read(r):
    if r["kind"] != "frames" or not r["frame_s"]:
        return None
    s = sorted(r["frame_s"])
    return 1e3 * s[math.ceil(0.95 * len(s)) - 1]
