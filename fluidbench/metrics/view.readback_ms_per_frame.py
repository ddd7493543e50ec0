"""Live sessions: the device time of the device-to-host copies in the
traced window (the frames' readback into pinned memory), ms a frame."""


def read(r):
    t = r.get("trace")
    if r["kind"] != "frames" or not t or t["readback_s"] <= 0 or not r.get("traced_frames"):
        return None
    return 1e3 * t["readback_s"] / r["traced_frames"]
