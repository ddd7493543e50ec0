"""Live sessions: the share of the traced window in which no device
operation ran, 1 - (union of the device operations) / (window), in %."""


def read(r):
    t = r.get("trace")
    if r["kind"] != "frames" or not t or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
