"""Live sessions: frames whose image reached the host in the window, over
the whole window (host clock; session set-ups inside it)."""


def read(r):
    if r["kind"] != "frames":
        return None
    return len(r["frame_s"]) / r["window_s"]
