"""The rollout loop and the kernel wrappers' host cost: the median over
segments of ms a step to enqueue 32 steps right after a synchronize (host
clock; after the traced window and outside it)."""

import statistics


def read(r):
    if r["kind"] != "rollout" or not r.get("enqueue_ms"):
        return None
    return statistics.median(r["enqueue_ms"])
