"""The comparison that decides ``correct``.

The flow is chaotic: a difference of one float32 rounding grows to the
size of the flow within ~50 steps at these parameters, so a rollout of the
program and one of the reference part whatever either computes.  The
reference therefore follows the program step by step, from the program's
own state, and the start and the hand-off between steps are checked by
themselves:

- ``step_<field>``: for the unit's first step (from ``init()``), its
  probe step (drawn from the seed) and its last step, the reference's step
  from the program's state before it against the program's state after
  it; the largest max|program - reference| / max(max|reference|, 1) over
  the three, one number a field (u, v, dye, pressure and the velocity
  bound the projection emits).
- ``counters``: the final state's time, pressed time, time since the last
  press, cursor and step count against the reference's recurrence over
  every input of the unit (a rollout that skipped or repeated a step, or
  lost the hand-off of its host state, shows here); the largest absolute
  difference.
- ``image`` (frames): the host images of the same three frames against
  the reference's render, flip and layout of the program's state of that
  frame; the largest difference in levels.

``judge(..., dtype=torch.bfloat16)`` puts the reference computed in
bfloat16 in the program's place: the control, which a sound limit fails.
``judge(..., ref=module)`` judges against a configuration's own reference
(``spec.reference``; the parity step by default), and ``judge`` of a list
of captures (an ensemble's judged members) gives each number as the worst
over them.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from fluidbench.reference import step as parity

FIELDS = ("u", "v", "dye", "pressure", "vel_stats")


def as_reference(state, ref=parity):
    """A program state as the input of reference ``ref`` (fields as they
    are, the host scalars as float32)."""
    return ref.State(state.u, state.v, state.dye, state.pressure, state.vel_stats,
                     np.float32(float(state.t)), np.float32(float(state.press_time)),
                     np.float32(float(state.time_since_press)),
                     np.asarray(state.mouse.numpy(), np.float32).reshape(2),
                     int(state.step))


def gap(got: torch.Tensor, exp: torch.Tensor) -> float:
    """max|got - exp| / max(max|exp|, 1); NaN anywhere reads NaN."""
    exp = exp.to(got.device, torch.float32)
    return float((got.to(torch.float32) - exp).abs().max()) / max(float(exp.abs().max()), 1.0)


def worse(a: float, b: float) -> float:
    """The larger of two readings, NaN being the worst."""
    return a if math.isnan(a) or a > b else b


def _scalars(s) -> np.ndarray:
    return np.asarray([s.t, s.press_time, s.time_since_press, s.mouse[0], s.mouse[1],
                       s.step], np.float64)


def judge(cap, params, dtype=torch.float32, ref=parity) -> Dict[str, float]:
    """The numbers compared for one unit's capture against reference
    ``ref`` (``params`` its ``Params``); with ``dtype`` lower than float32,
    the control's (the reference in that precision in the program's
    place).  For a list of captures, each number is the worst over them."""
    if isinstance(cap, (list, tuple)):
        numbers: Dict[str, float] = {}
        for c in cap:
            for k, v in judge(c, params, dtype, ref).items():
                numbers[k] = worse(v, numbers[k]) if k in numbers else v
        return numbers
    control = dtype != torch.float32
    out = {f"step_{f}": 0.0 for f in FIELDS}
    for n in cap.checked():
        before = as_reference(cap.states[n - 1], ref)
        imp = ref.Impulse(*cap.inputs[n - 1])
        exp = ref.step(params, before, imp)
        got = ref.step(params, before, imp, dtype) if control else as_reference(cap.states[n], ref)
        for f in FIELDS:
            out[f"step_{f}"] = worse(gap(getattr(got, f), getattr(exp, f)), out[f"step_{f}"])

    z = cap.states[0]
    exp = got = as_reference(z, ref)
    for imp in cap.inputs:
        exp = ref.host_scalars(exp, ref.Impulse(*imp))
        if control:
            got = ref.host_scalars(got, ref.Impulse(*imp), dtype)
    if not control:
        got = as_reference(cap.states[cap.unit.steps], ref)
    out["counters"] = float(np.abs(_scalars(got) - _scalars(exp)).max())

    if cap.images:
        worst = 0
        for n, image in cap.images.items():
            state = as_reference(cap.states[n], ref)
            exp_img = ref.render(params, state).cpu().numpy().astype(np.int32)
            got_img = (ref.render(params, state, dtype).cpu().numpy() if control
                       else np.asarray(image)).astype(np.int32)
            if got_img.shape != exp_img.shape:
                return {**out, "image": float("inf")}
            worst = max(worst, int(np.abs(got_img - exp_img).max()))
        out["image"] = float(worst)
    return out


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every number at or under its limit (NaN is over); a number with no
    limit, or a limit with no number, is a failure."""
    if set(numbers) != set(limits):
        return False
    return all(numbers[k] <= limits[k] for k in limits)
