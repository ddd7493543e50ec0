"""``correct`` has to come out false for the control and for the faults a
cell can have, on the CPU at a small size.

- The control: the reference computed in bfloat16, in the program's
  place, from the same states (``check.judge(..., torch.bfloat16)``).
- Faults planted underneath a whole run (the harness's look for a card
  skipped, the port's plain ops): a step that returns its state unchanged,
  and an answer altered where it is produced (one cell of the step's
  velocity; in a live cell also one pixel of the frame read back).  A
  batch and an exchange between chips are faults no cell here can have:
  each cell runs one simulation on one card.
"""

import pytest
import torch

from cudafluidsimulation_tpu_torch.models import app, simulation
from cudafluidsimulation_tpu_torch.models.pipelines import make_step
from fluidbench import check, drive, run
from fluidbench.reference.step import Params
from fluidbench.tests import small

CELLS = [c["name"] for c in small.BENCH["workloads"]]
LIVE = [c["name"] for c in small.BENCH["workloads"] if c["traffic"] == "live-frames"]


def _capture(workload, seed):
    cell, conf, mix, limits = small.parts(workload)
    cfg = run.port_config(conf, "ref")
    cap = drive.DRIVERS[mix["kind"]](cfg, conf["fluid"], mix, seed).units(1)
    return cap, Params.from_fluid(conf["fluid"]), limits


@pytest.mark.parametrize("seed", [1, 2, 3])
@pytest.mark.parametrize("workload", CELLS)
def test_the_bfloat16_control_is_not_correct(workload, seed):
    cap, params, limits = _capture(workload, seed)
    assert check.verdict(check.judge(cap, params), limits)
    ctl = check.judge(cap, params, torch.bfloat16)
    assert not check.verdict(ctl, limits), ctl
    assert ctl["step_u"] > limits["step_u"] and ctl["step_dye"] > limits["step_dye"]


def _identity(config, ops=None):
    return lambda state, imp: state


def _altered(by):
    def fault(config, ops=None):
        real = make_step(config, ops)

        def step(state, imp):
            out = real(state, imp)
            u = out.u.clone()
            h, w = u.shape
            u[h // 2, w // 3] += by * max(1.0, float(u.abs().max()))
            return out._replace(u=u)

        return step

    return fault


@pytest.mark.parametrize("fault", [_identity, _altered(0.01)], ids=["unchanged", "altered"])
@pytest.mark.parametrize("workload", CELLS)
def test_a_broken_step_is_not_correct(workload, fault, monkeypatch):
    monkeypatch.setattr(simulation, "make_step", fault)
    res = small.run_small(workload)
    assert res["correct"] is False, res["checks"]


@pytest.mark.parametrize("workload", LIVE)
def test_an_altered_image_is_not_correct(workload, monkeypatch):
    real = app.queue_readback

    def altered(frame):
        image, done = real(frame)
        image = image.copy()
        image[1, 2, 0] ^= 4
        return image, done

    monkeypatch.setattr(app, "queue_readback", altered)
    res = small.run_small(workload)
    assert res["correct"] is False and res["checks"]["image"]["value"] == 4


def test_a_nan_reading_is_not_correct():
    cap, params, limits = _capture("parity-2048.orbit", 4)
    last = cap.states[cap.unit.steps]
    cap.states[cap.unit.steps] = last._replace(dye=last.dye * float("nan"))
    got = check.judge(cap, params)
    assert got["step_dye"] != got["step_dye"] and not check.verdict(got, limits)
