"""``correct`` has to come out false for the control and for the faults a
cell can have, on the CPU at a small size.

- The control: the cell's own reference computed in bfloat16, in the
  program's place, from the same states (``check.judge(..., torch.bfloat16,
  ref)``).
- Faults planted underneath a whole run (the harness's look for a card
  skipped, the port's plain ops): a step that returns its state unchanged,
  and an answer altered where it is produced (one cell of the step's
  velocity; in a live cell also one pixel of the frame read back).  The
  step's fault is planted in the factory the cell's driver names
  (``step_factory``).  A batch and an exchange between chips are faults no
  cell here can have: each cell runs one simulation on one card.

Each cell's parts are taken by name, as a run takes them: its reference
(``spec.reference``), that reference's ``Params`` and its driver
(``spec.driver``).  The bodies take the harness root and the benchmark's
table, so a test can run them on a root it builds
(``test_fluidbench_plugins.py``).
"""

import collections
import importlib
import math

import pytest
import torch

from cudafluidsimulation_tpu_torch.models import app
from fluidbench import check, run, spec
from fluidbench.tests import small

CELLS = [c["name"] for c in small.BENCH["workloads"]]
LIVE = [c["name"] for c in small.BENCH["workloads"] if c["traffic"] == "live-frames"]


def _capture(workload, seed, root=spec.HERE, bench=small.BENCH):
    """One unit of the cell's own driver: its capture (or a list of them,
    one a judged member), the ``Params`` of the cell's own reference, the
    cell's limits and that reference."""
    _, conf, mix, limits = small.parts(workload, root=root, bench=bench)
    ref = spec.reference(conf.get("reference"), root)
    cfg = run.port_config(conf, "ref")
    cap = spec.driver(mix["kind"], root)(cfg, conf["fluid"], mix, seed).units(1)
    return cap, ref.Params.from_fluid(conf["fluid"]), limits, ref


def control_is_not_correct(workload, seed, root=spec.HERE, bench=small.BENCH):
    cap, params, limits, ref = _capture(workload, seed, root, bench)
    assert check.verdict(check.judge(cap, params, ref=ref), limits)
    ctl = check.judge(cap, params, torch.bfloat16, ref)
    assert not check.verdict(ctl, limits), ctl
    assert ctl["step_u"] > limits["step_u"] and ctl["step_dye"] > limits["step_dye"]


@pytest.mark.parametrize("seed", [1, 2, 3])
@pytest.mark.parametrize("workload", CELLS)
def test_the_bfloat16_control_is_not_correct(workload, seed):
    control_is_not_correct(workload, seed)


# A fault takes the real factory and gives the factory that replaces it.  A
# step takes the state first and returns the next one, of one simulation
# (u (H, W)) or of a batch of them (u (B, H, W)).


def _identity(real):
    return lambda *args, **kwargs: lambda state, *rest, **kw: state


def _altered(by):
    def fault(real):
        def factory(*args, **kwargs):
            step = real(*args, **kwargs)

            def altered(*args, **kwargs):
                out = step(*args, **kwargs)
                u = out.u.clone()
                h, w = u.shape[-2:]
                u[..., h // 2, w // 3] += by * max(1.0, float(u.abs().max()))
                return out._replace(u=u)

            return altered

        return factory

    return fault


def broken_step_is_not_correct(workload, fault, monkeypatch, root=spec.HERE,
                               bench=small.BENCH):
    mix = small.parts(workload, root=root, bench=bench)[2]
    module, name = spec.driver(mix["kind"], root).step_factory
    module = importlib.import_module(module)
    monkeypatch.setattr(module, name, fault(getattr(module, name)))
    res = small.run_small(workload, root=root, bench=bench)
    assert res["correct"] is False, res["checks"]


FAULTS = {"unchanged": _identity, "altered": _altered(0.01)}


@pytest.mark.parametrize("fault", list(FAULTS.values()), ids=list(FAULTS))
@pytest.mark.parametrize("workload", CELLS)
def test_a_broken_step_is_not_correct(workload, fault, monkeypatch):
    broken_step_is_not_correct(workload, fault, monkeypatch)


@pytest.mark.parametrize("shape", [(32, 40), (3, 32, 40)], ids=["one", "batched"])
def test_the_altered_step_changes_one_cell_of_each_member(shape):
    state = collections.namedtuple("State", "u v")
    u = torch.linspace(-3.0, 2.0, math.prod(shape)).reshape(shape)
    step = FAULTS["altered"](lambda config, ops=None: lambda s, imp: s)(None)
    moved = step(state(u, u), None).u - u
    assert int(moved.count_nonzero()) == math.prod(shape[:-2])
    assert torch.allclose(moved[..., 16, 13], torch.tensor(0.01 * 3.0), rtol=0, atol=1e-6)


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
    cap, params, limits, ref = _capture("parity-2048.orbit", 4)
    last = cap.states[cap.unit.steps]
    cap.states[cap.unit.steps] = last._replace(dye=last.dye * float("nan"))
    got = check.judge(cap, params, ref=ref)
    assert got["step_dye"] != got["step_dye"] and not check.verdict(got, limits)
