"""The port's entry point and headless example against the JAX package's,
on the CPU.

- ``entry(backend="ref", device="cpu")``: the 512² gpu-parity step and its
  arguments; one step within 1e-5 of each field's largest magnitude of JAX's
  ``__graft_entry__.entry()`` step (the plain ops on the CPU), the same
  scalar state, and the default backend raising without a card.
- ``examples/headless_run_torch.py``: frames through ``FrameSink`` and a
  checkpoint that loads, equal to the collected rollout.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import __graft_entry__ as jentry

from cudafluidsimulation_tpu_torch import FluidConfig, Simulation, interop
from cudafluidsimulation_tpu_torch.entry import entry
from cudafluidsimulation_tpu_torch.utils.checkpoint import load_state
from cudafluidsimulation_tpu_torch.utils.impulse import orbit_impulse

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
RTOL = 1e-5


def test_entry_step_matches_jax():
    step, (state, imp) = entry(backend="ref", device="cpu")
    jstep, (jstate, jimp) = jentry.entry()
    assert state.u.shape == (512, 512) and state.u.device.type == "cpu"
    for got, exp in zip(imp, jimp):
        np.testing.assert_array_equal(got.numpy(), np.asarray(exp))
    got = interop.state_to_numpy(step(state, imp))
    exp = {k: np.asarray(x) for k, x in jstep(jstate, jimp)._asdict().items()}
    for k in ("u", "v", "dye", "pressure", "vel_stats"):
        scale = max(float(np.abs(exp[k]).max()), 1.0)
        np.testing.assert_allclose(got[k], exp[k], rtol=0, atol=RTOL * scale, err_msg=k)
    for k in ("t", "press_time", "time_since_press", "mouse", "step"):
        np.testing.assert_array_equal(got[k], exp[k], err_msg=k)
    assert np.abs(got["dye"]).max() > 0


def test_entry_runs_on_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="ref"):
        entry()


def test_headless_example(tmp_path, capsys):
    spec = importlib.util.spec_from_file_location(
        "headless_run_torch", ROOT / "examples" / "headless_run_torch.py")
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    state = example.main(str(tmp_path), grid=64, steps=30, backend="ref")
    frames = sorted((tmp_path / "out_frames").glob("frame_*.png"))
    assert len(frames) == 3
    assert "wrote 3 frames" in capsys.readouterr().out
    ck = load_state(str(tmp_path / "out_state.npz"), "cpu")
    assert int(ck.step) == 30
    cfg = FluidConfig.gpu_reference(nx=64, ny=64, backend="ref")
    sim = Simulation(cfg)
    exp = sim.run(sim.init(), orbit_impulse(30, cfg.dt, center=(32, 32), radius=8, omega=3.0))
    for k in ("u", "v", "dye", "pressure"):
        assert torch.equal(getattr(ck, k), getattr(exp, k)), k
        assert torch.equal(getattr(state, k), getattr(exp, k)), k
