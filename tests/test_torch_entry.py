"""The port's entry point and headless example against the JAX package's,
on the CPU.

- ``entry(backend="ref", device="cpu")``: the 512² gpu-parity step and its
  arguments; one step within 1e-5 of each field's largest magnitude of JAX's
  ``__graft_entry__.entry()`` step (the plain ops on the CPU), the same
  scalar state, and the default backend raising without a card.
- ``examples/headless_run_torch.py``: frames through ``FrameSink`` and a
  checkpoint that loads, equal to the collected rollout.
- ``dryrun_multichip``'s first part on CPU shards, the batched global step
  on the (ens, x) mesh of the JAX dry run (ens = 2 for an even count): its
  mesh, both schedules, the kernel wrappers called where x > 1; and that
  step at the dry run's shapes within 1e-5 of JAX's ``make_sharded_step``,
  on both schedules.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import __graft_entry__ as jentry

from cudafluidsimulation_tpu_torch import FluidConfig, Simulation, interop
from cudafluidsimulation_tpu_torch.entry import dryrun_multichip, entry
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


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_dryrun_runs_the_ens_x_step_first(n):
    out = dryrun_multichip(n, device="cpu")
    ens = 2 if n % 2 == 0 and n > 1 else 1
    x = n // ens
    assert list(out)[:3] == ["ens x ref collectives", "ens x cuda collectives", "ens x mesh"]
    assert out["ens x mesh"] == {"ens": ens, "x": x}
    gathers = 1 if x > 1 else 0  # one all_gather a step for the advection
    assert out["ens x ref collectives"]["all_gather"] == gathers
    assert out["ens x cuda collectives"]["all_gather"] == gathers
    if x > 1:
        calls = out["ens x wrapper calls"]
        assert calls["advect"] == 2 * n and calls["pressure_solve"] >= n
    assert "launches by shard" not in str(out)


@pytest.mark.parametrize("schedule", ["ref", "kernels"])
@pytest.mark.parametrize("n", [2, 8])
def test_dryrun_ens_x_step_matches_jax(n, schedule):
    import jax
    import jax.numpy as jnp

    from cudafluidsimulation_tpu import FluidConfig as JConfig
    from cudafluidsimulation_tpu import init_state as jinit
    from cudafluidsimulation_tpu.parallel import sharded as jsh
    from cudafluidsimulation_tpu.utils.impulse import Impulse as JImpulse
    from cudafluidsimulation_tpu.utils.impulse import single as jsingle

    from cudafluidsimulation_tpu_torch.models.ensemble import batched_state
    from cudafluidsimulation_tpu_torch.parallel import mesh as pmesh
    from cudafluidsimulation_tpu_torch.parallel import sharded, shardmap_step
    from cudafluidsimulation_tpu_torch.utils.impulse import Impulse, single

    ens, x = 2, n // 2
    ny = max(32, 16 * x)
    jcfg = JConfig.gpu_reference(nx=128, ny=ny, backend="ref", diffusion_iters=4,
                                 pressure_iters=8)
    jmesh = jsh.make_mesh(n, ens=ens, devices=jax.devices()[:n])
    jstate = jsh.shard_state(jax.tree.map(lambda a: jnp.stack([a] * ens), jinit(jcfg)), jmesh,
                             batched=True)
    jimp = JImpulse(*(jnp.stack([f] * ens) for f in jsingle(
        (64.0, ny / 2.0), (60.0, ny / 2.0 - 2.0), True, jcfg.dt)))
    exp = jsh.make_sharded_step(jcfg, jmesh, batched=True)(jstate, jimp)
    exp = {k: np.asarray(a) for k, a in exp._asdict().items()}
    cfg = interop.config_from_jax(jcfg)
    mesh = sharded.make_mesh(n, ens=ens, devices=["cpu"])
    imp = Impulse(*(torch.stack([f] * ens) for f in single(
        (64.0, ny / 2.0), (60.0, ny / 2.0 - 2.0), True, cfg.dt)))
    kernels = shardmap_step.KERNELS if schedule == "kernels" else None
    step = sharded.make_sharded_step(cfg, mesh, batched=True, kernels=kernels)
    got = step(sharded.shard_state(batched_state(cfg, ens, "cpu"), mesh, batched=True), imp)
    got = interop.state_to_numpy(pmesh.gather_state(got))
    assert got["u"].shape == (ens, ny, 128) and np.isfinite(got["u"]).all()
    assert np.abs(got["dye"]).max() > 0
    for k in ("u", "v", "dye", "pressure", "vel_stats"):
        scale = max(float(np.abs(exp[k]).max()), 1.0)
        np.testing.assert_allclose(got[k], exp[k], rtol=0, atol=RTOL * scale, err_msg=k)
    for k in ("t", "press_time", "time_since_press", "mouse", "step"):
        np.testing.assert_array_equal(got[k], exp[k], err_msg=k)
