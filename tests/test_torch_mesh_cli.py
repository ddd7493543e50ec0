"""The port's CLI with ``--mesh`` against the JAX CLI's, the multi-chip dry
run and the 2-D example, on CPU shards.

- ``--mesh rows|2d --mesh-devices 8`` (8 CPU shards, placed round-robin on
  the one CPU device, which a line says) and the JAX CLI's ``--mesh`` on its
  8 virtual devices give fields within 1e-5 of scale over 4 steps, with
  the same mesh line; frames, health checks and checkpoints gather the
  state, and the port's mesh run equals its own sharded rollout bit for bit;
  ``--report`` keeps the whole-step rows and skips the sampled stage rows
  with JAX's note; the clamp warning fires where the realized displacement
  outran the halo, on the axes ``clamp_axes`` names.
- ``entry.dryrun_multichip(8)`` on CPU shards: both meshes, both schedules,
  the kernel steps' 5 and 10 exchange pairs, the wrappers called.
"""

import re

import numpy as np
import pytest
import torch

from cudafluidsimulation_tpu import cli as jcli

from cudafluidsimulation_tpu_torch import FluidConfig, cli, init_state
from cudafluidsimulation_tpu_torch.entry import dryrun_multichip
from cudafluidsimulation_tpu_torch.parallel import mesh as tmesh
from cudafluidsimulation_tpu_torch.parallel.shardmap2d import make_shardmap2d_rollout
from cudafluidsimulation_tpu_torch.utils import impulse as timp
from cudafluidsimulation_tpu_torch.utils.checkpoint import load_state

torch.set_num_threads(1)

RTOL = 1e-5
FIELDS = ("u", "v", "dye", "pressure")
# the gpu reference's sweeps (20 diffusion, 30 pressure): its chaotic
# parameters keep 4 steps within rounding there (fewer sweeps amplify more)
BASE = ["--grid", "128", "--backend", "ref", "--steps", "4", "--mesh-devices", "8"]


def _fields(path):
    with np.load(path) as d:
        return {k: d[k] for k in FIELDS}


def _mesh_line(text):
    return re.findall(r"^mesh: \d+ devices, .*$", text, flags=re.M)


@pytest.mark.parametrize("impulse", ["orbit", "center"])
@pytest.mark.parametrize("mesh", ["rows", "2d"])
def test_mesh_cli_matches_jax_cli(tmp_path, capsys, mesh, impulse):
    argv = BASE + ["--mesh", mesh, "--impulse", impulse]
    assert jcli.main(argv + ["--save-fields", str(tmp_path / "jax.npz")]) == 0
    jout = capsys.readouterr().out
    assert cli.main(argv + ["--save-fields", str(tmp_path / "port.npz")]) == 0
    out = capsys.readouterr().out
    assert _mesh_line(out) == _mesh_line(jout) != []
    assert "mesh: 8 shards on 1 cpu device(s), placed round-robin" in out
    exp, got = _fields(tmp_path / "jax.npz"), _fields(tmp_path / "port.npz")
    for k in FIELDS:
        scale = max(float(np.abs(exp[k]).max()), 1.0)
        np.testing.assert_allclose(got[k], exp[k], rtol=0, atol=RTOL * scale, err_msg=k)
    assert np.abs(got["dye"]).max() > 0


def test_mesh_cli_gathers_frames_health_and_checkpoints(tmp_path, capsys):
    ckpt = tmp_path / "c.npz"
    argv = BASE + ["--mesh", "2d", "--impulse", "orbit", "--steps", "6",
                   "--frames-dir", str(tmp_path / "frames"), "--frame-every", "3",
                   "--health", "--checkpoint", str(ckpt), "--checkpoint-every", "3",
                   "--save-fields", str(tmp_path / "f.npz"), "--report"]
    assert cli.main(argv) == 0
    out = capsys.readouterr().out
    assert len(list((tmp_path / "frames").glob("frame_*.png"))) == 2
    assert "skipped with --mesh" in out and "Average compute time" in out
    assert "Min frame" in out
    # the CLI's run is the sharded rollout's, bit for bit
    cfg = FluidConfig.gpu_reference(nx=128, ny=128, backend="ref")
    mesh = tmesh.make_mesh2d(2, 4, devices=["cpu"] * 8)
    imp = timp.orbit_impulse(6, cfg.dt, center=(64, 64), radius=16, omega=3.0)
    state = tmesh.gather_state(make_shardmap2d_rollout(cfg, mesh)(
        tmesh.shard_state(init_state(cfg, device="cpu"), mesh), imp))
    fields = _fields(tmp_path / "f.npz")
    saved = load_state(str(ckpt), device="cpu")
    for k in FIELDS:
        np.testing.assert_array_equal(fields[k], getattr(state, k).numpy(), err_msg=k)
        np.testing.assert_array_equal(getattr(saved, k).numpy(), fields[k], err_msg=k)
    assert int(saved.step) == 6


def _warnings(text):
    return re.findall(r"^warning: advection clamp.*$", text, flags=re.M)


@pytest.mark.parametrize("mesh", ["rows", "2d"])
def test_mesh_clamp_warning(capsys, mesh):
    # the gpu reference's force at max displacement 1 outruns the halo
    argv = ["--grid", "64", "--backend", "ref", "--steps", "3", "--mesh", mesh,
            "--mesh-devices", "4", "--impulse", "orbit", "--max-displacement", "1",
            "--diffusion-iters", "2", "--pressure-iters", "2"]
    assert jcli.main(argv) == 0
    jout = capsys.readouterr().out
    assert cli.main(argv) == 0
    out = capsys.readouterr().out
    assert _warnings(out) == _warnings(jout) != []
    assert "|v|*dt" in _warnings(out)[0]


def test_dryrun_multichip_on_cpu_shards():
    out = dryrun_multichip(8, device="cpu")
    assert out["rows cuda pairs"] == 5 and out["2d cuda pairs"] == 10
    assert out["rows ref pairs"] > 5 and out["2d ref pairs"] > 10
    for kind in ("rows", "2d"):
        calls = out[f"{kind} wrapper calls"]
        assert calls["advect"] == 2 * 8 and calls["pressure_solve"] >= 8
        assert "launches by shard" not in str(out)


def test_example_runs_on_cpu_shards(capsys):
    import runpy

    ex = runpy.run_path("examples/multichip_2d_torch.py", run_name="example")
    out = ex["main"](cpu=True, n=128, steps=3)
    assert bool(torch.isfinite(out.u).all())
    assert "per-shard per-step collective schedule" in capsys.readouterr().out
