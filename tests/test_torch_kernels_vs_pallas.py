"""The port's kernel wrappers H1–H4 against the JAX package's Pallas
kernels, on the CPU.

Here a wrapper is given CPU tensors, so it runs its plain version
(``cudafluidsimulation_tpu_torch/ops/ref.py``); the Pallas functions run in
interpret mode, exactly as ``tests/test_pallas.py`` calls them.  The CUDA
kernels themselves are held against the same plain versions on the card by
``chip_smoke.py``.

Tolerances, relative to the largest magnitude of the expected field:
- H1 advect 1e-5: the Pallas kernel sums the four taps as a masked
  shift-accumulation over a displacement window, another float32 order
  than the bilinear blend;
- H2 vorticity 1e-6: the same formulas in the same order;
- H3 diffusion 1e-5: 20 sweeps (and the splat's exp) carry last-ulp
  differences along;
- H4 pressure 1e-5: 40 sweeps from p = 0, as above.
"""

import os
import stat

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cudafluidsimulation_tpu.ops import advect_pallas, jacobi_pallas

from cudafluidsimulation_tpu_torch.ops import (
    _build, advect_cuda, jacobi_cuda, multigrid_cuda, ref)

torch.set_num_threads(1)

DT = np.float32(1 / 60)
KERNELS = (advect_cuda.KERNEL, jacobi_cuda.VORTICITY, jacobi_cuda.DIFFUSE,
           jacobi_cuda.PRESSURE, jacobi_cuda.PRESSURE_SOLVE,
           jacobi_cuda.STENCIL) + multigrid_cuda.KERNELS


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _close(got, exp, rtol):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    exp = np.asarray(exp)
    assert got.shape == exp.shape
    scale = max(float(np.max(np.abs(exp))), 1.0)
    np.testing.assert_allclose(got, exp, rtol=0, atol=rtol * scale)


def _vel(rng, h, w, scale):
    return ((rng.standard_normal((h, w)) * scale).astype(np.float32),
            (rng.standard_normal((h, w)) * scale).astype(np.float32))


@pytest.fixture
def launches():
    """Launch counts before the test; the CPU path must not move them."""
    before = [k.launches for k in KERNELS]
    yield
    assert [k.launches for k in KERNELS] == before


# -- H1 advect -------------------------------------------------------------------


@pytest.mark.parametrize("shape,scale", [((64, 128), 60.0), ((128, 128), 300.0)])
def test_h1_advect_velocity_vs_pallas(rng, launches, shape, scale):
    # |v|*dt reaches ~4*scale/60 cells; d=31 keeps every Pallas tap exact
    u, v = _vel(rng, *shape, scale)
    assert np.abs(np.stack([u, v])).max() * DT < 31
    gu, gv, gst = advect_cuda.advect_velocity(_t(u), _t(v), DT, 1.2,
                                              return_stats=True)
    eu, ev, est = advect_pallas.advect_velocity(
        jnp.asarray(u), jnp.asarray(v), DT, 1.2, d=31, return_stats=True)
    _close(gu, eu, 1e-5)
    _close(gv, ev, 1e-5)
    _close(gst, est, 1e-5)
    true = np.asarray([np.abs(gu.numpy()).max(), np.abs(gv.numpy()).max()])
    assert (gst.numpy() >= true).all()


def test_h1_advect_dye_vs_pallas(rng, launches):
    u, v = _vel(rng, 64, 128, 120.0)
    dye = rng.uniform(0.0, 1.0, (3, 64, 128)).astype(np.float32)
    got = advect_cuda.advect_dye(_t(dye), _t(u), _t(v), DT, 1.2)
    exp = advect_pallas.advect_dye(jnp.asarray(dye), jnp.asarray(u),
                                   jnp.asarray(v), DT, 1.2, d=15)
    _close(got, exp, 1e-5)


# -- H2 vorticity -------------------------------------------------------------------


@pytest.mark.parametrize("variant", ["gpu", "cpu"])
def test_h2_vorticity_vs_pallas(rng, launches, variant):
    u, v = _vel(rng, 64, 128, 5.0)
    vort = 50.0 if variant == "gpu" else 0.35
    gu, gv = jacobi_cuda.vorticity_confinement(_t(u), _t(v), DT, vort,
                                               variant=variant)
    eu, ev = jacobi_pallas.vorticity_confinement(
        jnp.asarray(u), jnp.asarray(v), DT, vort, variant=variant)
    _close(gu, eu, 1e-6)
    _close(gv, ev, 1e-6)


# -- H3 diffusion ---------------------------------------------------------------------


def test_h3_diffuse_multi_splat_vs_pallas(rng, launches):
    f = rng.standard_normal((5, 64, 128)).astype(np.float32)
    coeffs = [0.8, 0.8, 0.8, 0.8, 0.8]
    amps = np.asarray([-3.5, 2.25, 1.0, 0.5, 0.3], np.float32)
    last = np.asarray([70.5, 30.25], np.float32)
    got = jacobi_cuda.diffuse_multi_splat(_t(f), DT, coeffs, 20, amps, last, 400.0)
    exp = jacobi_pallas.diffuse_multi_splat(
        jnp.asarray(f), DT, jnp.asarray(coeffs, jnp.float32), 20,
        jnp.asarray(amps), jnp.asarray(last), 400.0)
    _close(got, exp, 1e-5)


@pytest.mark.parametrize("iters", [0, 5])
def test_h3_diffuse_vs_pallas(rng, launches, iters):
    f = rng.standard_normal((2, 64, 128)).astype(np.float32)
    got = jacobi_cuda.diffuse(_t(f), DT, 0.8, iters)
    exp = jacobi_pallas.diffuse(jnp.asarray(f), DT, 0.8, iters)
    _close(got, exp, 1e-5)


# -- H4 pressure ----------------------------------------------------------------------


@pytest.mark.parametrize("shape,iters,half", [((128, 128), 40, True),
                                              ((64, 128), 5, False)])
def test_h4_pressure_project_vs_pallas(rng, launches, shape, iters, half):
    u, v = _vel(rng, *shape, 10.0)
    gu, gv, gp, gst = jacobi_cuda.pressure_project(_t(u), _t(v), iters, half,
                                                   return_stats=True)
    eu, ev, ep, est = jacobi_pallas.pressure_project(
        jnp.asarray(u), jnp.asarray(v), iters, half, return_stats=True)
    for g, e in ((gu, eu), (gv, ev), (gp, ep), (gst, est)):
        _close(g, e, 1e-5)
    true = np.asarray([np.abs(gu.numpy()).max(), np.abs(gv.numpy()).max()])
    assert (gst.numpy() >= true).all()


# -- the wrappers' device rule -----------------------------------------------------------


def _meta(*shape):
    return torch.empty(shape, dtype=torch.float32, device="meta")


@pytest.mark.parametrize("call", [
    lambda: advect_cuda.advect_velocity(_meta(8, 8), _meta(8, 8), DT, 1.2),
    lambda: advect_cuda.advect_dye(_meta(3, 8, 8), _meta(8, 8), _meta(8, 8), DT, 1.2),
    lambda: jacobi_cuda.vorticity_confinement(_meta(8, 8), _meta(8, 8), DT, 1.0),
    lambda: jacobi_cuda.diffuse(_meta(2, 8, 8), DT, 0.8, 3),
    lambda: jacobi_cuda.diffuse_multi_splat(_meta(5, 8, 8), DT, [0.8] * 5, 3,
                                            [0.0] * 5, (1.0, 1.0), 4.0),
    lambda: jacobi_cuda.pressure_project(_meta(8, 8), _meta(8, 8), 3, True),
    lambda: jacobi_cuda.pressure_project(torch.zeros(8, 8), _meta(8, 8), 3, True),
], ids=["advect_velocity", "advect_dye", "vorticity", "diffuse",
        "diffuse_multi_splat", "pressure_project", "mixed_devices"])
def test_wrappers_raise_off_cpu_and_cuda(launches, call):
    # a wrapper runs its plain version only for CPU tensors; anything else
    # that is not a CUDA tensor is refused, never quietly computed
    with pytest.raises(ValueError):
        call()


def test_cpu_path_matches_plain_version_exactly(rng, launches):
    u, v = _vel(rng, 16, 24, 30.0)
    got = jacobi_cuda.pressure_project(_t(u), _t(v), 7, True, return_stats=True)
    exp = ref.pressure_project(_t(u), _t(v), 7, True, return_stats=True)
    for g, e in zip(got, exp):
        assert torch.equal(g, e)


# -- the build ---------------------------------------------------------------------------


def _fake_nvcc(tmp_path, body):
    bin_dir = tmp_path / "cuda" / "bin"
    bin_dir.mkdir(parents=True)
    nvcc = bin_dir / "nvcc"
    nvcc.write_text("#!/bin/sh\n" + body)
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    return tmp_path / "cuda"


def test_build_failure_raises_with_compiler_output(tmp_path, monkeypatch):
    home = _fake_nvcc(tmp_path, 'echo "advect.cu(3): error: boom" >&2\nexit 1\n')
    monkeypatch.setenv("CUDA_HOME", str(home))
    monkeypatch.setattr(_build, "BUILD", tmp_path / "build")
    with pytest.raises(RuntimeError, match="boom"):
        _build.build_all(["advect"])


def test_build_is_keyed_on_source_hash_and_reused(tmp_path, monkeypatch):
    # the fake compiler writes its -o target and counts its runs
    count = tmp_path / "runs"
    home = _fake_nvcc(tmp_path, f'echo run >> "{count}"\n'
                      'while [ "$1" != "-o" ]; do shift; done\n'
                      'echo lib > "$2"\necho "ptxas info : Used 8 registers"\n')
    monkeypatch.setenv("CUDA_HOME", str(home))
    monkeypatch.setattr(_build, "BUILD", tmp_path / "build")
    first = _build.build_all(["advect", "pressure"])
    assert len(count.read_text().split()) == 2  # one compiler per source
    assert _build.build_all(["advect", "pressure"]) == first
    assert len(count.read_text().split()) == 2  # unchanged sources: reused
    assert "registers" in _build.build_log("advect")
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for src in _build.CSRC.iterdir():
        (csrc / src.name).write_bytes(src.read_bytes())
    monkeypatch.setattr(_build, "CSRC", csrc)
    assert _build.build_all(["advect"]) == {"advect": first["advect"]}
    with open(csrc / "advect.cu", "a") as f:
        f.write("\n// edited\n")
    edited = _build.build_all(["advect"])["advect"]
    assert edited != first["advect"] and edited.is_file()
    assert len(count.read_text().split()) == 3
    assert not [p for p in os.listdir(tmp_path / "build") if p.endswith(".tmp")]
