"""The port's plain PyTorch ops (``cudafluidsimulation_tpu_torch/ops/ref.py``)
against the JAX package's ``ops/ref.py`` and the independent NumPy oracle
(``tests/oracle.py``), on the same random float32 inputs.

Tolerance: 1e-6 relative to the largest magnitude of the expected field
(``_close``).  The formulas and their float32 association order are the
same on all three sides; what differs is the libraries' exp/pow/sqrt
rounding, and whether a compiler fuses a multiply and an add.  Integer
outputs (uint8 frames) must be equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cudafluidsimulation_tpu.ops import ref as jref
import oracle

from cudafluidsimulation_tpu_torch.config import PALETTE
from cudafluidsimulation_tpu_torch.ops import ref as tref

torch.set_num_threads(1)

RTOL = 1e-6
DT = np.float32(1 / 60)
H, W = 40, 56


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _close(got, exp, rtol=RTOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    exp = np.asarray(exp)
    assert got.shape == exp.shape
    scale = max(float(np.max(np.abs(exp))), 1.0)
    np.testing.assert_allclose(got, exp, rtol=0, atol=rtol * scale)


def _fields(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


# -- advection ----------------------------------------------------------------


def test_bilerp_negative_coordinates_extrapolate(rng):
    f = _fields(rng, 2, H, W)
    # positions well outside the domain on every side, incl. negative ones
    px = rng.uniform(-6.0, W + 5.0, (H, W)).astype(np.float32)
    py = rng.uniform(-6.0, H + 5.0, (H, W)).astype(np.float32)
    got = tref.bilerp(_t(f), _t(px), _t(py))
    _close(got, jref.bilerp(jnp.asarray(f), jnp.asarray(px), jnp.asarray(py)))
    _close(got, oracle.bilerp(f, px, py))
    # truncation, not floor: a sample at x = -0.5 extrapolates (tx < 0)
    row = np.zeros((1, 4), np.float32)
    row[0, 1] = 1.0
    got = tref.bilerp(_t(row), _t([[-0.5, 0, 0, 0]]), _t([[0, 0, 0, 0]]))
    assert float(got[0, 0]) == pytest.approx(-0.5)


@pytest.mark.parametrize("scale", [3.0, 400.0])  # sub-cell / far backtraces
def test_advect_velocity(rng, scale):
    u, v = _fields(rng, H, W, scale=scale), _fields(rng, H, W, scale=scale)
    gu, gv, gst = tref.advect_velocity(_t(u), _t(v), DT, 1.2, return_stats=True)
    eu, ev, est = jref.advect_velocity(jnp.asarray(u), jnp.asarray(v), DT, 1.2,
                                       return_stats=True)
    ou, ov = oracle.advect_velocity(u, v, DT, 1.2)
    for g, e, o in ((gu, eu, ou), (gv, ev, ov)):
        _close(g, e)
        _close(g, o)
    _close(gst, est)
    np.testing.assert_array_equal(gst.numpy(), [np.abs(gu.numpy()).max(),
                                                np.abs(gv.numpy()).max()])


def test_advect_dye_saturates_nan_to_one(rng):
    dye = rng.uniform(0.0, 1.0, (3, H, W)).astype(np.float32)
    # a left column of zeros next to ones: a backtrace to x < 0 extrapolates
    # below zero, pow(negative, 1.005) is NaN, and fmin(1, NaN) is 1
    dye[:, :, 0] = 0.0
    dye[:, :, 1] = 1.0
    u = np.full((H, W), 30.0, np.float32)  # dt*u = 0.5 cells to the left
    v = _fields(rng, H, W, scale=20.0)
    got = tref.advect_dye(_t(dye), _t(u), _t(v), DT, 1.2)
    exp = jref.advect_dye(jnp.asarray(dye), jnp.asarray(u), jnp.asarray(v), DT, 1.2)
    _close(got, exp)
    _close(got, oracle.advect_dye(dye, u, v, DT, 1.2))
    assert not torch.isnan(got).any()
    assert bool((got[:, :, 0] == 1.0).all())  # every x=0 cell saturated


# -- vorticity ------------------------------------------------------------------


def test_curl(rng):
    u, v = _fields(rng, H, W), _fields(rng, H, W)
    got = tref.curl(_t(u), _t(v))
    _close(got, jref.curl(jnp.asarray(u), jnp.asarray(v)))
    _close(got, oracle.curl(u, v))


@pytest.mark.parametrize("variant", ["cpu", "gpu"])
def test_vorticity_confinement(rng, variant):
    u, v = _fields(rng, H, W, scale=5.0), _fields(rng, H, W, scale=5.0)
    vort = 0.35 if variant == "cpu" else 50.0
    tfn = getattr(tref, f"vorticity_confinement_{variant}")
    jfn = getattr(jref, f"vorticity_confinement_{variant}")
    ofn = getattr(oracle, f"vorticity_{variant}")
    gu, gv = tfn(_t(u), _t(v), DT, vort)
    eu, ev = jfn(jnp.asarray(u), jnp.asarray(v), DT, vort)
    ou, ov = ofn(u, v, DT, vort)
    for g, e, o in ((gu, eu, ou), (gv, ev, ov)):
        _close(g, e)
        _close(g, o)


# -- diffusion -------------------------------------------------------------------


@pytest.mark.parametrize("iters", [0, 1, 5])
def test_diffuse(rng, iters):
    f = _fields(rng, 2, H, W)
    got = tref.diffuse(_t(f), DT, 0.8, iters)
    _close(got, jref.diffuse(jnp.asarray(f), DT, 0.8, iters))
    _close(got, oracle.diffuse(f, DT, 0.8, iters))
    if iters == 0:
        np.testing.assert_array_equal(got.numpy(), f)


@pytest.mark.parametrize("iters", [0, 3])
def test_diffuse_multi(rng, iters):
    f = _fields(rng, 5, H, W)
    coeffs = np.asarray([0.8, 0.8, 0.5, 0.5, 0.3], np.float32)
    got = tref.diffuse_multi(_t(f), DT, coeffs, iters)
    _close(got, jref.diffuse_multi(jnp.asarray(f), DT, jnp.asarray(coeffs), iters))
    for c in range(5):
        _close(got[c], oracle.diffuse(f[c], DT, coeffs[c], iters))


@pytest.mark.parametrize("iters", [0, 4])
def test_diffuse_multi_splat(rng, iters):
    f = _fields(rng, 5, H, W)
    coeffs = [0.8] * 5
    amps = np.asarray([-3.5, 2.0, 0.7, 0.2, 1.0], np.float32)
    last = np.asarray([20.5, 11.25], np.float32)
    got = tref.diffuse_multi_splat(_t(f), DT, coeffs, iters, amps, last, 40.0)
    exp = jref.diffuse_multi_splat(jnp.asarray(f), DT, jnp.asarray(coeffs), iters,
                                   jnp.asarray(amps), jnp.asarray(last), 40.0)
    _close(got, exp)


# -- pressure --------------------------------------------------------------------


@pytest.mark.parametrize("half", [False, True])
def test_divergence(rng, half):
    u, v = _fields(rng, H, W), _fields(rng, H, W)
    got = tref.divergence(_t(u), _t(v), half)
    _close(got, jref.divergence(jnp.asarray(u), jnp.asarray(v), half))
    _close(got, oracle.divergence(u, v, half))


@pytest.mark.parametrize("iters", [0, 1, 7])
def test_pressure_solve(rng, iters):
    d = _fields(rng, H, W)
    got = tref.pressure_solve(_t(d), iters)
    _close(got, jref.pressure_solve(jnp.asarray(d), iters))
    _close(got, oracle.pressure_solve(d, iters))
    if iters == 0:
        assert not got.any()


def test_project(rng):
    u, v, p = _fields(rng, H, W), _fields(rng, H, W), _fields(rng, H, W)
    gu, gv, gst = tref.project(_t(u), _t(v), _t(p), return_stats=True)
    eu, ev, est = jref.project(jnp.asarray(u), jnp.asarray(v), jnp.asarray(p),
                               return_stats=True)
    ou, ov = oracle.project(u, v, p)
    for g, e, o in ((gu, eu, ou), (gv, ev, ov)):
        _close(g, e)
        _close(g, o)
    _close(gst, est)


@pytest.mark.parametrize("iters,half", [(0, True), (5, False), (12, True)])
def test_pressure_project(rng, iters, half):
    u, v = _fields(rng, H, W, scale=4.0), _fields(rng, H, W, scale=4.0)
    gu, gv, gp, gst = tref.pressure_project(_t(u), _t(v), iters, half,
                                            return_stats=True)
    eu, ev, ep, est = jref.pressure_project(jnp.asarray(u), jnp.asarray(v),
                                            iters, half, return_stats=True)
    for g, e in ((gu, eu), (gv, ev), (gp, ep), (gst, est)):
        _close(g, e)
    op = oracle.pressure_solve(oracle.divergence(u, v, half), iters)
    _close(gp, op)


# -- splat, colour, boundary ---------------------------------------------------------


@pytest.mark.parametrize("kind", ["cpu", "gpu"])
def test_splat(rng, kind):
    u, v, dye = _fields(rng, H, W), _fields(rng, H, W), _fields(rng, 3, H, W)
    cur = np.asarray([30.25, 12.5], np.float32)
    last = np.asarray([27.0, 15.75], np.float32)
    color = np.asarray([1.0, 0.5, 0.3], np.float32)
    fs, radius = (500.0, 10.0) if kind == "cpu" else (5000.0, 400.0)
    got = getattr(tref, f"splat_{kind}")(_t(u), _t(v), _t(dye), cur, last, DT,
                                         fs, radius, color)
    exp = getattr(jref, f"splat_{kind}")(
        jnp.asarray(u), jnp.asarray(v), jnp.asarray(dye), jnp.asarray(cur),
        jnp.asarray(last), DT, jnp.float32(fs), radius, jnp.asarray(color))
    orc = getattr(oracle, f"splat_{kind}")(u, v, dye, cur, last, DT, fs, radius, color)
    for g, e, o in zip(got, exp, orc):
        _close(g, e)
        _close(g, o)


@pytest.mark.parametrize("press_time", [0.0, 0.25, 5.9, 6.0, 6.7, 7.3, 13.99, 20.5])
def test_cycle_color_across_palette_wrap(press_time):
    pal = np.asarray(PALETTE, np.float32)
    pt = np.float32(press_time)
    got = tref.cycle_color(pal, pt)
    assert got.dtype == torch.float32 and got.shape == (3,)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jref.cycle_color(jnp.asarray(pal), pt)))
    _close(got, oracle.cycle_color(PALETTE, pt))


def test_boundary_strip(rng):
    u, v, dye = _fields(rng, H, W), _fields(rng, H, W), _fields(rng, 3, H, W)
    got = tref.boundary_strip(_t(u), _t(v), _t(dye), 11)
    exp = jref.boundary_strip(jnp.asarray(u), jnp.asarray(v), jnp.asarray(dye), 11)
    orc = oracle.boundary_strip(u, v, dye, 11)
    for g, e, o in zip(got, exp, orc):
        np.testing.assert_array_equal(g.numpy(), np.asarray(e))
        np.testing.assert_array_equal(g.numpy(), o)
    same = tref.boundary_strip(_t(u), _t(v), _t(dye), 0)
    np.testing.assert_array_equal(same[0].numpy(), u)


# -- rendering -------------------------------------------------------------------


def _dye(rng):
    # covers negatives, the 255 clamp and values just under a uint8 step
    return rng.uniform(-0.2, 1.3, (3, H, W)).astype(np.float32)


def test_pack_rgba(rng):
    dye = _dye(rng)
    got = tref.pack_rgba(_t(dye))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), np.asarray(jref.pack_rgba(jnp.asarray(dye))))
    np.testing.assert_array_equal(got.numpy(), oracle.pack_rgba(dye))


def test_apply_bloom(rng):
    rgba = tref.pack_rgba(_t(_dye(rng)))
    pos = np.asarray([20.0, 14.5], np.float32)
    got = tref.apply_bloom(rgba, pos, 0.8, 12.0)
    exp = jref.apply_bloom(jnp.asarray(rgba.numpy()), jnp.asarray(pos), 0.8, 12.0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(exp))
    np.testing.assert_array_equal(got.numpy(), oracle.apply_bloom(rgba.numpy(), pos, 0.8, 12.0))


@pytest.mark.parametrize("active", [True, False])
def test_render_frame_equals_pack_plus_bloom(rng, active):
    dye = _dye(rng)
    pos = np.asarray([31.0, 9.0], np.float32)
    got = tref.render_frame(_t(dye), pos, 0.8, 12.0, active)
    packed = tref.pack_rgba(_t(dye))
    exp = tref.apply_bloom(packed, pos, 0.8, 12.0) if active else packed
    np.testing.assert_array_equal(got.numpy(), exp.numpy())
    jgot = jref.render_frame(jnp.asarray(dye), jnp.asarray(pos), 0.8, 12.0, active)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jgot))
