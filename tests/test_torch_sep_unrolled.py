"""H7's unrolled kernel (``csrc/sepdiffuse.cu`` ``sep_kernel_unrolled``) on
the CPU: the wrapper's choice of kernel by radii, its tile planning, and
its order of sums.

The kernel runs only on the card (``chip_smoke.py`` holds it there bit for
bit against ``fastdiffuse.sep_apply`` without the splat).  Here
``emulate`` runs its schedule in plain torch: a 64 x 128 tile of each
channel loaded with its rmax ring at half-sample symmetric coordinates;
per rank an x pass in which a lane computes 4 neighbouring outputs of a
row from a 16-float window of the tile, then a y pass in which each warp
walks its 8 output rows down the x sums, adding each x-sum row's products
to the outputs it reaches in tap order.  It must be bit-equal to the plain
version, which holds the JAX package's order of sums
(tests/test_torch_fast.py).
"""

import numpy as np
import pytest
import torch

from cudafluidsimulation_tpu_torch.ops import fastdiffuse, fastdiffuse_cuda

torch.set_num_threads(1)

DT = 1.0 / 60.0
ALPHA = 0.8 * 0.8 / DT  # the reference's coefficients: rank 2, radii (5, 4)
TH, TW = fastdiffuse_cuda.TILES["unrolled"]
WARPS, LANES = 8, 32
Q = TH // WARPS


def _design(alpha, iters=20, channels=5):
    return fastdiffuse._taps_array([alpha] * channels, iters, 2e-4)


# -- which kernel -------------------------------------------------------------------


@pytest.mark.parametrize("radii,variant", [
    ((5, 4), "unrolled"), ((4, 5), "generic"), ((5,), "generic"), ((5, 4, 3), "generic"),
    ((6, 6, 6), "generic"), ((1,), "generic"), ((20, 20), "generic")])
def test_variant_by_radii(radii, variant):
    plan = fastdiffuse_cuda.plan(5, 2048, 2048, radii)
    assert plan.variant == variant
    assert plan.tile == fastdiffuse_cuda.TILES[variant]
    assert plan.rmax == max(radii)
    assert plan.smem <= 227 * 1024


@pytest.mark.parametrize("alpha,iters,variant", [
    (ALPHA, 20, "unrolled"),  # the shipped design, velocity and dye taps
    (3.0, 6, "generic"), (1.0, 20, "generic")])
def test_designed_taps_pick_the_kernel(alpha, iters, variant):
    taps, radii = _design(alpha, iters)
    assert taps.shape[1] == sum(2 * (2 * r + 1) for r in radii)
    assert fastdiffuse_cuda.plan(5, 540, 960, radii).variant == variant


def test_unrolled_launch_geometry():
    plan = fastdiffuse_cuda.plan(5, 2048, 2048, (5, 4))
    assert plan.grid == (2048 // TW, 2048 // TH, 5)
    # tile + ring, rows padded so lane 31's four 16-byte loads end inside
    # (74 x 140 floats), and one rank's x sums (74 x 128): 2 blocks an SM
    assert plan.smem == 4 * (74 * 140 + 74 * 128) == 79328
    assert 2 * (plan.smem + 1024) <= 228 * 1024 < 3 * (plan.smem + 1024)
    assert fastdiffuse_cuda.plan(2, 540, 960, (5, 4)).grid == (8, 9, 2)


# -- tile planning where radius 5 reflects more than once ----------------------------


def tile_source(n, start, length, rmax):
    """Indices into an axis of ``n`` cells that a block whose tile starts at
    ``start`` loads for its positions -rmax .. length + rmax - 1: the
    kernel's ``hs_reflect`` (half-sample symmetric, periodic in 2n)."""
    m = torch.remainder(torch.arange(start - rmax, start + length + rmax), 2 * n)
    return torch.where(m >= n, 2 * n - 1 - m, m)


def _reflect_numpy(i, n):
    """Half-sample symmetric index by repeated folding (f[-1-k] = f[k],
    f[n+k] = f[n-1-k]), one fold at a time."""
    while not 0 <= i < n:
        i = -1 - i if i < 0 else 2 * n - 1 - i
    return i


@pytest.mark.parametrize("shape", [(4, 8), (16, 16), (70, 140)], ids=lambda s: f"{s[0]}x{s[1]}")
def test_tile_source_indices(shape):
    h, w = shape
    plan = fastdiffuse_cuda.plan(5, h, w, (5, 4))
    rmax = plan.rmax
    for n, length, tiles in ((h, TH, plan.grid[1]), (w, TW, plan.grid[0])):
        for t in range(tiles):
            got = tile_source(n, t * length, length, rmax)
            exp = [_reflect_numpy(i, n) for i in range(t * length - rmax, (t + 1) * length + rmax)]
            assert got.tolist() == exp
            assert 0 <= int(got.min()) and int(got.max()) < n
    if shape == (4, 8):
        # radius 5 on 4 rows folds at both edges more than once
        rows = tile_source(4, 0, 4, rmax).tolist()
        assert rows == [3, 3, 2, 1, 0, 0, 1, 2, 3, 3, 2, 1, 0, 0]
        assert rows == [_reflect_numpy(i, 4) for i in range(-5, 9)]
        # the plain version's index vector over the whole axis agrees
        assert rows == fastdiffuse.hs_index(4, 5).tolist()


# -- the order of sums, emulated -----------------------------------------------------


def emulate(fields, taps, radii):
    """``sep_kernel_unrolled``'s schedule in plain torch, channel by channel
    and tile by tile."""
    c, h, w = fields.shape
    plan = fastdiffuse_cuda.plan(c, h, w, radii)
    assert plan.variant == "unrolled"
    rm = plan.rmax
    stride = plan.smem // 4 // (TH + 2 * rm) - TW  # the tile's shared row
    out = torch.empty_like(fields)
    tap = torch.from_numpy(taps)
    for ch in range(c):
        for by in range(plan.grid[1]):
            for bx in range(plan.grid[0]):
                y0, x0 = by * TH, bx * TW
                rows = tile_source(h, y0, TH, rm)
                cols = tile_source(w, x0 - rm, stride, 0)
                tile = fields[ch][rows][:, cols]
                acc = torch.empty((TH, TW))
                off = 0
                for k, r in enumerate(radii):
                    n, sh = 2 * r + 1, rm - r
                    # lane l's 16-float window starts at tile column 4 l: it
                    # holds every column its 4 outputs read
                    assert 4 * (LANES - 1) + 4 * ((4 + sh + 2 * r + 3) // 4) <= stride
                    tx, ty = tap[ch, off:off + n], tap[ch, off + n:off + 2 * n]
                    xrows = tile[sh:sh + TH + 2 * r]
                    xs = tx[0] * xrows[:, sh:sh + TW]
                    for j in range(1, n):
                        xs = xs + tx[j] * xrows[:, sh + j:sh + j + TW]
                    # warp wp walks output rows wp*Q .. wp*Q + Q - 1
                    for yy in range(Q + 2 * r):
                        xrow = xs[torch.arange(WARPS) * Q + yy]
                        for q in range(Q):
                            j = yy - q
                            if not 0 <= j < n:
                                continue
                            sel = torch.arange(WARPS) * Q + q
                            term = ty[j] * xrow
                            acc[sel] = term if (k == 0 and j == 0) else acc[sel] + term
                    off += 2 * n
                hh, ww = min(TH, h - y0), min(TW, w - x0)
                out[ch, y0:y0 + hh, x0:x0 + ww] = acc[:hh, :ww]
    return out


@pytest.mark.parametrize("channels", [5, 2])
@pytest.mark.parametrize("shape", [(4, 8), (16, 16), (70, 140), (65, 129)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_unrolled_order_of_sums_is_bit_equal(rng, shape, channels):
    taps, radii = _design(ALPHA, channels=channels)
    f = torch.from_numpy(rng.standard_normal((channels,) + shape).astype(np.float32))
    assert torch.equal(emulate(f, taps, radii), fastdiffuse.sep_apply(f, taps, radii))


def test_wrapper_on_cpu_tensors_is_the_plain_version(rng):
    taps, radii = _design(ALPHA)
    f = torch.from_numpy(rng.standard_normal((5, 16, 24)).astype(np.float32))
    before = fastdiffuse_cuda.SEP.launches
    splat = ([-3.5, 2.25, 1.0, 0.5, 0.3], (9.6, 9.0), 400.0)
    assert torch.equal(fastdiffuse_cuda.sep_apply(f, taps, radii, splat),
                       fastdiffuse.sep_apply(f, taps, radii, splat))
    assert fastdiffuse_cuda.SEP.launches == before
