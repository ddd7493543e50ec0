"""Plain PyTorch reference ops — the port's numerics oracle.

One function for each op of the JAX package's ``ops/ref.py``, with the
same formulas in the same float32 association order, so the two agree to
float32 rounding (tests/test_torch_ops_ref.py; ``pressure_solve_mg`` lives
in ``ops/multigrid.py``).  They run on any device.  The CUDA kernels
(``ops/advect_cuda.py``, ``ops/jacobi_cuda.py``) are held against them:
these are the kernels' plain versions.

Conventions: fields are float32 (H, W) planes (dye is (3, H, W)); index
order is [y, x]; y increases upward; every out-of-domain neighbour access
clamps.  Scalar arguments (dt, coefficients, positions, amplitudes) are
host numbers — Python or NumPy scalars, or CPU tensors — and scalar
arithmetic is done in float32 on the host, as the JAX ops do it in float32
on the device.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from cudafluidsimulation_tpu_torch.ops.stencil import neighbors

Tensor = torch.Tensor
F = np.float32


def f32(x) -> np.float32:
    """A host scalar (Python, NumPy or a one-element CPU tensor) as float32."""
    return F(float(x))


def f32_vec(x) -> np.ndarray:
    """A host vector (sequence, array or CPU tensor) as a float32 array."""
    return np.asarray(x, dtype=np.float32).reshape(-1)


def _extent(t: Tensor) -> Tuple[int, int]:
    """[first, last + 1) byte addresses that ``t`` spans."""
    lo = t.data_ptr()
    if t.is_contiguous():
        return lo, lo + t.nbytes
    span = sum((n - 1) * s for n, s in zip(t.shape, t.stride())) + 1
    return lo, lo + span * t.element_size()


def check_out(out: Tensor, shape, *inputs) -> None:
    """The contract of an op's ``out=``: a contiguous float32 tensor of
    ``shape`` that shares no memory with any of ``inputs`` (None entries
    skipped), since a kernel writes it while it reads them.  Addresses of
    different devices do not collide (CUDA's unified virtual addressing),
    so the overlap test compares addresses alone."""
    if out.dtype != torch.float32:
        raise TypeError(f"out: expected float32, got {out.dtype}")
    if out.shape != tuple(shape):
        raise ValueError(f"out: expected shape {tuple(shape)}, got {tuple(out.shape)}")
    if not out.is_contiguous():
        raise ValueError("out: expected a contiguous tensor")
    lo, hi = _extent(out)
    for t in inputs:
        if t is not None and t.numel():
            a, b = _extent(t)
            if a < hi and lo < b:
                raise ValueError("out: shares memory with an input")


def check_out_planes(out: Tensor, shape, *inputs) -> None:
    """The contract of a batched op's ``out=``: a float32 tensor of
    ``shape`` (B, C, H, W) whose (H, W) planes are each contiguous — a
    channel slice of a larger pack, such as ``pack[:, 2:5]`` — sharing no
    memory with ``inputs`` (:func:`check_out`'s address test)."""
    if out.dtype != torch.float32:
        raise TypeError(f"out: expected float32, got {out.dtype}")
    if out.shape != tuple(shape):
        raise ValueError(f"out: expected shape {tuple(shape)}, got {tuple(out.shape)}")
    if out.stride(-1) != 1 or out.stride(-2) != out.shape[-1]:
        raise ValueError("out: expected contiguous (H, W) planes")
    lo, hi = _extent(out)
    for t in inputs:
        if t is not None and t.numel():
            a, b = _extent(t)
            if a < hi and lo < b:
                raise ValueError("out: shares memory with an input")


def _into(out, *results):
    """``results`` (one tensor or a tuple), or with ``out`` the same values
    copied into ``out`` (one result) or its leading slices (several)."""
    if out is None:
        return results[0] if len(results) == 1 else results
    if len(results) == 1:
        return out.copy_(results[0])
    for dst, src in zip(out, results):
        dst.copy_(src)
    return tuple(out[:len(results)])


# ---------------------------------------------------------------------------
# Bilinear sampling + semi-Lagrangian advection
# ---------------------------------------------------------------------------


def coord_grids(h: int, w: int, device="cpu"):
    """(xs, ys) float32 (H, W) cell-coordinate grids."""
    xs = torch.arange(w, dtype=torch.float32, device=device).expand(h, w)
    ys = torch.arange(h, dtype=torch.float32, device=device)[:, None].expand(h, w)
    return xs, ys


def bilerp(field: Tensor, px: Tensor, py: Tensor) -> Tensor:
    """Clamped 4-tap bilinear sample of ``field`` at (px, py).  The corner is
    C truncation toward zero, not floor (cpuFluidSim.cpp:110-155), so for
    negative coordinates the weights extrapolate while the taps clamp."""
    h, w = field.shape[-2], field.shape[-1]
    x1 = torch.trunc(px)
    y1 = torch.trunc(py)
    tx = px - x1
    ty = py - y1
    xi1 = x1.clamp(0, w - 1).long()
    xi2 = (x1 + 1).clamp(0, w - 1).long()
    yi1 = y1.clamp(0, h - 1).long()
    yi2 = (y1 + 1).clamp(0, h - 1).long()
    flat = field.reshape(field.shape[:-2] + (h * w,))

    def tap(yi, xi):
        idx = (yi * w + xi).reshape(-1)
        return flat.index_select(-1, idx).reshape(field.shape[:-2] + (h, w))

    top = tap(yi1, xi1) * (1.0 - tx) + tap(yi1, xi2) * tx
    bot = tap(yi2, xi1) * (1.0 - tx) + tap(yi2, xi2) * tx
    return top * (1.0 - ty) + bot * ty


def _backtrace(u: Tensor, v: Tensor, dt) -> Tuple[Tensor, Tensor]:
    """Departure points pos = (x, y) - dt * vel (GPUFluidSim.cu:267)."""
    xs, ys = coord_grids(*u.shape, device=u.device)
    dt = float(f32(dt))
    return xs - dt * u, ys - dt * v


def decay_factor(dt, decay_rate) -> float:
    """1 / (1 + rate*dt) in float32 (cpuFluidSim.cpp:159)."""
    return float(F(1) / (F(1) + f32(decay_rate) * f32(dt)))


def vel_max(u: Tensor, v: Tensor) -> Tensor:
    """(2,) [max|u|, max|v|] of a velocity."""
    return torch.stack([u.abs().max(), v.abs().max()])


def advect_velocity(u: Tensor, v: Tensor, dt, decay_rate, *, vel_stats=None,
                    return_stats: bool = False):
    """Semi-Lagrangian self-advection with decay 1/(1 + rate*dt)
    (GPUFluidSim.cu:258-272).  ``vel_stats`` is accepted for signature
    parity and unused; ``return_stats`` also returns :func:`vel_max` of the
    output."""
    del vel_stats
    decay = decay_factor(dt, decay_rate)
    px, py = _backtrace(u, v, dt)
    u2 = bilerp(u, px, py) * decay
    v2 = bilerp(v, px, py) * decay
    if return_stats:
        return u2, v2, vel_max(u2, v2)
    return u2, v2


def advect_dye(dye: Tensor, u: Tensor, v: Tensor, dt, decay_rate, *,
               vel_stats=None, out=None) -> Tensor:
    """Dye advection with the fade c = fmin(1, c^1.005 * decay)
    (GPUFluidSim.cu:275-294), through the already advected velocity.  fmin,
    not min: C fminf(1, NaN) is 1, so a negative extrapolated sample (pow
    NaN) saturates to 1.  ``out``, a (C, H, W) tensor (:func:`check_out`),
    receives the result."""
    del vel_stats
    if out is not None:
        check_out(out, dye.shape, dye, u, v)
    decay = decay_factor(dt, decay_rate)
    px, py = _backtrace(u, v, dt)
    c = bilerp(dye, px, py)
    return _into(out, torch.fmin(torch.pow(c, 1.005) * decay, c.new_ones(())))


class Window(NamedTuple):
    """Where a shard's padded view lies in the global grid, for the window
    advection of the sharded rollout (``parallel/``): ``y0``, ``x0`` are the
    global row and column of the padded array's (0, 0), ``h_phys`` and
    ``w_phys`` the global extents the taps clamp to (``w_phys`` 0: the
    padded width), ``d`` and ``d_x`` the halo depths in rows and columns,
    which bound a tap's offset from its cell (``d_x`` 0: columns
    unbounded).  The cells advected are the padded array's interior, rows
    [d, d + h) and columns [d_x, d_x + w) of an (h + 2d, w + 2d_x) view.

    ``y_in`` >= 0 leaves rows unbounded, as ``d_x`` 0 does columns: the
    view then holds every row of the grid (``y0`` 0, ``h_phys`` rows), the
    interior is its rows [y_in, y_in + h), a tap reads its clamped global
    row, and ``d`` is not used (the global step of ``parallel.sharded``)."""

    y0: int
    h_phys: int
    d: int
    x0: int = 0
    w_phys: int = 0
    d_x: int = 0
    y_in: int = -1


def window_rows(window: Window) -> Tuple[int, int]:
    """(the interior's first row in the view, the bound on a tap's row
    offset from its cell): (d, d) for the padded view, (y_in, h_phys) for
    the rows-unbounded one, where no clamped tap lies h_phys rows away."""
    if window.y_in < 0:
        return window.d, window.d
    if window.y0 != 0:
        raise ValueError(f"window {window}: a rows-unbounded view starts at row 0")
    return window.y_in, window.h_phys


def window_shape(window: Window, h: int, w: int) -> Tuple[int, int]:
    """The padded extents (rows, columns) of an (h, w) interior."""
    rows = h + 2 * window.d if window.y_in < 0 else window.h_phys
    return rows, w + 2 * window.d_x


def window_bilerp(fields: Tensor, u: Tensor, v: Tensor, dt, window: Window) -> Tensor:
    """The window advection's bilinear sample (the sharded JAX step's
    ``_bilerp_padded`` and ``advect_pallas._tap_setup``): each interior cell
    of the padded (C, h + 2d, w + 2d_x) ``fields`` backtraces from its
    global coordinates through (u, v) (h, w), truncates the corner toward
    zero, clamps it to the physical grid, bounds the tap's offset from the
    cell to +-d rows (and +-d_x columns), then reads the padded array.
    With ``y_in`` the view is the grid's rows and the row offset is not
    bounded (:func:`window_rows`).  Returns (C, h, w)."""
    h, w = u.shape
    d_x = window.d_x
    y_in, d = window_rows(window)
    fh, fw = window_shape(window, h, w)
    if tuple(fields.shape[-2:]) != (fh, fw):
        raise ValueError(f"fields: expected padded (C, {fh}, {fw}), got {tuple(fields.shape)}")
    if y_in + h > fh:
        raise ValueError(f"window {window}: rows [{y_in}, {y_in + h}) lie outside the view")
    dev = u.device
    ly = torch.arange(h, device=dev)[:, None] + y_in
    lx = torch.arange(w, device=dev)[None, :] + d_x
    gy, gx = ly + window.y0, lx + window.x0
    dt = float(f32(dt))
    px = gx.to(torch.float32) - dt * u
    py = gy.to(torch.float32) - dt * v
    x1 = torch.trunc(px)
    y1 = torch.trunc(py)
    tx = px - x1
    ty = py - y1
    w_phys = window.w_phys or fw
    cx1 = x1.clamp(0, w_phys - 1).long()
    cx2 = (x1 + 1).clamp(0, w_phys - 1).long()
    cy1 = y1.clamp(0, window.h_phys - 1).long()
    cy2 = (y1 + 1).clamp(0, window.h_phys - 1).long()
    ry1 = (cy1 - gy).clamp(-d, d) + ly
    ry2 = (cy2 - gy).clamp(-d, d) + ly
    if d_x:
        rx1 = (cx1 - gx).clamp(-d_x, d_x) + lx
        rx2 = (cx2 - gx).clamp(-d_x, d_x) + lx
    else:
        rx1, rx2 = cx1 - window.x0, cx2 - window.x0
    flat = fields.reshape(fields.shape[:-2] + (fh * fw,))

    def tap(ry, rx):
        return flat.index_select(-1, (ry * fw + rx).reshape(-1)).reshape(
            fields.shape[:-2] + (h, w))

    top = tap(ry1, rx1) * (1.0 - tx) + tap(ry1, rx2) * tx
    bot = tap(ry2, rx1) * (1.0 - tx) + tap(ry2, rx2) * tx
    return top * (1.0 - ty) + bot * ty


def finish_advect(s: Tensor, dt, decay_rate, mode: str) -> Tensor:
    """The sample's decay ("field") or dye fade fmin(1, s^1.005 * decay)
    ("dye"), as :func:`advect_velocity` and :func:`advect_dye` apply them."""
    decay = decay_factor(dt, decay_rate)
    if mode == "dye":
        return torch.fmin(torch.pow(s, 1.005) * decay, s.new_ones(()))
    if mode != "field":
        raise ValueError(f"mode must be 'field' or 'dye', got {mode!r}")
    return s * decay


def advect_window(fields: Tensor, u: Tensor, v: Tensor, dt, decay_rate, mode: str,
                  window: Window, *, vel_stats=None, return_stats: bool = False,
                  out=None):
    """Kernel H1's window entry, plain: :func:`window_bilerp` then the
    decay or the dye fade.  ``mode`` "field" advects the (2, ...) velocity
    and ``return_stats`` also returns :func:`vel_max` of the interior it
    wrote; ``out`` (C, h, w) receives the result.  ``vel_stats`` is
    accepted for signature parity and unused."""
    del vel_stats
    if return_stats and mode != "field":
        raise ValueError("return_stats: the velocity bound is the 'field' mode's")
    res = _into(out, finish_advect(window_bilerp(fields, u, v, dt, window), dt,
                                   decay_rate, mode))
    if return_stats:
        return res, vel_max(res[0], res[1])
    return res


# ---------------------------------------------------------------------------
# Vorticity confinement
# ---------------------------------------------------------------------------


def curl(u: Tensor, v: Tensor) -> Tensor:
    """0.5 * (vR - vL - uT + uB), clamped edges (GPUFluidSim.cu:544-549)."""
    vl, vr, _, _ = neighbors(v)
    _, _, ub, ut = neighbors(u)
    return 0.5 * (vr - vl - ut + ub)


def vorticity_confinement_cpu(u, v, dt, vorticity, *, out=None):
    """CPU-path confinement (cpuFluidSim.cpp:271-296): gradient of |curl|,
    normalised by (len + 1e-4), scaled by curl * vorticity, negated.
    ``out``, a (2, H, W) tensor (:func:`check_out`), receives u' and v'."""
    if out is not None:
        check_out(out, (2,) + tuple(u.shape), u, v)
    w = curl(u, v)
    ac = w.abs()
    al, ar, ab, at = neighbors(ac)
    fx = 0.5 * (at - ab)
    fy = 0.5 * (ar - al)
    ln = torch.sqrt(fx * fx + fy * fy) + 1e-4
    s = w * float(f32(vorticity)) / ln
    fx = -fx * s
    fy = -fy * s
    dt = float(f32(dt))
    return _into(out, u + fx * dt, v + fy * dt)


def vorticity_confinement_gpu(u, v, dt, vorticity, *, out=None):
    """GPU-path confinement (GPUFluidSim.cu:536-573): force
    ((|wT|-|wB|), (|wL|-|wR|)) * 0.5, normalised by (len + 1e-3), scaled by
    curl * vorticity, not negated; the whole curl field first (the clean
    semantics of the reference's grid-wide race).  ``out`` as in
    :func:`vorticity_confinement_cpu`."""
    if out is not None:
        check_out(out, (2,) + tuple(u.shape), u, v)
    w = curl(u, v)
    wl, wr, wb, wt = neighbors(w)
    fx = 0.5 * (wt.abs() - wb.abs())
    fy = 0.5 * (wl.abs() - wr.abs())
    ln = torch.sqrt(fx * fx + fy * fy) + 1e-3
    s = w * float(f32(vorticity)) / ln
    fx = fx * s
    fy = fy * s
    dt = float(f32(dt))
    return _into(out, u + fx * dt, v + fy * dt)


# ---------------------------------------------------------------------------
# Jacobi diffusion
# ---------------------------------------------------------------------------


def diffusion_alphas(dt, coeffs) -> Tuple[np.ndarray, np.ndarray]:
    """Per-channel (alpha, 1/beta) = (k²/dt, 1/(4 + alpha)) in float32."""
    k = f32_vec(coeffs)
    alpha = k * k / f32(dt)
    return alpha, F(1) / (F(4) + alpha)


def _sweeps(fields: Tensor, alpha, inv_beta, iters: int) -> Tensor:
    x = fields
    for _ in range(iters):
        l, r, b, t = neighbors(x)
        x = (l + r + b + t + x * alpha) * inv_beta
    return x


def diffuse(fields: Tensor, dt, diffusion, iters: int) -> Tensor:
    """``iters`` global Jacobi sweeps of (L + R + B + T + alpha*C) / beta,
    alpha = diffusion²/dt, beta = 4 + alpha (cpuFluidSim.cpp:182-233).  The
    centre term is the current iterate."""
    alpha, inv_beta = diffusion_alphas(dt, [diffusion])
    return _sweeps(fields, float(alpha[0]), float(inv_beta[0]), iters)


def _per_channel(x: np.ndarray, like: Tensor) -> Tensor:
    return torch.as_tensor(x, device=like.device)[:, None, None]


def diffuse_multi(fields: Tensor, dt, coeffs, iters: int) -> Tensor:
    """Jacobi diffusion of (C, H, W) fields with one coefficient for each
    channel (velocity and dye in one pass)."""
    alpha, inv_beta = diffusion_alphas(dt, coeffs)
    return _sweeps(fields, _per_channel(alpha, fields),
                   _per_channel(inv_beta, fields), iters)


def _gaussian_at(xs: Tensor, ys: Tensor, center, radius) -> Tensor:
    """exp(-d2/radius) over the coordinate grids (xs, ys), d2 the squared
    distance to ``center`` (x, y)."""
    center = f32_vec(center)
    d2 = (xs - float(center[0])) ** 2 + (ys - float(center[1])) ** 2
    return torch.exp(-d2 / float(f32(radius)))


def _gaussian(like: Tensor, center, radius) -> Tensor:
    """:func:`_gaussian_at` over ``like``'s own (H, W) grid."""
    return _gaussian_at(*_grids(like), center, radius)


def _grids(like: Tensor, xs=None, ys=None):
    """(xs, ys): the given coordinate grids, or ``like``'s own (H, W) cell
    grids (:func:`coord_grids`) when they are None."""
    if xs is None:
        return coord_grids(like.shape[-2], like.shape[-1], device=like.device)
    return xs, ys


def splat_tail(fields: Tensor, amps, last, radius, xs=None, ys=None) -> Tensor:
    """fields[c] += amps[c] * exp(-d2(last)/radius): the gpu-variant splat
    with the scalar products already folded into ``amps``.  ``xs``, ``ys``:
    the cells' coordinates (a shard's global ones, ``parallel/``), by
    default ``fields``' own grid."""
    e = _gaussian_at(*_grids(fields, xs, ys), last, radius)
    return fields + _per_channel(f32_vec(amps), fields) * e[None]


def diffuse_multi_splat(fields: Tensor, dt, coeffs, iters: int,
                        amps, last, radius) -> Tensor:
    """:func:`diffuse_multi` followed by the gpu-variant splat."""
    return splat_tail(diffuse_multi(fields, dt, coeffs, iters), amps, last, radius)


# ---------------------------------------------------------------------------
# Pressure: divergence -> Jacobi solve -> gradient subtraction
# ---------------------------------------------------------------------------


def divergence(u: Tensor, v: Tensor, half: bool) -> Tensor:
    """Central-difference divergence, clamped edges; the GPU path scales by
    0.5 (GPUFluidSim.cu:297-310), the CPU path does not."""
    ul, ur, _, _ = neighbors(u)
    _, _, vb, vt = neighbors(v)
    d = (ur - ul) + (vt - vb)
    return 0.5 * d if half else d


def pressure_solve(div: Tensor, iters: int, init=None) -> Tensor:
    """``iters`` Jacobi sweeps of p = 0.25*(pL + pR + pB + pT - div) from
    p = 0 (both reference paths zero pressure every frame), or from the
    iterate ``init`` (the sharded rollout chains bursts across halo
    exchanges, ``parallel/shardmap_step.py``)."""
    p = torch.zeros_like(div) if init is None else init
    for _ in range(iters):
        l, r, b, t = neighbors(p)
        p = (l + r + b + t - div) * 0.25
    return p


def pressure_solve_mg(div: Tensor, cycles: int = 2, tol: float = 0.0,
                      max_cycles: int = 8) -> Tensor:
    """Multigrid pressure solve with plain sweeps (``ops/multigrid.py``).
    ``tol > 0`` runs cycles until rms(A p + div) < tol instead of a fixed
    count (at most ``max_cycles``)."""
    from cudafluidsimulation_tpu_torch.ops.multigrid import pressure_solve_mg as mg

    return mg(div, cycles=cycles, tol=tol, max_cycles=max_cycles)


def project(u: Tensor, v: Tensor, p: Tensor, *, return_stats: bool = False):
    """u -= 0.5*(pR - pL), v -= 0.5*(pT - pB), clamped edges
    (GPUFluidSim.cu:498-516)."""
    pl, pr, pb, pt = neighbors(p)
    u2, v2 = u - 0.5 * (pr - pl), v - 0.5 * (pt - pb)
    if return_stats:
        return u2, v2, vel_max(u2, v2)
    return u2, v2


def pressure_project(u: Tensor, v: Tensor, iters: int, half: bool, *,
                     return_stats: bool = False):
    """Divergence, ``iters``-sweep Jacobi from p = 0 and gradient
    subtraction as one op returning (u', v', p[, vel_stats])."""
    d = divergence(u, v, half)
    p = pressure_solve(d, iters)
    if return_stats:
        u2, v2, st = project(u, v, p, return_stats=True)
        return u2, v2, p, st
    u2, v2 = project(u, v, p)
    return u2, v2, p


# ---------------------------------------------------------------------------
# Impulse splat (force + dye)
# ---------------------------------------------------------------------------


def splat_core(u, v, dye, cur, last, dt, force_scale, radius, color, xs, ys,
               kind: str):
    """Splat numerics over explicit coordinate grids ``xs``, ``ys`` (the
    cells' own, or a shard's global ones), for one device and the sharded
    rollout alike.

    cpu kind (cpuFluidSim.cpp:299-324): force Gaussian at the previous
    position, dye Gaussian at the current one, force = (last - cur) * dt *
    scale.  gpu kind (GPUFluidSim.cu:519-532): one Gaussian at the last
    position, F = (last - cur) * force_scale.  Each keeps its reference's
    float32 association order."""
    cur, last, color = f32_vec(cur), f32_vec(last), f32_vec(color)
    dt, fs = f32(dt), f32(force_scale)
    eu = _gaussian_at(xs, ys, last, radius)
    if kind == "cpu":
        u2 = u + float((last[0] - cur[0]) * dt * fs) * eu
        v2 = v + float((last[1] - cur[1]) * dt * fs) * eu
        ec = _gaussian_at(xs, ys, cur, radius)
    else:
        u2 = u + float((last[0] - cur[0]) * fs * dt) * eu
        v2 = v + float((last[1] - cur[1]) * fs * dt) * eu
        ec = eu
    dye2 = dye + _per_channel(color, dye) * ec[None]
    return u2, v2, dye2


def _splat(u, v, dye, cur, last, dt, force_scale, radius, color, kind: str):
    return splat_core(u, v, dye, cur, last, dt, force_scale, radius, color,
                      *_grids(u), kind)


def splat_cpu(u, v, dye, cur, last, dt, force_scale, radius, color):
    return _splat(u, v, dye, cur, last, dt, force_scale, radius, color, "cpu")


def splat_gpu(u, v, dye, cur, last, dt, force_scale, radius, color):
    return _splat(u, v, dye, cur, last, dt, force_scale, radius, color, "gpu")


def cycle_color(palette, press_time) -> Tensor:
    """Dye colour cycling through the palette by accumulated pressed time
    (GPUFluidSim.cu:649-654): lerp between palette[int(t) % n] and
    palette[(int(t)+1) % n] by the fractional part.  Host scalar math; the
    result is a (3,) float32 CPU tensor."""
    pal = np.asarray(palette, np.float32)
    n = pal.shape[0]
    pt = f32(press_time)
    it = np.floor(pt)
    frac = F(pt - it)
    i0 = int(it) % n
    i1 = (int(it) + 1) % n
    return torch.from_numpy(pal[i0] * (F(1) - frac) + pal[i1] * frac)


# ---------------------------------------------------------------------------
# Boundary + rendering
# ---------------------------------------------------------------------------


def boundary_strip_core(u, v, dye, rows: int, ys_i):
    """Zero global rows [0, rows) given integer row coordinates ``ys_i``
    ((H, 1) on one device, a shard's global rows on a mesh)."""
    mask = (ys_i >= rows).to(u.dtype)
    return u * mask, v * mask, dye * mask[None]


def boundary_strip(u, v, dye, rows: int):
    """Zero the bottom ``rows`` rows of velocity and dye — the CPU path's
    y = 0..10 strip (cpuFluidSim.cpp:387-394).  Leading (member) axes
    broadcast."""
    if rows <= 0:
        return u, v, dye
    h = u.shape[-2]
    return boundary_strip_core(u, v, dye, rows, torch.arange(h, device=u.device)[:, None])


def pack_rgba(dye: Tensor) -> Tensor:
    """float RGB dye -> uint8 RGBA, min(255, 255*c), alpha 255
    (GPUFluidSim.cu:432-442); negative dye clamps to 0."""
    c = torch.clamp(255.0 * dye, 0.0, 255.0).to(torch.uint8)
    h, w = dye.shape[-2], dye.shape[-1]
    alpha = torch.full((1, h, w), 255, dtype=torch.uint8, device=dye.device)
    return torch.cat([c, alpha], dim=0)


def _bloom_falloff(xs: Tensor, ys: Tensor, pos, radius) -> Tensor:
    """exp(-(r² + 1)/radius²) around ``pos`` (GPUFluidSim.cu:583)."""
    pos = f32_vec(pos)
    radius = float(f32(radius))
    d2 = (xs - float(pos[0])) ** 2 + (ys - float(pos[1])) ** 2
    return torch.exp(-(d2 + 1.0) / (radius * radius))


def bloom_core(rgba: Tensor, pos, intense, radius, xs, ys) -> Tensor:
    """Bloom numerics over explicit coordinate grids (one device and the
    sharded rollout): adds max(R,G,B) * intense * exp(-(r² + 1)/radius²)
    near ``pos``, clamped to 255 (GPUFluidSim.cu:576-591)."""
    e = float(f32(intense)) * _bloom_falloff(xs, ys, pos, radius)
    rgb = rgba[:3].to(torch.float32)
    mx = rgb.amax(dim=0)
    rgb = torch.clamp(rgb + mx[None] * e[None], max=255.0)
    return torch.cat([rgb.to(torch.uint8), rgba[3:]], dim=0)


def apply_bloom(rgba: Tensor, pos, intense, radius) -> Tensor:
    """:func:`bloom_core` over the frame's own grid."""
    return bloom_core(rgba, pos, intense, radius, *_grids(rgba))


def render_frame_core(dye: Tensor, pos, intense, radius, active, xs, ys) -> Tensor:
    """pack_rgba + gated bloom in one pass over explicit coordinate grids,
    equal to ``apply_bloom(pack_rgba(dye))`` when ``active`` and
    ``pack_rgba(dye)`` otherwise: the uint8 quantisation is emulated in
    float32 (floor of the clipped value), so the bloom reads the quantised
    values."""
    cq = torch.floor(torch.clamp(255.0 * dye, 0.0, 255.0))
    gain = F(float(bool(active))) * f32(intense)
    e = float(gain) * _bloom_falloff(xs, ys, pos, radius)
    mx = cq.amax(dim=0)
    rgb = torch.clamp(cq + mx[None] * e[None], max=255.0).to(torch.uint8)
    h, w = dye.shape[-2], dye.shape[-1]
    alpha = torch.full((1, h, w), 255, dtype=torch.uint8, device=dye.device)
    return torch.cat([rgb, alpha], dim=0)


def render_frame(dye: Tensor, pos, intense, radius, active) -> Tensor:
    """:func:`render_frame_core` over the dye's own grid."""
    return render_frame_core(dye, pos, intense, radius, active, *_grids(dye))


# ---------------------------------------------------------------------------
# Batched ops: B independent members (models/ensemble.py)
# ---------------------------------------------------------------------------
#
# Fields carry a leading member axis: u, v (B, H, W), dye and packs
# (B, C, H, W).  The scalars that differ per member are host arrays with a
# leading B (dt (B,), coefficients (B, C) or (B,), positions (B, 2)).  Each
# op runs the single op above on each member: these are the plain versions
# of the batched kernels, and member i equals the single op on member i
# bit for bit.  ``params`` (the kernels' device copy of the scalars,
# ``ops/member_params.py``) is accepted and unused.


def member_vec(x, n: int) -> np.ndarray:
    """(n,) float32 from a host scalar or a length-n host vector."""
    v = f32_vec(x)
    if v.shape[0] == 1:
        return np.repeat(v, n)
    if v.shape[0] != n:
        raise ValueError(f"expected {n} per-member values, got {v.shape[0]}")
    return v


def member_rows(x, n: int, k: int) -> np.ndarray:
    """(n, k) float32 from a (k,) row shared by every member or (n, k)."""
    a = np.asarray(x, np.float32)
    if a.ndim == 1:
        a = np.broadcast_to(a, (n, a.shape[0]))
    if a.shape != (n, k):
        raise ValueError(f"expected ({n}, {k}) per-member values, got {a.shape}")
    return a


def _stacked(results):
    """[per-member result tuples] -> tuple of stacked tensors."""
    return tuple(torch.stack(list(parts)) for parts in zip(*results))


def advect_velocity_batched(u, v, dt, decay_rate, *, vel_stats=None,
                            return_stats: bool = False, params=None):
    """:func:`advect_velocity` of each member; dt (B,); stats (B, 2).
    ``vel_stats`` is accepted for signature parity and unused."""
    del params, vel_stats
    dt = member_vec(dt, u.shape[0])
    out = _stacked(advect_velocity(u[i], v[i], dt[i], decay_rate, return_stats=True)
                   for i in range(u.shape[0]))
    return out if return_stats else out[:2]


def advect_dye_batched(dye, u, v, dt, decay_rate, *, vel_stats=None, params=None,
                       out=None):
    """:func:`advect_dye` of each member; ``out`` (B, C, H, W)
    (:func:`check_out_planes`), for example ``pack[:, 2:5]``; ``vel_stats``
    is accepted for signature parity and unused."""
    del params, vel_stats
    if out is not None:
        check_out_planes(out, dye.shape, dye, u, v)
    dt = member_vec(dt, u.shape[0])
    res = torch.stack([advect_dye(dye[i], u[i], v[i], dt[i], decay_rate)
                       for i in range(u.shape[0])])
    return res if out is None else out.copy_(res)


def _confinement_batched(fn, u, v, dt, vorticity, out):
    if out is not None:
        check_out_planes(out, (u.shape[0], 2) + tuple(u.shape[1:]), u, v)
    dt = member_vec(dt, u.shape[0])
    res = torch.stack([torch.stack(fn(u[i], v[i], dt[i], vorticity))
                       for i in range(u.shape[0])])
    out = res if out is None else out.copy_(res)
    return out[:, 0], out[:, 1]


def vorticity_confinement_gpu_batched(u, v, dt, vorticity, *, params=None, out=None):
    """:func:`vorticity_confinement_gpu` of each member; ``out``
    (B, 2, H, W) receives u' and v' (the step's ``pack[:, 0:2]``)."""
    del params
    return _confinement_batched(vorticity_confinement_gpu, u, v, dt, vorticity, out)


def vorticity_confinement_cpu_batched(u, v, dt, vorticity, *, params=None, out=None):
    """:func:`vorticity_confinement_cpu` of each member (``out`` as the gpu
    variant's)."""
    del params
    return _confinement_batched(vorticity_confinement_cpu, u, v, dt, vorticity, out)


def diffuse_batched(fields, dt, diffusion, iters: int, *, params=None):
    """:func:`diffuse` of each member's (C, H, W) fields with its own
    coefficient, ``diffusion`` (B,)."""
    del params
    n = fields.shape[0]
    dt, k = member_vec(dt, n), member_vec(diffusion, n)
    return torch.stack([diffuse(fields[i], dt[i], k[i], iters) for i in range(n)])


def diffuse_multi_batched(fields, dt, coeffs, iters: int, *, params=None):
    """:func:`diffuse_multi` of each member; ``coeffs`` (B, C)."""
    del params
    n, c = fields.shape[:2]
    dt, coeffs = member_vec(dt, n), member_rows(coeffs, n, c)
    return torch.stack([diffuse_multi(fields[i], dt[i], coeffs[i], iters)
                        for i in range(n)])


def diffuse_multi_splat_batched(fields, dt, coeffs, iters: int, amps, last, radius,
                                *, params=None):
    """:func:`diffuse_multi_splat` of each member; ``coeffs`` and ``amps``
    (B, C), ``last`` (B, 2)."""
    del params
    n, c = fields.shape[:2]
    dt, coeffs = member_vec(dt, n), member_rows(coeffs, n, c)
    amps, last = member_rows(amps, n, c), member_rows(last, n, 2)
    return torch.stack([diffuse_multi_splat(fields[i], dt[i], coeffs[i], iters, amps[i],
                                            last[i], radius) for i in range(n)])


def _splat_batched(fn, u, v, dye, cur, last, dt, force_scale, radius, color):
    n = u.shape[0]
    cur, last, color = member_rows(cur, n, 2), member_rows(last, n, 2), member_rows(color, n, 3)
    dt, fs = member_vec(dt, n), member_vec(force_scale, n)
    return _stacked(fn(u[i], v[i], dye[i], cur[i], last[i], dt[i], fs[i], radius, color[i])
                    for i in range(n))


def splat_cpu_batched(u, v, dye, cur, last, dt, force_scale, radius, color):
    """:func:`splat_cpu` of each member; cur, last (B, 2), dt and
    force_scale (B,), color (B, 3)."""
    return _splat_batched(splat_cpu, u, v, dye, cur, last, dt, force_scale, radius, color)


def splat_gpu_batched(u, v, dye, cur, last, dt, force_scale, radius, color):
    """:func:`splat_gpu` of each member (arguments as :func:`splat_cpu_batched`)."""
    return _splat_batched(splat_gpu, u, v, dye, cur, last, dt, force_scale, radius, color)


def pressure_project_batched(u, v, iters: int, half: bool, *, return_stats: bool = False):
    """:func:`pressure_project` of each member; stats (B, 2)."""
    out = _stacked(pressure_project(u[i], v[i], iters, half, return_stats=True)
                   for i in range(u.shape[0]))
    return out if return_stats else out[:3]


def divergence_batched(u, v, half: bool):
    """:func:`divergence` of each member: (B, H, W)."""
    return torch.stack([divergence(u[i], v[i], half) for i in range(u.shape[0])])


def project_batched(u, v, p, *, return_stats: bool = False):
    """:func:`project` of each member; stats (B, 2)."""
    out = _stacked(project(u[i], v[i], p[i], return_stats=True) for i in range(u.shape[0]))
    return out if return_stats else out[:2]


def pressure_project_mg_batched(u, v, cycles: int, *, tol: float = 0.0,
                                max_cycles: int = 8, half: bool = True,
                                return_stats: bool = False):
    """Multigrid projection of each member, as the single step composes it
    on the plain ops: :func:`divergence`, :func:`pressure_solve_mg`,
    :func:`project`.  With ``tol`` each member runs its own V-cycles, as a
    vmapped while-loop leaves a converged member as it is."""
    def one(i):
        p = pressure_solve_mg(divergence(u[i], v[i], half), cycles, tol=tol,
                              max_cycles=max_cycles)
        u2, v2, st = project(u[i], v[i], p, return_stats=True)
        return u2, v2, p, st

    out = _stacked(one(i) for i in range(u.shape[0]))
    return out if return_stats else out[:3]


def cycle_color_batched(palette, press_time) -> np.ndarray:
    """(B, 3) float32 :func:`cycle_color` of each member's press time, with
    its float32 operations on (B,) arrays."""
    pal = np.asarray(palette, np.float32)
    n = pal.shape[0]
    pt = f32_vec(press_time)
    it = np.floor(pt)
    frac = (pt - it).astype(np.float32)
    i0 = it.astype(np.int64) % n
    i1 = (it.astype(np.int64) + 1) % n
    return pal[i0] * (F(1) - frac)[:, None] + pal[i1] * frac[:, None]
