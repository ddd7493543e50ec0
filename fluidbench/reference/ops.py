"""Plain PyTorch ops of the gpu-parity step, frozen for the benchmark.

A copy of the plain arithmetic that the simulated app computes (the
clamped neighbour rule, semi-Lagrangian advection with truncating taps,
the gpu-variant vorticity confinement, Jacobi diffusion with the splat
folded in after the last sweep, the divergence -> Jacobi -> projection
solve, the palette cycle, and the render with its bloom), in the same
float32 association order as the upstream CUDA source (GPUFluidSim.cu,
cited at each op).  It imports nothing of the program under test, so a
change to the program cannot change what it is judged against.

Fields are (H, W) planes (dye (3, H, W)), index order [y, x], y upward,
every out-of-domain neighbour clamped.  Scalars are host numbers and their
arithmetic is float32 on the host.  Each op takes its fields in whatever
floating type they come in; the step (``reference/step.py``) decides the
precision, so the same ops serve the float32 reference and its
lower-precision control.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

Tensor = torch.Tensor
F = np.float32


def f32(x) -> np.float32:
    """A host scalar (Python, NumPy or a one-element CPU tensor) as float32."""
    return F(float(x))


def f32_vec(x) -> np.ndarray:
    """A host vector as a float32 array."""
    return np.asarray(x, dtype=np.float32).reshape(-1)


# -- the clamped neighbour rule (the CLAMP macro, GPUFluidSim.cu:13) ----------


def shift_x(a: Tensor, d: int) -> Tensor:
    """Element (..., y, x) is a[..., y, clamp(x + d)], |d| = 1."""
    if d > 0:
        return torch.cat([a[..., 1:], a[..., -1:]], dim=-1)
    return torch.cat([a[..., :1], a[..., :-1]], dim=-1)


def shift_y(a: Tensor, d: int) -> Tensor:
    """Element (..., y, x) is a[..., clamp(y + d), x], |d| = 1."""
    if d > 0:
        return torch.cat([a[..., 1:, :], a[..., -1:, :]], dim=-2)
    return torch.cat([a[..., :1, :], a[..., :-1, :]], dim=-2)


def neighbors(a: Tensor):
    """(left, right, bottom, top); bottom is y - 1, top y + 1."""
    return shift_x(a, -1), shift_x(a, 1), shift_y(a, -1), shift_y(a, 1)


# -- advection (GPUFluidSim.cu:258-294) ----------------------------------------


def coord_grids(h: int, w: int, device) -> Tuple[Tensor, Tensor]:
    """(xs, ys) float32 (H, W) cell coordinates."""
    xs = torch.arange(w, dtype=torch.float32, device=device).expand(h, w)
    ys = torch.arange(h, dtype=torch.float32, device=device)[:, None].expand(h, w)
    return xs, ys


def bilerp(field: Tensor, px: Tensor, py: Tensor) -> Tensor:
    """Clamped 4-tap bilinear sample at (px, py); the corner truncates
    toward zero (C's int cast), so for negative coordinates the weights
    extrapolate while the taps clamp."""
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
        return flat.index_select(-1, (yi * w + xi).reshape(-1)).reshape(
            field.shape[:-2] + (h, w))

    top = tap(yi1, xi1) * (1.0 - tx) + tap(yi1, xi2) * tx
    bot = tap(yi2, xi1) * (1.0 - tx) + tap(yi2, xi2) * tx
    return top * (1.0 - ty) + bot * ty


def backtrace(u: Tensor, v: Tensor, dt) -> Tuple[Tensor, Tensor]:
    """Departure points (x, y) - dt * (u, v)."""
    xs, ys = coord_grids(u.shape[-2], u.shape[-1], u.device)
    dt = float(f32(dt))
    return xs - dt * u, ys - dt * v


def decay_factor(dt, decay_rate) -> float:
    """1 / (1 + rate * dt) in float32."""
    return float(F(1) / (F(1) + f32(decay_rate) * f32(dt)))


def vel_max(u: Tensor, v: Tensor) -> Tensor:
    """(2,) [max|u|, max|v|]."""
    return torch.stack([u.abs().max(), v.abs().max()])


def advect_velocity(u: Tensor, v: Tensor, dt, decay_rate):
    """Self-advection with decay; returns (u', v')."""
    decay = decay_factor(dt, decay_rate)
    px, py = backtrace(u, v, dt)
    return bilerp(u, px, py) * decay, bilerp(v, px, py) * decay


def advect_dye(dye: Tensor, u: Tensor, v: Tensor, dt, decay_rate) -> Tensor:
    """Dye advection through the advected velocity with the fade
    fmin(1, c^1.005 * decay); fmin saturates a NaN power to 1."""
    decay = decay_factor(dt, decay_rate)
    px, py = backtrace(u, v, dt)
    c = bilerp(dye, px, py)
    return torch.fmin(torch.pow(c, 1.005) * decay, c.new_ones(()))


# -- vorticity confinement, gpu variant (GPUFluidSim.cu:536-573) ---------------


def curl(u: Tensor, v: Tensor) -> Tensor:
    vl, vr, _, _ = neighbors(v)
    _, _, ub, ut = neighbors(u)
    return 0.5 * (vr - vl - ut + ub)


def vorticity_confinement(u: Tensor, v: Tensor, dt, vorticity):
    """Force ((|wT| - |wB|), (|wL| - |wR|)) * 0.5 over (len + 1e-3), times
    curl * vorticity, from the whole curl field."""
    w = curl(u, v)
    wl, wr, wb, wt = neighbors(w)
    fx = 0.5 * (wt.abs() - wb.abs())
    fy = 0.5 * (wl.abs() - wr.abs())
    ln = torch.sqrt(fx * fx + fy * fy) + 1e-3
    s = w * float(f32(vorticity)) / ln
    fx = fx * s
    fy = fy * s
    dt = float(f32(dt))
    return u + fx * dt, v + fy * dt


# -- Jacobi diffusion and the splat (GPUFluidSim.cu:519-532) -------------------


def diffusion_alphas(dt, coeffs):
    """Per channel (alpha, 1/beta) = (k^2/dt, 1/(4 + alpha)) in float32."""
    k = f32_vec(coeffs)
    alpha = k * k / f32(dt)
    return alpha, F(1) / (F(4) + alpha)


def _per_channel(x: np.ndarray, like: Tensor) -> Tensor:
    return torch.as_tensor(x, device=like.device)[:, None, None]


def diffuse_multi(fields: Tensor, dt, coeffs, iters: int) -> Tensor:
    """``iters`` Jacobi sweeps (L + R + B + T + alpha * C) / beta of
    (C, H, W) fields, one coefficient a channel."""
    alpha, inv_beta = diffusion_alphas(dt, coeffs)
    a = _per_channel(alpha, fields).to(fields.dtype)
    ib = _per_channel(inv_beta, fields).to(fields.dtype)
    x = fields
    for _ in range(iters):
        l, r, b, t = neighbors(x)
        x = (l + r + b + t + x * a) * ib
    return x


def gaussian(like: Tensor, center, radius) -> Tensor:
    """exp(-d2 / radius) over ``like``'s grid, d2 the squared distance."""
    xs, ys = coord_grids(like.shape[-2], like.shape[-1], like.device)
    center = f32_vec(center)
    d2 = (xs - float(center[0])) ** 2 + (ys - float(center[1])) ** 2
    return torch.exp(-d2 / float(f32(radius)))


def splat_tail(fields: Tensor, amps, last, radius) -> Tensor:
    """fields[c] += amps[c] * exp(-d2(last) / radius)."""
    e = gaussian(fields, last, radius)
    return fields + _per_channel(f32_vec(amps), fields) * e[None]


# -- pressure: divergence -> Jacobi from zero -> projection --------------------


def divergence(u: Tensor, v: Tensor, half: bool) -> Tensor:
    """Central differences, scaled by 0.5 on the gpu path
    (GPUFluidSim.cu:297-310)."""
    ul, ur, _, _ = neighbors(u)
    _, _, vb, vt = neighbors(v)
    d = (ur - ul) + (vt - vb)
    return 0.5 * d if half else d


def pressure_solve(div: Tensor, iters: int) -> Tensor:
    """``iters`` sweeps of p = 0.25 (pL + pR + pB + pT - div) from p = 0."""
    p = torch.zeros_like(div)
    for _ in range(iters):
        l, r, b, t = neighbors(p)
        p = (l + r + b + t - div) * 0.25
    return p


def project(u: Tensor, v: Tensor, p: Tensor):
    """u -= 0.5 (pR - pL), v -= 0.5 (pT - pB) (GPUFluidSim.cu:498-516)."""
    pl, pr, pb, pt = neighbors(p)
    return u - 0.5 * (pr - pl), v - 0.5 * (pt - pb)


# -- dye colour and render (GPUFluidSim.cu:432-442, 576-591, 649-654) ----------


def cycle_color(palette: np.ndarray, press_time) -> np.ndarray:
    """(3,) float32 lerp between palette[int(t) % n] and the next entry."""
    n = palette.shape[0]
    pt = f32(press_time)
    it = np.floor(pt)
    frac = F(pt - it)
    return palette[int(it) % n] * (F(1) - frac) + palette[(int(it) + 1) % n] * frac


def render_frame(dye: Tensor, pos, intense, radius, active) -> Tensor:
    """(4, H, W) uint8 RGBA: min(255, 255 c) quantised (the floor, as a
    uint8 cast truncates), plus, while ``active``, the bloom max(R, G, B) *
    intense * exp(-(r^2 + 1) / radius^2) around ``pos``, clamped to 255."""
    cq = torch.floor(torch.clamp(255.0 * dye, 0.0, 255.0))
    gain = F(float(bool(active))) * f32(intense)
    xs, ys = coord_grids(dye.shape[-2], dye.shape[-1], dye.device)
    pos = f32_vec(pos)
    rad = float(f32(radius))
    d2 = (xs - float(pos[0])) ** 2 + (ys - float(pos[1])) ** 2
    e = float(gain) * torch.exp(-(d2 + 1.0) / (rad * rad))
    mx = cq.amax(dim=0)
    rgb = torch.clamp(cq + mx[None] * e[None], max=255.0).to(torch.uint8)
    alpha = torch.full((1,) + tuple(dye.shape[-2:]), 255, dtype=torch.uint8,
                       device=dye.device)
    return torch.cat([rgb, alpha], dim=0)


def frame_image(frame: Tensor) -> Tensor:
    """(4, H, W) frame -> (H, W, 4) image with y up at the top (row 0 is
    the grid's top row)."""
    return frame.flip(1).permute(1, 2, 0).contiguous()
