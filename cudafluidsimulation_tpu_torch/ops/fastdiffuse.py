"""Separable fast diffusion — the opt-in ``fast_diffuse`` mode.

The port of ``cudafluidsimulation_tpu/ops/fastdiffuse.py``.  The parity
diffusion is a fixed linear blur M^k (each sweep's centre term is the
current iterate), with M = (S + alpha I) / (4 + alpha), alpha =
diffusion²/dt and S the clamped 4-neighbour sum.  M^k's interior kernel is
numerically low-rank separable: at the reference's alpha = 38.4, k = 20 it
is rank 2, radii (5, 4), 40 taps a cell, to 2e-4 relative Frobenius.

Edges: the clamped-neighbour sweep on a finite grid equals the infinite
convolution of the field's HALF-SAMPLE SYMMETRIC extension
(f[-1-k] = f[k], f[w+k] = f[w-1-k]), so evaluating the truncated kernel over
that extension reproduces the reference's clamped edges up to the same
truncation error as the interior.

- Tap design (:func:`design_taps`, :func:`tap_cost`, :func:`worthwhile`,
  :func:`_taps_array`) is numpy only, line for line the JAX package's, so
  the taps are bit-equal (tests/test_torch_fast.py).  The taps are this
  system's "weights".
- :func:`sep_apply` is the plain PyTorch version of kernel H7
  (``csrc/sepdiffuse.cu``, wrapper ``ops/fastdiffuse_cuda.py``), with JAX's
  order of sums.
- :func:`make_ops` returns the ``diffuse``/``diffuse_multi``/
  ``diffuse_multi_splat`` overrides over the H7 wrapper.  The taps are
  designed at the config's nominal dt and coefficients; unlike the JAX
  package, which ignores a call's ``dt``, ``coeffs`` and ``iters``, the
  port raises ``ValueError`` when they differ from the nominal ones.
- :func:`sharded_sep` gives the sharded rollout the same ops and the halo
  radius their one mirror exchange needs.
- :func:`sep_apply_batched` and :func:`make_batched_ops` are the same for
  ensembles (B members, the batched H7 wrapper): the same taps for every
  member, each member's dt and coefficients checked against the nominal
  ones.  So a fast-diffusion viscosity sweep raises where the JAX package
  quietly runs every member at the config's viscosity; the port designs no
  taps per member, which would give other results than JAX's.

Reference anchors: cpuFluidSim.cpp:182-233 (operator + swap),
GPUFluidSim.cu:316-429 (k=20), GPUFluidSim.cu:52,55 (coefficients).
"""

from __future__ import annotations

import functools
from typing import Sequence, Tuple

import numpy as np
import torch

from cudafluidsimulation_tpu_torch.ops import ref

# ---------------------------------------------------------------------------
# Tap design (numpy, cached per (alpha, iters))
# ---------------------------------------------------------------------------


def _kernel2d(alpha: float, k: int) -> np.ndarray:
    """Exact interior kernel of M^k as a (2k+1)^2 array (float64)."""
    n = 2 * k + 1
    K = np.zeros((n, n))
    K[k, k] = 1.0
    w_c = alpha / (4.0 + alpha)
    w_n = 1.0 / (4.0 + alpha)
    for _ in range(k):
        Kn = w_c * K
        Kn[1:, :] += w_n * K[:-1, :]
        Kn[:-1, :] += w_n * K[1:, :]
        Kn[:, 1:] += w_n * K[:, :-1]
        Kn[:, :-1] += w_n * K[:, 1:]
        K = Kn
    return K


def _trunc(u: np.ndarray, c: int, r: int) -> np.ndarray:
    ut = np.zeros_like(u)
    ut[c - r : c + r + 1] = u[c - r : c + r + 1]
    return ut


@functools.lru_cache(maxsize=64)
def design_taps(alpha: float, iters: int, rtol: float = 2e-4,
                max_rank: int = 3) -> Tuple[Tuple[np.ndarray, ...], ...]:
    """Rank-R separable approximation of the k-sweep blur M^k.

    Returns ``(x_taps, y_taps)``: per-rank 1-D tap vectors (np.float32,
    lengths 2*r_i+1) such that M^k ~= sum_i conv_y(y_taps[i]) .
    conv_x(x_taps[i]) with relative Frobenius error <= ``rtol`` on the
    interior kernel.  The eigenvalue folds into the y taps; the leading
    term is rescaled so the approximate kernel sums to exactly 1 (M
    preserves constants).
    """
    K = _kernel2d(alpha, iters)
    nrm = np.linalg.norm(K)
    evals, evecs = np.linalg.eigh(K)
    order = np.argsort(-np.abs(evals))
    evals, evecs = evals[order], evecs[:, order]
    c = iters

    def rebuild(radii):
        Kr = np.zeros_like(K)
        for i, r in enumerate(radii):
            ut = _trunc(evecs[:, i], c, r)
            Kr += evals[i] * np.outer(ut, ut)
        return Kr

    # rank: smallest R whose untruncated error clears half the budget
    rank = max_rank
    for R in range(1, max_rank + 1):
        Kr = sum(
            evals[i] * np.outer(evecs[:, i], evecs[:, i]) for i in range(R)
        )
        if np.linalg.norm(K - Kr) / nrm <= 0.5 * rtol:
            rank = R
            break

    # common radius: smallest r meeting the budget, then shrink each rank's
    # radius individually while the budget still holds
    radii = None
    for r in range(1, iters + 1):
        if np.linalg.norm(K - rebuild([r] * rank)) / nrm <= rtol:
            radii = [r] * rank
            break
    if radii is None:
        radii = [iters] * rank
    for i in range(rank - 1, -1, -1):
        while radii[i] > 1:
            trial = list(radii)
            trial[i] -= 1
            if np.linalg.norm(K - rebuild(trial)) / nrm <= rtol:
                radii = trial
            else:
                break

    # fold eigenvalues into y taps; DC-normalize via the leading term
    xs, ys = [], []
    for i, r in enumerate(radii):
        u = evecs[c - r : c + r + 1, i].copy()
        xs.append(u)
        ys.append(evals[i] * u)
    dc_tail = sum(x.sum() * y.sum() for x, y in zip(xs[1:], ys[1:]))
    lead_dc = xs[0].sum() * ys[0].sum()
    scale = (1.0 - dc_tail) / lead_dc
    # split the correction across both passes to keep x/y symmetric
    s = np.sqrt(abs(scale))
    xs[0] = xs[0] * s
    ys[0] = ys[0] * (scale / s)
    return (
        tuple(x.astype(np.float32) for x in xs),
        tuple(y.astype(np.float32) for y in ys),
    )


def tap_cost(alpha: float, iters: int, rtol: float = 2e-4) -> int:
    """Multiply-adds a cell of the separable evaluation (both passes, all
    ranks)."""
    xs, _ = design_taps(alpha, iters, rtol)
    return int(sum(2 * len(x) for x in xs))


def worthwhile(alphas: Sequence[float], iters: int,
               rtol: float = 2e-4) -> bool:
    """The fast mode runs only when the tap volume undercuts ~4 operations
    a cell for each exact sweep."""
    if iters == 0:
        return False
    try:
        cost = max(tap_cost(float(a), iters, rtol) for a in set(alphas))
    except np.linalg.LinAlgError:  # pragma: no cover - eigh failure
        return False
    return cost < 4 * iters


def _taps_array(alphas: Sequence[float], iters: int, rtol: float):
    """Stack per-channel taps into one (C, L) array, each row the ranks'
    x taps then y taps in rank order.

    All channels must share the same per-rank radii (true whenever they
    share coefficients); returns (taps (C, L) np.float32, radii tuple) or
    None when the designed radii differ.
    """
    per_chan = [design_taps(float(a), iters, rtol) for a in alphas]
    radii = tuple((len(x) - 1) // 2 for x in per_chan[0][0])
    for xs, ys in per_chan:
        if tuple((len(x) - 1) // 2 for x in xs) != radii:
            return None
    rows = []
    for xs, ys in per_chan:
        flat = [w for x, y in zip(xs, ys) for w in (*x, *y)]
        rows.append(np.asarray(flat, np.float32))
    return np.stack(rows), radii


# ---------------------------------------------------------------------------
# The plain version of kernel H7
# ---------------------------------------------------------------------------


def hs_index(n: int, r: int, device="cpu") -> torch.Tensor:
    """Indices of positions -r .. n-1+r into an axis of length ``n`` under
    half-sample symmetric extension (f[-1-k] = f[k], f[n+k] = f[n-1-k]),
    which is periodic with period 2n, so any ``r`` reflects correctly, also
    several times when r >= n."""
    m = torch.remainder(torch.arange(-r, n + r, device=device), 2 * n)
    return torch.where(m >= n, 2 * n - 1 - m, m)


def check_taps(fields: torch.Tensor, taps: np.ndarray, radii) -> np.ndarray:
    """Validate (C, H, W) float32 ``fields`` against (C, L) ``taps`` laid
    out for ``radii``; return the taps as a float32 array."""
    if fields.dim() != 3 or fields.dtype != torch.float32:
        raise ValueError(f"fields: expected float32 (C, H, W), got "
                         f"{fields.dtype} {tuple(fields.shape)}")
    taps = np.ascontiguousarray(taps, np.float32)
    length = sum(2 * (2 * r + 1) for r in radii)
    if not radii or min(radii) < 0:
        raise ValueError(f"radii: expected non-negative radii, got {radii}")
    if taps.shape != (fields.shape[0], length):
        raise ValueError(f"taps: expected ({fields.shape[0]}, {length}), "
                         f"got {taps.shape}")
    return taps


def sep_apply(fields: torch.Tensor, taps: np.ndarray, radii,
              splat=None) -> torch.Tensor:
    """Rank-R separable blur of (C, H, W) ``fields`` with half-sample
    symmetric edges, then the optional gpu-variant splat tail.

    ``taps`` (C, L) float32: per channel, for each rank of ``radii``, the
    2r+1 x taps then the 2r+1 y taps.  ``splat`` = (amps, last, radius) or
    None.  Order of sums (fastdiffuse.py:225-243 of the JAX package): for
    each rank the x accumulator starts at tap -r and runs upward; the y
    accumulator runs over the ranks in order, tap -r first.  The tail is
    ``ops.ref.splat_tail``.
    """
    taps = check_taps(fields, taps, radii)
    c, h, w = fields.shape
    tap = torch.tensor(taps, device=fields.device)[:, :, None, None]
    acc = None
    off = 0
    for r in radii:
        n = 2 * r + 1
        fx = fields.index_select(2, hs_index(w, r, fields.device))
        tx = None
        for j in range(n):
            term = tap[:, off + j] * fx[:, :, j:j + w]
            tx = term if tx is None else tx + term
        ty = tx.index_select(1, hs_index(h, r, fields.device))
        for j in range(n):
            term = tap[:, off + n + j] * ty[:, j:j + h, :]
            acc = term if acc is None else acc + term
        off += 2 * n
    if splat is not None:
        amps, last, radius = splat
        acc = ref.splat_tail(acc, amps, last, radius)
    return acc


def sep_apply_batched(fields: torch.Tensor, taps: np.ndarray, radii, splat=None, *,
                      params=None) -> torch.Tensor:
    """:func:`sep_apply` of each member of (B, C, H, W) ``fields``, every
    member with the same ``taps``; ``splat`` = (amps (B, C), last (B, 2),
    radius) or None.  ``params`` (the kernel's device rows) is accepted and
    unused."""
    del params
    n, c = fields.shape[:2]
    if splat is None:
        return torch.stack([sep_apply(fields[i], taps, radii) for i in range(n)])
    amps, last = ref.member_rows(splat[0], n, c), ref.member_rows(splat[1], n, 2)
    return torch.stack([sep_apply(fields[i], taps, radii, (amps[i], last[i], splat[2]))
                        for i in range(n)])


# ---------------------------------------------------------------------------
# Namespace overrides
# ---------------------------------------------------------------------------


def _check_nominal(what, dt, coeffs, iters, nominal_dt, nominal_coeffs,
                   nominal_iters) -> None:
    """Raise unless a call's dt, coefficients and sweep count are the ones
    the taps were designed for, compared as float32 on the host."""
    got = ref.f32_vec(coeffs)
    if (ref.f32(dt) != nominal_dt or int(iters) != nominal_iters
            or got.shape != nominal_coeffs.shape
            or not np.array_equal(got, nominal_coeffs)):
        raise ValueError(
            f"fast_diffuse {what}: taps designed for dt={nominal_dt!r}, "
            f"coeffs={nominal_coeffs.tolist()}, iters={nominal_iters}; called "
            f"with dt={ref.f32(dt)!r}, coeffs={got.tolist()}, iters={iters}")


def _check_members(what, dt, coeffs, iters, nominal_dt, nominal_coeffs,
                   nominal_iters) -> None:
    """:func:`_check_nominal` for B members: ``dt`` (B,) and ``coeffs``
    (B, C) on the host, compared at once; the message names the first
    member that differs."""
    rows = np.asarray(coeffs, np.float32)
    dts = ref.member_vec(dt, rows.shape[0])
    if int(iters) == nominal_iters and (dts == nominal_dt).all() and (rows == nominal_coeffs).all():
        return
    bad = int(np.argmax((dts != nominal_dt) | (rows != nominal_coeffs).any(axis=1)))
    _check_nominal(f"{what} (member {bad})", dts[bad], rows[bad], iters, nominal_dt,
                   nominal_coeffs, nominal_iters)


@functools.lru_cache(maxsize=16)
def _design(config):
    """(taps5, radii5, taps2, radii2) for the config's nominal velocity and
    dye coefficients, or None where the taps would not undercut the exact
    sweeps (:func:`worthwhile`) or the channels' radii differ."""
    iters = config.diffusion_iters
    a_v = config.velocity_diffusion ** 2 / config.dt
    a_c = config.color_diffusion ** 2 / config.dt
    if not worthwhile((a_v, a_c), iters):
        return None
    built = _taps_array([a_v] * 2 + [a_c] * 3, iters, rtol=2e-4)
    built_v = _taps_array([a_v] * 2, iters, rtol=2e-4)
    if built is None or built_v is None:
        return None
    return built + built_v


def _nominal(config):
    """(dt, the five channels' coefficients, the velocity's) in float32."""
    return (ref.f32(config.dt),
            ref.f32_vec([config.velocity_diffusion] * 2 + [config.color_diffusion] * 3),
            ref.f32_vec([config.velocity_diffusion]))


def make_ops(config, apply=None) -> dict:
    """Namespace overrides for ``config.fast_diffuse``: ``diffuse``,
    ``diffuse_multi`` and ``diffuse_multi_splat`` over kernel H7's wrapper
    (its plain version for CPU tensors), or over ``apply`` when given
    (:func:`sep_apply` runs the plain version on any device).  Returns {}
    when the separable taps would not undercut the exact sweeps
    (:func:`worthwhile`) or the channels' radii differ, so the exact H3
    path keeps running.

    The taps are designed at the config's ``dt`` and coefficients; a call
    whose ``dt``, coefficients or ``iters`` differ raises ``ValueError``.
    The splat tail's amplitudes and position come from the call."""
    if apply is None:
        from cudafluidsimulation_tpu_torch.ops import fastdiffuse_cuda

        apply = fastdiffuse_cuda.sep_apply
    design = _design(config)
    if design is None:
        return {}
    taps5, radii5, taps2, radii2 = design
    iters = config.diffusion_iters
    nominal_dt, coeffs5, coeff_v = _nominal(config)

    def diffuse(fields, dt, diffusion, iters_):
        _check_nominal("diffuse", dt, diffusion, iters_, nominal_dt, coeff_v,
                       iters)
        squeeze = fields.dim() == 2
        if squeeze:
            fields = fields[None]
        # the velocity taps for however many channels arrive
        t = np.broadcast_to(taps2[:1], (fields.shape[0], taps2.shape[1]))
        out = apply(fields, t, radii2)
        return out[0] if squeeze else out

    def multi_taps(fields, dt, coeffs, iters_, what):
        c = fields.shape[0]
        _check_nominal(what, dt, coeffs, iters_, nominal_dt, coeffs5[:c], iters)
        return taps5[:c]

    def diffuse_multi(fields, dt, coeffs, iters_):
        t = multi_taps(fields, dt, coeffs, iters_, "diffuse_multi")
        return apply(fields, t, radii5)

    def diffuse_multi_splat(fields, dt, coeffs, iters_, amps, last, radius):
        t = multi_taps(fields, dt, coeffs, iters_, "diffuse_multi_splat")
        return apply(fields, t, radii5, (amps, last, radius))

    return {
        "diffuse": diffuse,
        "diffuse_multi": diffuse_multi,
        "diffuse_multi_splat": diffuse_multi_splat,
    }


def sharded_sep(config, apply=None):
    """(ops, halo radius) for the sharded rollout's namespaces
    (``parallel/``), or None where :func:`make_ops` gives none.

    The separable op is one pass, so a shard runs it on its local array
    padded by ONE rmax-deep mirror exchange: the mirror is the half-sample
    symmetric ghost the op's edges need at the physical edges; at the seams
    the halo rows are the neighbours' real rows, and the op's own edge
    reflection only reaches the halo's output rows, which are dropped.
    ``apply`` as in :func:`make_ops`."""
    ops = make_ops(config, apply)
    if not ops:
        return None
    iters = config.diffusion_iters
    rmax = 0
    for coeff in (config.velocity_diffusion, config.color_diffusion):
        xs, _ = design_taps(coeff ** 2 / config.dt, iters, rtol=2e-4)
        rmax = max(rmax, max((len(x) - 1) // 2 for x in xs))
    return ops, rmax


def make_batched_ops(config, apply=None) -> dict:
    """:func:`make_ops` for ensembles: the batched ``diffuse``,
    ``diffuse_multi`` and ``diffuse_multi_splat`` over the batched H7
    wrapper (``fastdiffuse_cuda.sep_apply_batched``; ``apply`` replaces
    it, for example :func:`sep_apply_batched`), each member blurred with
    the same nominal taps, and ``check_sweep(dt, diffusions)``, which the
    diffusion sweep (``models/ensemble.py``) calls before its first step.
    Every member's dt and coefficients must be the nominal ones, or the
    call raises ``ValueError``.  {} where :func:`make_ops` gives {}: the
    exact batched H3 then runs each member's own coefficients."""
    if apply is None:
        from cudafluidsimulation_tpu_torch.ops import fastdiffuse_cuda

        apply = fastdiffuse_cuda.sep_apply_batched
    design = _design(config)
    if design is None:
        return {}
    taps5, radii5, taps2, radii2 = design
    iters = config.diffusion_iters
    nominal_dt, coeffs5, coeff_v = _nominal(config)

    def diffuse(fields, dt, diffusion, iters_, *, params=None):
        n, c = fields.shape[:2]
        _check_members("diffuse", dt, ref.member_vec(diffusion, n)[:, None], iters_,
                       nominal_dt, coeff_v, iters)
        return apply(fields, np.broadcast_to(taps2[:1], (c, taps2.shape[1])), radii2)

    def diffuse_multi(fields, dt, coeffs, iters_, *, params=None):
        c = fields.shape[1]
        _check_members("diffuse_multi", dt, ref.member_rows(coeffs, fields.shape[0], c),
                       iters_, nominal_dt, coeffs5[:c], iters)
        return apply(fields, taps5[:c], radii5)

    def diffuse_multi_splat(fields, dt, coeffs, iters_, amps, last, radius, *,
                            params=None):
        # params: the step's diffuse_cols rows; the splat's columns from 2C on
        c = fields.shape[1]
        _check_members("diffuse_multi_splat", dt,
                       ref.member_rows(coeffs, fields.shape[0], c), iters_, nominal_dt,
                       coeffs5[:c], iters)
        return apply(fields, taps5[:c], radii5, (amps, last, radius),
                     params=None if params is None else params[:, 2 * c:])

    def check_sweep(dt, diffusions):
        # before a sweep's first step: each member's viscosity and every
        # step's dt must be the ones the taps were designed for
        k, dts = ref.f32_vec(diffusions), ref.f32_vec(dt)
        if not ((k == coeff_v[0]).all() and (dts == nominal_dt).all()):
            raise ValueError(
                f"fast_diffuse sweep: taps designed for the velocity diffusion "
                f"{coeff_v[0]!r} and dt={nominal_dt!r}; called with diffusions "
                f"{sorted(set(k.tolist()))} and dts {sorted(set(dts.tolist()))}. The taps are "
                "not designed per member (the JAX package's fast sweep runs every member "
                "at the nominal values); use fast_diffuse=False for a viscosity sweep")

    return {
        "diffuse": diffuse,
        "diffuse_multi": diffuse_multi,
        "diffuse_multi_splat": diffuse_multi_splat,
        "check_sweep": check_sweep,
    }
