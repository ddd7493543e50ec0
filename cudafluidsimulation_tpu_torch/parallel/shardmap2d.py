"""The sharded rollout over a 2-D (rows x cols) mesh.

The port of the JAX package's ``parallel/shardmap2d.py``: the grid split
over both axes of a ("rows", "cols") mesh, every neighbour access an
explicit :func:`~.halo.exchange_2d` (rows, then the columns of the
row-padded array, so the corners ride along: a k-sweep 5-point stencil
reads the L1 ball), the boundary conditions only at the physical edges,
and, with ``use_kernels``, the Hopper kernels on the halo-padded local
views (``shardmap_step``'s docstring lists them).  Advection taps are
bounded by the halo in BOTH axes here (``max_displacement`` cells: H1 and
H8 take ``x0``, ``w_phys`` and ``d_x = d``), unlike the rows mesh.
"""

from __future__ import annotations

import types

import torch

from cudafluidsimulation_tpu_torch.config import FluidConfig
from cudafluidsimulation_tpu_torch.ops import fastdiffuse, ref
from cudafluidsimulation_tpu_torch.ops import multigrid as mg
from cudafluidsimulation_tpu_torch.ops.stencil import neighbors
from cudafluidsimulation_tpu_torch.parallel import mesh as _mesh
from cudafluidsimulation_tpu_torch.parallel.halo import exchange_2d
from cudafluidsimulation_tpu_torch.parallel.mesh import (  # noqa: F401 - the JAX module's names
    make_mesh2d, shard_state_2d)
from cudafluidsimulation_tpu_torch.parallel.shardmap_step import (
    KERNELS, _rollout, _schedule, _sharded)


def _comm():
    return _mesh.current()


def _neighbors_2d(ap):
    """(left, right, below, above) of the core of a one-deep exchange_2d
    padded array (both stencil arms from the halo)."""
    return ap[..., 1:-1, :-2], ap[..., 1:-1, 2:], ap[..., :-2, 1:-1], ap[..., 2:, 1:-1]


def sharded_ops_2d(row_axis: str, col_axis: str, h_global: int, w_global: int, d: int,
                   use_kernels: bool = False, burst: int = 8, packed_vel: bool = False,
                   packed_dye: bool = False, fast_path: bool = True, sep_diffuse=None,
                   kernels=None) -> types.SimpleNamespace:
    """The shard-local op namespace for a (rows x cols) mesh (consumed by
    ``make_step``, as ``shardmap_step.sharded_ops``; the same options)."""
    kern = kernels or KERNELS
    ns = types.SimpleNamespace()

    def _bases(hl, wl):
        comm = _comm()
        return comm.axis_index(row_axis) * hl, comm.axis_index(col_axis) * wl

    def _global_grids(hl, wl, device):
        """(ys float, ys int) as (hl, 1), (xs float, xs int) as (1, wl)."""
        r0, c0 = _bases(hl, wl)
        ys_i = torch.arange(hl, device=device)[:, None] + r0
        xs_i = torch.arange(wl, device=device)[None, :] + c0
        return ys_i.to(torch.float32), ys_i, xs_i.to(torch.float32), xs_i

    def _x2d(a, width, edge="clamp"):
        return exchange_2d(a, width, row_axis, col_axis, edge)

    def _pmax(x):
        return _comm().pmax(x, (row_axis, col_axis))

    # -- advection ------------------------------------------------------------

    def _advect(fp, u, v, dt, decay_rate, mode, vel_stats, packed, out=None):
        hl, wl = u.shape
        r0, c0 = _bases(hl, wl)
        win = ref.Window(y0=r0 - d, h_phys=h_global, d=d, x0=c0 - d, w_phys=w_global, d_x=d)
        stats = mode == "field"
        if use_kernels:
            return kern.advect(fp, u, v, dt, decay_rate, mode, win, vel_stats=vel_stats,
                               return_stats=stats, packed=packed, fast_path=fast_path,
                               out=out)
        return ref.advect_window(fp, u, v, dt, decay_rate, mode, win, return_stats=stats,
                                 out=out)

    def advect_velocity(u, v, dt, decay_rate, vel_stats=None, return_stats=False):
        uv, st = _advect(_x2d(torch.stack([u, v]), d), u, v, dt, decay_rate, "field",
                         vel_stats, packed_vel)
        if return_stats:
            return uv[0], uv[1], _pmax(st)
        return uv[0], uv[1]

    def advect_dye(dye, u, v, dt, decay_rate, vel_stats=None, out=None):
        return _advect(_x2d(dye, d), u, v, dt, decay_rate, "dye", vel_stats, packed_dye,
                       out=out)

    def advect_both(u, v, dye, dt, decay_rate, vel_stats=None, return_stats=False,
                    out=None):
        """Velocity and dye off ONE d-deep exchange_2d of the 5-channel
        stack (see ``shardmap_step``'s ``advect_both``)."""
        allp = _x2d(torch.cat([torch.stack([u, v]), dye]), d)
        uv, st = _advect(allp[:2], u, v, dt, decay_rate, "field", vel_stats, packed_vel)
        u2, v2 = uv[0], uv[1]
        st = _pmax(st) if return_stats else None
        dye2 = _advect(allp[2:], u2, v2, dt, decay_rate, "dye", st, packed_dye, out=out)
        if return_stats:
            return u2, v2, dye2, st
        return u2, v2, dye2

    # -- stencil stages ---------------------------------------------------------

    def curl(u, v):
        l, r, b, t = _neighbors_2d(_x2d(torch.stack([u, v]), 1))
        return 0.5 * (r[1] - l[1] - t[0] + b[0])

    def _curl_padded(u, v):
        """The curl with a one-deep valid halo (both axes, corners
        included) from ONE 2-deep exchange_2d of the velocity; the physical
        edges replicate the edge curl row, then column, as
        exchange_2d(curl, 1, clamp) would."""
        uvp = _x2d(torch.stack([u, v]), 2)
        we = 0.5 * (uvp[1][1:-1, 2:] - uvp[1][1:-1, :-2]
                    - uvp[0][2:, 1:-1] + uvp[0][:-2, 1:-1])
        comm = _comm()
        nr, nc = comm.axis_size(row_axis), comm.axis_size(col_axis)
        ri, ci = comm.axis_index(row_axis), comm.axis_index(col_axis)
        low = we[1:2] if ri == 0 else we[:1]
        high = we[-2:-1] if ri == nr - 1 else we[-1:]
        w2 = torch.cat([low, we[1:-1], high], dim=0)
        lft = w2[:, 1:2] if ci == 0 else w2[:, :1]
        rgt = w2[:, -2:-1] if ci == nc - 1 else w2[:, -1:]
        return torch.cat([lft, w2[:, 1:-1], rgt], dim=1)

    def vorticity_confinement_cpu(u, v, dt, vorticity, out=None):
        wp = _curl_padded(u, v)
        w = wp[1:-1, 1:-1]
        al, ar, ab, at = _neighbors_2d(wp.abs())
        fx = 0.5 * (at - ab)
        fy = 0.5 * (ar - al)
        ln = torch.sqrt(fx * fx + fy * fy) + 1e-4
        s = w * float(ref.f32(vorticity)) / ln
        dt = float(ref.f32(dt))
        return ref._into(out, u - fx * s * dt, v - fy * s * dt)

    def vorticity_confinement_gpu(u, v, dt, vorticity, out=None):
        wp = _curl_padded(u, v)
        w = wp[1:-1, 1:-1]
        wl, wr, wb, wt = _neighbors_2d(wp)
        fx = 0.5 * (wt.abs() - wb.abs())
        fy = 0.5 * (wl.abs() - wr.abs())
        ln = torch.sqrt(fx * fx + fy * fy) + 1e-3
        s = w * float(ref.f32(vorticity)) / ln
        dt = float(ref.f32(dt))
        return ref._into(out, u + fx * s * dt, v + fy * s * dt)

    def _pad1(x):
        return _neighbors_2d(_x2d(x, 1))

    def _sweeps(x, alpha, inv_beta, iters):
        for _ in range(iters):
            l, r, b, t = _pad1(x)
            x = (l + r + b + t + x * alpha) * inv_beta
        return x

    def _bursts(fields, run_burst, iters, k, rhs=None):
        """k local sweeps per corner-carrying mirror exchange: the kernel's
        own array edges are wrong by at most a row or column a sweep (the
        trapezoid), the kk-deep margin dropped; at the physical edges the
        mirror is the Neumann ghost."""
        squeeze = fields.dim() == 2
        x = fields[None] if squeeze else fields
        rp = None
        if rhs is not None:
            k = min(k, iters)
            rp = _x2d(rhs, k, edge="mirror")
        left = iters
        while left > 0:
            kk = min(k, left)
            xp = _x2d(x, kk, edge="mirror")
            if rhs is None:
                xp = run_burst(xp, kk)
            else:
                rr = rp if kk == k else rp[..., k - kk:kk - k, k - kk:kk - k]
                xp = run_burst(xp, rr.contiguous(), kk)
            x = xp[..., kk:-kk, kk:-kk]
            left -= kk
        return x[0] if squeeze else x

    def _sep_local(fields, op, dt, coeffs, iters):
        """The fast diffusion on the shard: one rmax-deep corner-carrying
        mirror exchange, the one-device op, the halo dropped."""
        sops, rm = sep_diffuse
        xp = _x2d(fields, rm, edge="mirror")
        return sops[op](xp, dt, coeffs, iters)[..., rm:-rm, rm:-rm]

    def diffuse(fields, dt, diffusion, iters):
        if sep_diffuse is not None:
            return _sep_local(fields, "diffuse", dt, diffusion, iters)
        if use_kernels:
            return _bursts(fields, lambda xp, kk: kern.diffuse(xp, dt, diffusion, kk),
                           iters, burst)
        alpha, inv_beta = ref.diffusion_alphas(dt, [diffusion])
        return _sweeps(fields, float(alpha[0]), float(inv_beta[0]), iters)

    def diffuse_multi(fields, dt, coeffs, iters):
        if sep_diffuse is not None:
            return _sep_local(fields, "diffuse_multi", dt, coeffs, iters)
        if use_kernels:
            return _bursts(fields, lambda xp, kk: kern.diffuse_multi(xp, dt, coeffs, kk),
                           iters, burst)
        alpha, inv_beta = ref.diffusion_alphas(dt, coeffs)
        return _sweeps(fields, ref._per_channel(alpha, fields),
                       ref._per_channel(inv_beta, fields), iters)

    def diffuse_multi_splat(fields, dt, coeffs, iters, amps, last, radius):
        f = diffuse_multi(fields, dt, coeffs, iters)
        ys_f, _, xs_f, _ = _global_grids(f.shape[-2], f.shape[-1], f.device)
        return ref.splat_tail(f, amps, last, radius, xs_f, ys_f)

    def divergence(u, v, half):
        l, r, b, t = _pad1(torch.stack([u, v]))
        dd = (r[0] - l[0]) + (t[1] - b[1])
        return 0.5 * dd if half else dd

    def pressure_solve(div, iters):
        if use_kernels:
            def run_burst(pp, dd, kk):
                return kern.pressure_solve(dd, kk, init=pp[0].contiguous())[None]

            return _bursts(torch.zeros_like(div), run_burst, iters, burst, rhs=div)
        p = torch.zeros_like(div)
        for _ in range(iters):
            l, r, b, t = _pad1(p)
            p = (l + r + b + t - div) * 0.25
        return p

    def project(u, v, p, return_stats=False):
        l, r, b, t = _pad1(p)
        u2, v2 = u - 0.5 * (r - l), v - 0.5 * (t - b)
        if return_stats:
            return u2, v2, _pmax(ref.vel_max(u2, v2))
        return u2, v2

    def _composed_pressure_project(u, v, iters, half):
        p = pressure_solve(divergence(u, v, half), iters)
        u2, v2 = project(u, v, p)
        return u2, v2, p

    def _fused_pressure_project(u, v, iters, half):
        """The rows mesh's fused projection on both axes: one mirror
        exchange_2d of the velocity at depth k + 2, the divergence's
        physical-edge halos reflected from the core, rows first then the
        columns of the row-fixed array (what exchange_2d(div, k + 1,
        mirror) would give)."""
        if iters == 0:
            return u, v, torch.zeros_like(u)
        k = min(burst, iters)
        hd = k + 1
        comm = _comm()
        nr, nc = comm.axis_size(row_axis), comm.axis_size(col_axis)
        ri, ci = comm.axis_index(row_axis), comm.axis_index(col_axis)
        uvp = _x2d(torch.stack([u, v]), hd + 1, edge="mirror")
        dd = ((uvp[0][1:-1, 2:] - uvp[0][1:-1, :-2])
              + (uvp[1][2:, 1:-1] - uvp[1][:-2, 1:-1]))
        if half:
            dd = 0.5 * dd
        rows = dd[hd:-hd, :]
        low = rows[:hd].flip(0) if ri == 0 else dd[:hd]
        high = rows[-hd:].flip(0) if ri == nr - 1 else dd[-hd:]
        d2 = torch.cat([low, rows, high], dim=0)
        cols = d2[:, hd:-hd]
        lft = cols[:, :hd].flip(1) if ci == 0 else d2[:, :hd]
        rgt = cols[:, -hd:].flip(1) if ci == nc - 1 else d2[:, -hd:]
        rp = torch.cat([lft, cols, rgt], dim=1)  # depth hd, both axes
        p = None
        left = iters
        while left > 0:
            kk = min(k, left)
            keep = 1 if left == kk else 0
            if p is None:
                pp = kern.pressure_solve(rp, kk)
                cut = hd - keep
            else:
                dep = kk + keep
                rr = rp if dep == hd else rp[hd - dep:dep - hd, hd - dep:dep - hd]
                xp = _x2d(p, dep, edge="mirror")
                pp = kern.pressure_solve(rr.contiguous(), kk, init=xp)
                cut = kk
            p = pp[cut:-cut, cut:-cut] if cut else pp
            left -= kk
        ps = p[1:-1, 1:-1]
        u2 = u - 0.5 * (p[1:-1, 2:] - p[1:-1, :-2])
        v2 = v - 0.5 * (p[2:, 1:-1] - p[:-2, 1:-1])
        return u2, v2, ps

    def pressure_project(u, v, iters, half, return_stats=False):
        kf = min(burst, max(iters, 1)) + 2
        if use_kernels and min(u.shape[-2], u.shape[-1]) >= kf:
            u2, v2, p = _fused_pressure_project(u, v, iters, half)
        else:
            u2, v2, p = _composed_pressure_project(u, v, iters, half)
        if return_stats:
            return u2, v2, p, _pmax(ref.vel_max(u2, v2))
        return u2, v2, p

    # -- multigrid ---------------------------------------------------------------

    def _mg_smooth(p, rhs, sweeps):
        hl, wl = p.shape[-2], p.shape[-1]
        left = sweeps
        while left > 0:
            k = min(left, hl, wl, 8)
            pr = _x2d(torch.stack([p, rhs]), k, edge="mirror")
            pp, rp = pr[0], pr[1]
            for _ in range(k):
                l, r, b, t = neighbors(pp)
                pp = pp + mg.OMEGA * (0.25 * (l + r + b + t + rp) - pp)
            p = pp[..., k:-k, k:-k]
            left -= k
        return p

    def _mg_smooth_res(p, rhs, sweeps):
        """Pre-smooth and residual off the last burst's exchange_2d (one
        deeper, both axes; see ``shardmap_step``)."""
        hl, wl = p.shape[-2], p.shape[-1]
        left = sweeps
        while left > 0:
            k = min(left, hl - 1, wl - 1, 8)
            last = left == k
            wk = k + 1 if last else k
            pr = _x2d(torch.stack([p, rhs]), wk, edge="mirror")
            pp, rp = pr[0], pr[1]
            for _ in range(k):
                l, r, b, t = neighbors(pp)
                pp = pp + mg.OMEGA * (0.25 * (l + r + b + t + rp) - pp)
            if last:
                l, r, b, t = neighbors(pp)
                res = rp - (4.0 * pp - (l + r + b + t))
                return pp[..., wk:-wk, wk:-wk], res[..., wk:-wk, wk:-wk]
            p = pp[..., wk:-wk, wk:-wk]
            left -= k
        raise AssertionError("sweeps must be >= 1")

    def pressure_solve_mg(div, cycles, tol=0.0, max_cycles=8):
        """The 2-D sharded V-cycle: burst smoothing, the global level
        hierarchy, the levels below the shards' cap gathered along both
        axes; ``tol > 0`` targets the global rms residual (``psum``'d over
        both axes, so every shard stops together)."""
        hl, wl = div.shape
        level = mg._levels(h_global, w_global)
        local_cap = min(mg.local_levels(hl), mg.local_levels(wl))
        bottom = None
        if level > local_cap:
            remaining = level - local_cap + 1
            single_vcycle, _ = mg.make_vcycle(neighbors)

            def bottom(p, rhs, nu1, nu2, coarse_sweeps):
                comm = _comm()

                def gather(x):
                    x = comm.all_gather(x, row_axis, dim=0)
                    return comm.all_gather(x, col_axis, dim=1)

                e = single_vcycle(gather(p), gather(rhs), remaining, nu1, nu2, coarse_sweeps)
                rr, cc = p.shape
                r0 = comm.axis_index(row_axis) * rr
                c0 = comm.axis_index(col_axis) * cc
                return e[r0:r0 + rr, c0:c0 + cc]

        def _mg_prolong(e_c):
            # the bilinear prolongation's one coarse neighbour in both axes
            # (the diagonal too: exchange_2d carries corners)
            return mg.bilinear_from_padded(_x2d(e_c, 1, edge="clamp"))

        vcycle, _, probe, finish = mg.make_vcycle(
            _pad1, smooth_fn=_mg_smooth, bottom_fn=bottom, prolong_fn=_mg_prolong,
            smooth_res_fn=_mg_smooth_res, parts=True)

        def res_mean(r):
            s = _comm().psum(torch.sum(r * r), (row_axis, col_axis))
            return s / float(h_global * w_global)

        return mg.run_cycles(vcycle, probe, finish, res_mean, torch.zeros_like(div), -div,
                             min(level, local_cap), cycles, tol, max_cycles, 2, 2, 20)

    # -- pointwise stages ---------------------------------------------------------

    def _splat(kind):
        def splat(u, v, dye, cur, last, dt, force_scale, radius, color):
            ys_f, _, xs_f, _ = _global_grids(u.shape[0], u.shape[1], u.device)
            return ref.splat_core(u, v, dye, cur, last, dt, force_scale, radius, color,
                                  xs_f, ys_f, kind)

        return splat

    def boundary_strip(u, v, dye, rows):
        _, ys_i, _, _ = _global_grids(u.shape[-2], u.shape[-1], u.device)
        return ref.boundary_strip_core(u, v, dye, rows, ys_i)

    def apply_bloom(rgba, pos, intense, radius):
        ys_f, _, xs_f, _ = _global_grids(rgba.shape[-2], rgba.shape[-1], rgba.device)
        return ref.bloom_core(rgba, pos, intense, radius, xs_f, ys_f)

    def render_frame(dye, pos, intense, radius, active):
        ys_f, _, xs_f, _ = _global_grids(dye.shape[-2], dye.shape[-1], dye.device)
        return ref.render_frame_core(dye, pos, intense, radius, active, xs_f, ys_f)

    ns.bilerp = ref.bilerp
    ns.advect_velocity = advect_velocity
    ns.advect_dye = advect_dye
    ns.advect_both = advect_both
    ns.curl = curl
    ns.vorticity_confinement_cpu = vorticity_confinement_cpu
    ns.vorticity_confinement_gpu = vorticity_confinement_gpu
    ns.diffuse = diffuse
    ns.diffuse_multi = diffuse_multi
    ns.diffuse_multi_splat = diffuse_multi_splat
    ns.divergence = divergence
    ns.pressure_solve = pressure_solve
    ns.pressure_solve_mg = pressure_solve_mg
    ns.pressure_project = pressure_project
    ns.project = project
    ns.splat_cpu = _splat("cpu")
    ns.splat_gpu = _splat("gpu")
    ns.cycle_color = ref.cycle_color
    ns.boundary_strip = boundary_strip
    ns.pack_rgba = ref.pack_rgba
    ns.apply_bloom = apply_bloom
    ns.render_frame = render_frame
    return ns


def _local_ops_2d(config: FluidConfig, mesh: _mesh.Mesh, kernels=None):
    nr, nc = mesh.shape["rows"], mesh.shape["cols"]
    if config.ny % nr != 0 or config.nx % nc != 0:
        raise ValueError(f"grid {config.nx}x{config.ny} not divisible by mesh {nr}x{nc}")
    hl, wl = config.ny // nr, config.nx // nc
    d = config.max_displacement
    if hl < d or wl < d:
        raise ValueError(
            f"shard {wl}x{hl} smaller than max_displacement={d}; use fewer "
            f"shards, a larger grid, or a smaller bound")
    use_kernels, kernels = _schedule(config, kernels)
    sep = (fastdiffuse.sharded_sep(config, apply=kernels.sep_apply)
           if config.fast_diffuse and use_kernels else None)
    return sharded_ops_2d("rows", "cols", config.ny, config.nx, d, use_kernels=use_kernels,
                          burst=min(config.jacobi_burst, hl, wl),
                          packed_vel=config.fast_velocity, packed_dye=config.fast_dye,
                          fast_path=config.advect_fast_path, sep_diffuse=sep,
                          kernels=kernels)


def make_shardmap2d_step(config: FluidConfig, mesh: _mesh.Mesh, kernels=None):
    """One step over a (rows x cols) mesh: ``step(ShardedState, impulse)``
    (``kernels`` as in ``shardmap_step.make_shardmap_step``)."""
    from cudafluidsimulation_tpu_torch.models.pipelines import make_step

    return _sharded(mesh, make_step(config, _local_ops_2d(config, mesh, kernels)))


def make_shardmap2d_rollout(config: FluidConfig, mesh: _mesh.Mesh, kernels=None):
    """A whole rollout over a (rows x cols) mesh."""
    from cudafluidsimulation_tpu_torch.models.pipelines import make_step

    return _sharded(mesh, _rollout(make_step(config, _local_ops_2d(config, mesh, kernels))))
