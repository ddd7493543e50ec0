"""The sharded rollout over a rows mesh: explicit halo exchanges.

The port of the JAX package's ``parallel/shardmap_step.py``.  The fields
are split by rows over the mesh axis "x"; every neighbour access is an
explicit :func:`~.halo.exchange_rows` (one row for stencils,
``max_displacement`` rows for advection), and the boundary conditions
apply only at the physical edges.  The physics is the unchanged
``models.pipelines.make_step`` over a shard-local op namespace
(:func:`sharded_ops`), run once per shard in lockstep (``parallel.mesh.run``).

With ``use_kernels`` (``backend="cuda"``) each shard runs the Hopper
kernels on its halo-padded local views, as the JAX package's sharded step
runs its Pallas kernels:

- H1, or H8 with the fast flags, on one 5-channel ``d``-deep exchange of
  velocity and dye (``advect_cuda.advect_window``: the taps from the cells'
  global coordinates, clamped to the physical grid, bounded by the halo;
  only the interior computed, and its velocity bound ``pmax``'d);
- H3 bursts of ``burst`` sweeps on ``kk``-deep mirror exchanges: the
  kernel's clamped edges are wrong only within ``kk`` rows of the padded
  array's edge after ``kk`` sweeps (the trapezoid argument), the rows
  dropped, whatever bursts the kernel's own planner splits the call into;
- H4's standalone solve, continued from an iterate (``init``) across the
  bursts, with the divergence and the projection folded into the first
  and last exchanges (:func:`sharded_ops`' ``_fused_pressure_project``);
- H7 with ``fast_diffuse``: one ``rmax``-deep mirror exchange
  (``ops.fastdiffuse.sharded_sep``).

The confinement, the divergence and projection of the composed path, the
multigrid smoother and the summed residual stay plain PyTorch, as they are
jnp in the JAX package.  The port's kernels take any shape, so a ``cuda``
config runs them at every shard geometry: there is no fallback to the
plain ops (the JAX package falls back where its TPU kernels refuse a
shard's geometry).  The rows mesh bounds only vertical taps: horizontal
ones read the whole row, as ``utils.health.clamp_axes("cuda", "rows")``
says (the JAX package's column-tiled advection also bounds them on wide
shards, a plan of its TPU memory).

With ``unbounded`` the namespace advects as the global step of
``parallel/sharded.py`` (the JAX package's auto-SPMD step) does: each
shard gathers every row over the axis and advects its own rows through
H1/H8's rows-unbounded window, so no tap is bounded.
"""

from __future__ import annotations

import types

import torch

from cudafluidsimulation_tpu_torch.config import FluidConfig
from cudafluidsimulation_tpu_torch.ops import (
    advect_cuda, advect_packed, fastdiffuse, fastdiffuse_cuda, jacobi_cuda, ref)
from cudafluidsimulation_tpu_torch.ops import multigrid as mg
from cudafluidsimulation_tpu_torch.ops.stencil import neighbors, shift_x
from cudafluidsimulation_tpu_torch.parallel import mesh as _mesh
from cudafluidsimulation_tpu_torch.parallel.halo import exchange_rows, neighbors_padded
from cudafluidsimulation_tpu_torch.parallel.mesh import ShardedState
from cudafluidsimulation_tpu_torch.utils.impulse import num_steps, slice_step

# the kernels a shard runs (their wrappers take the plain versions for CPU
# tensors), and their plain versions for any device (the meta device of
# halo.measure_halo_traffic)
KERNELS = types.SimpleNamespace(
    advect=advect_cuda.advect_window, diffuse=jacobi_cuda.diffuse,
    diffuse_multi=jacobi_cuda.diffuse_multi, pressure_solve=jacobi_cuda.pressure_solve,
    sep_apply=fastdiffuse_cuda.sep_apply)
PLAIN = types.SimpleNamespace(
    advect=advect_packed.window_plain, diffuse=ref.diffuse,
    diffuse_multi=ref.diffuse_multi, pressure_solve=ref.pressure_solve,
    sep_apply=fastdiffuse.sep_apply)


def _comm():
    return _mesh.current()


def _rows(hl: int, w: int, axis_name: str, device):
    """(float, int) global row coordinates of this shard's (hl, w) cells,
    as (hl, 1) columns, and the (1, w) float column coordinates."""
    base = _comm().axis_index(axis_name) * hl
    ys_i = torch.arange(hl, device=device)[:, None] + base
    xs_f = torch.arange(w, dtype=torch.float32, device=device)[None, :]
    return ys_i.to(torch.float32), ys_i, xs_f


def _stencil_sweeps(x, alpha, inv_beta, iters, pad):
    """``iters`` Jacobi sweeps (L + R + B + T + alpha*C) * inv_beta with one
    exchange a sweep (``pad(x)`` -> its (left, right, below, above))."""
    for _ in range(iters):
        l, r, b, t = pad(x)
        x = (l + r + b + t + x * alpha) * inv_beta
    return x


def sharded_ops(axis_name: str, h_global: int, d: int, use_kernels: bool = False,
                burst: int = 8, packed_vel: bool = False, packed_dye: bool = False,
                fast_path: bool = True, sep_diffuse=None,
                kernels=None, unbounded: bool = False) -> types.SimpleNamespace:
    """The shard-local op namespace that ``make_step`` runs on a rows mesh.

    With ``use_kernels`` the advection, the Jacobi stages and the fast
    diffusion run ``kernels`` (default :data:`KERNELS`) per shard, with a
    ``burst``-deep halo exchanged once per ``burst`` sweeps instead of once
    a sweep.  ``packed_vel``/``packed_dye``/``fast_path`` thread the config's
    ``fast_velocity``/``fast_dye``/``advect_fast_path`` into the advection
    (H8); ``sep_diffuse`` = (the fast diffusion's ops, halo radius) threads
    ``fast_diffuse`` (``ops.fastdiffuse.sharded_sep``).  ``unbounded``
    advects from every row of the grid, gathered over the axis, instead of
    a ``d``-deep exchange (``d`` unused)."""
    kern = kernels or KERNELS
    ns = types.SimpleNamespace()

    def pmax_repl(u2, v2):
        """Replicated ``ref.vel_max`` of the row-sharded velocity."""
        return _comm().pmax(ref.vel_max(u2, v2), axis_name)

    def _window(hl):
        first = _comm().axis_index(axis_name) * hl  # the shard's first global row
        if unbounded:
            return ref.Window(y0=0, h_phys=h_global, d=0, y_in=first)
        # the global row of padded row 0
        return ref.Window(y0=first - d, h_phys=h_global, d=d)

    def _view(x):
        """What the advection reads of ``x``: its d-deep clamp exchange,
        or every row of the grid."""
        if unbounded:
            return _comm().all_gather(x, axis_name, dim=x.dim() - 2)
        return exchange_rows(x, d, axis_name)

    def _advect(fp, u, v, dt, decay_rate, mode, vel_stats, packed, out=None):
        """The window advection of the interior of the d-padded ``fp``
        through the cells' (u, v); in the velocity mode also the interior's
        local bound."""
        win = _window(u.shape[0])
        stats = mode == "field"
        if use_kernels:
            return kern.advect(fp, u, v, dt, decay_rate, mode, win, vel_stats=vel_stats,
                               return_stats=stats, packed=packed, fast_path=fast_path,
                               out=out)
        return ref.advect_window(fp, u, v, dt, decay_rate, mode, win, return_stats=stats,
                                 out=out)

    def advect_velocity(u, v, dt, decay_rate, vel_stats=None, return_stats=False):
        fp = _view(torch.stack([u, v]))
        uv, st = _advect(fp, u, v, dt, decay_rate, "field", vel_stats, packed_vel)
        if return_stats:
            return uv[0], uv[1], _comm().pmax(st, axis_name)
        return uv[0], uv[1]

    def advect_dye(dye, u, v, dt, decay_rate, vel_stats=None, out=None):
        fp = _view(dye)
        return _advect(fp, u, v, dt, decay_rate, "dye", vel_stats, packed_dye, out=out)

    def advect_both(u, v, dye, dt, decay_rate, vel_stats=None, return_stats=False,
                    out=None):
        """Velocity and dye advection off ONE d-deep exchange of the
        5-channel (velocity, dye) stack: both advections tap pre-advection
        data (the reference's double buffer, GPUFluidSim.cu:620-622), so the
        dye's halo rides the velocity's exchange although its backtrace uses
        the new velocity, which only the interior cells need.  ``out``
        receives the dye."""
        allp = _view(torch.cat([torch.stack([u, v]), dye]))
        uv, st = _advect(allp[:2], u, v, dt, decay_rate, "field", vel_stats, packed_vel)
        u2, v2 = uv[0], uv[1]
        st = _comm().pmax(st, axis_name) if return_stats else None
        dye2 = _advect(allp[2:], u2, v2, dt, decay_rate, "dye", st, packed_dye, out=out)
        if return_stats:
            return u2, v2, dye2, st
        return u2, v2, dye2

    def curl(u, v):
        # one stacked exchange for both components
        l, r, b, t = neighbors_padded(exchange_rows(torch.stack([u, v]), 1, axis_name))
        return 0.5 * (r[1] - l[1] - t[0] + b[0])

    def _curl_padded(u, v):
        """The curl with a one-row valid halo from ONE 2-deep velocity
        exchange; the physical edges' halo rows are the edge curl row,
        what exchange_rows(curl, 1, clamp) would give."""
        uvp = exchange_rows(torch.stack([u, v]), 2, axis_name)
        vl, vr = shift_x(uvp[1], -1), shift_x(uvp[1], 1)
        we = 0.5 * (vr[1:-1] - vl[1:-1] - uvp[0][2:] + uvp[0][:-2])
        comm = _comm()
        n, idx = comm.axis_size(axis_name), comm.axis_index(axis_name)
        low = we[1:2] if idx == 0 else we[:1]
        high = we[-2:-1] if idx == n - 1 else we[-1:]
        return torch.cat([low, we[1:-1], high], dim=0)

    def vorticity_confinement_cpu(u, v, dt, vorticity, out=None):
        wp = _curl_padded(u, v)
        w = wp[1:-1]
        al, ar, ab, at = neighbors_padded(wp.abs())
        fx = 0.5 * (at - ab)
        fy = 0.5 * (ar - al)
        ln = torch.sqrt(fx * fx + fy * fy) + 1e-4
        s = w * float(ref.f32(vorticity)) / ln
        dt = float(ref.f32(dt))
        return ref._into(out, u - fx * s * dt, v - fy * s * dt)

    def vorticity_confinement_gpu(u, v, dt, vorticity, out=None):
        wp = _curl_padded(u, v)
        w = wp[1:-1]
        wl, wr, wb, wt = neighbors_padded(wp)
        fx = 0.5 * (wt.abs() - wb.abs())
        fy = 0.5 * (wl.abs() - wr.abs())
        ln = torch.sqrt(fx * fx + fy * fy) + 1e-3
        s = w * float(ref.f32(vorticity)) / ln
        dt = float(ref.f32(dt))
        return ref._into(out, u + fx * s * dt, v + fy * s * dt)

    def _pad1(x):
        return neighbors_padded(exchange_rows(x, 1, axis_name))

    def _bursts(fields, run_burst, iters, k, rhs=None):
        """A k-row mirror halo once per k local sweeps.  The kernel's own
        array edges are wrong only within k rows after k sweeps (the
        trapezoid argument), the rows dropped; at the physical edges the
        mirror is the Neumann ghost.  ``rhs`` (the divergence) is constant
        across bursts: exchanged once at full depth, cut down for a shorter
        last burst."""
        squeeze = fields.dim() == 2
        x = fields[None] if squeeze else fields
        rp = None
        if rhs is not None:
            k = min(k, iters)
            rp = exchange_rows(rhs, k, axis_name, edge="mirror")
        left = iters
        while left > 0:
            kk = min(k, left)
            xp = exchange_rows(x, kk, axis_name, edge="mirror")
            if rhs is None:
                xp = run_burst(xp, kk)
            else:
                rr = rp if kk == k else rp[..., k - kk:kk - k, :]
                xp = run_burst(xp, rr, kk)
            x = xp[..., kk:-kk, :]
            left -= kk
        return x[0] if squeeze else x

    def _sep_local(fields, op, dt, coeffs, iters):
        """The fast diffusion on the shard: one rmax-deep mirror exchange,
        the one-device op on the padded array, the halo rows dropped."""
        sops, rm = sep_diffuse
        xp = exchange_rows(fields, rm, axis_name, edge="mirror")
        return sops[op](xp, dt, coeffs, iters)[..., rm:-rm, :]

    def diffuse(fields, dt, diffusion, iters):
        if sep_diffuse is not None:
            return _sep_local(fields, "diffuse", dt, diffusion, iters)
        if use_kernels:
            return _bursts(fields, lambda xp, kk: kern.diffuse(xp, dt, diffusion, kk),
                           iters, burst)
        alpha, inv_beta = ref.diffusion_alphas(dt, [diffusion])
        return _stencil_sweeps(fields, float(alpha[0]), float(inv_beta[0]), iters, _pad1)

    def diffuse_multi(fields, dt, coeffs, iters):
        if sep_diffuse is not None:
            return _sep_local(fields, "diffuse_multi", dt, coeffs, iters)
        if use_kernels:
            return _bursts(fields, lambda xp, kk: kern.diffuse_multi(xp, dt, coeffs, kk),
                           iters, burst)
        alpha, inv_beta = ref.diffusion_alphas(dt, coeffs)
        return _stencil_sweeps(fields, ref._per_channel(alpha, fields),
                               ref._per_channel(inv_beta, fields), iters, _pad1)

    def diffuse_multi_splat(fields, dt, coeffs, iters, amps, last, radius):
        # the local diffusion, then the splat tail at global rows (the
        # tail is pointwise, so the composition is exact)
        f = diffuse_multi(fields, dt, coeffs, iters)
        ys_f, _, xs_f = _rows(f.shape[-2], f.shape[-1], axis_name, f.device)
        return ref.splat_tail(f, amps, last, radius, xs_f, ys_f)

    def divergence(u, v, half):
        l, r, b, t = neighbors_padded(exchange_rows(torch.stack([u, v]), 1, axis_name))
        dd = (r[0] - l[0]) + (t[1] - b[1])
        return 0.5 * dd if half else dd

    def pressure_solve(div, iters):
        if use_kernels:
            def run_burst(pp, dd, kk):
                # the burst loop threads (1, H, W); the solve takes (H, W)
                return kern.pressure_solve(dd, kk, init=pp[0])[None]

            return _bursts(torch.zeros_like(div), run_burst, iters, burst, rhs=div)
        p = torch.zeros_like(div)
        for _ in range(iters):
            l, r, b, t = _pad1(p)
            p = (l + r + b + t - div) * 0.25
        return p

    def project(u, v, p, return_stats=False):
        pl, pr, pb, pt = _pad1(p)
        u2, v2 = u - 0.5 * (pr - pl), v - 0.5 * (pt - pb)
        if return_stats:
            return u2, v2, pmax_repl(u2, v2)
        return u2, v2

    def _composed_pressure_project(u, v, iters, half):
        p = pressure_solve(divergence(u, v, half), iters)
        u2, v2 = project(u, v, p)
        return u2, v2, p

    def _fused_pressure_project(u, v, iters, half):
        """Divergence, burst Jacobi and projection with the per-op exchanges
        folded into the bursts' (the JAX package's sharded fused
        projection).  One mirror exchange of the velocity at depth k + 2
        makes the local divergence valid to depth k + 1; burst 1 runs from
        p = 0 with no pressure exchange (its first sweep is -div/4 whatever
        the edge holds, so the padded edge reaches only kk - 1 rows after kk
        sweeps); the last burst exchanges one row more, so the pressure it
        keeps has a valid one-row halo for the local gradient.  At the
        physical edges the divergence's halo is the even reflection of the
        core (the Neumann ghost d(-1-j) = d(j), not the divergence of the
        mirrored velocity)."""
        if iters == 0:
            return u, v, torch.zeros_like(u)
        k = min(burst, iters)
        hd = k + 1
        comm = _comm()
        n, idx = comm.axis_size(axis_name), comm.axis_index(axis_name)
        uvp = exchange_rows(torch.stack([u, v]), hd + 1, axis_name, edge="mirror")
        ul, ur = shift_x(uvp[0], -1), shift_x(uvp[0], 1)
        dd = (ur[1:-1] - ul[1:-1]) + (uvp[1][2:] - uvp[1][:-2])
        if half:
            dd = 0.5 * dd
        core = dd[hd:-hd]
        low = core[:hd].flip(0) if idx == 0 else dd[:hd]
        high = core[-hd:].flip(0) if idx == n - 1 else dd[-hd:]
        rp = torch.cat([low, core, high], dim=0)  # depth hd
        p = None
        left = iters
        while left > 0:
            kk = min(k, left)
            # rows to keep after this burst: a one-row halo after the last
            keep = 1 if left == kk else 0
            if p is None:  # burst 1 from p = 0: no pressure exchange
                pp = kern.pressure_solve(rp, kk)
                cut = hd - keep
            else:
                dep = kk + keep
                rr = rp if dep == hd else rp[hd - dep:dep - hd]
                xp = exchange_rows(p, dep, axis_name, edge="mirror")
                pp = kern.pressure_solve(rr.contiguous(), kk, init=xp)
                cut = kk
            p = pp[cut:-cut] if cut else pp
            left -= kk
        ps = p[1:-1]
        u2 = u - 0.5 * (shift_x(ps, 1) - shift_x(ps, -1))
        v2 = v - 0.5 * (p[2:] - p[:-2])
        return u2, v2, ps

    def pressure_project(u, v, iters, half, return_stats=False):
        if use_kernels and u.shape[0] >= min(burst, max(iters, 1)) + 2:
            u2, v2, p = _fused_pressure_project(u, v, iters, half)
        else:
            # composed per op (short shards)
            u2, v2, p = _composed_pressure_project(u, v, iters, half)
        if return_stats:
            return u2, v2, p, pmax_repl(u2, v2)
        return u2, v2, p

    def _mg_smooth(p, rhs, sweeps):
        """Damped Jacobi with k sweeps per (p, rhs) exchange: the padded
        edges' error moves a row a sweep, so the kept rows equal sweeping
        with an exchange a sweep; mirror rows at the physical edges are the
        Neumann ghost."""
        hl = p.shape[-2]
        left = sweeps
        while left > 0:
            k = min(left, hl, 8)
            pr = exchange_rows(torch.stack([p, rhs]), k, axis_name, edge="mirror")
            pp, rp = pr[0], pr[1]
            for _ in range(k):
                l, r, b, t = neighbors(pp)
                pp = pp + mg.OMEGA * (0.25 * (l + r + b + t + rp) - pp)
            p = pp[..., k:-k, :]
            left -= k
        return p

    def _mg_smooth_res(p, rhs, sweeps):
        """Pre-smooth and its residual, the residual off the last burst's
        exchange (one row deeper): rows [k + 1, hl + k + 1) of the padded
        residual are exact, the shard."""
        hl = p.shape[-2]
        left = sweeps
        while left > 0:
            k = min(left, hl - 1, 8)
            last = left == k
            wk = k + 1 if last else k
            pr = exchange_rows(torch.stack([p, rhs]), wk, axis_name, edge="mirror")
            pp, rp = pr[0], pr[1]
            for _ in range(k):
                l, r, b, t = neighbors(pp)
                pp = pp + mg.OMEGA * (0.25 * (l + r + b + t + rp) - pp)
            if last:
                l, r, b, t = neighbors(pp)
                res = rp - (4.0 * pp - (l + r + b + t))
                return pp[..., wk:-wk, :], res[..., wk:-wk, :]
            p = pp[..., wk:-wk, :]
            left -= k
        raise AssertionError("sweeps must be >= 1")

    def pressure_solve_mg(div, cycles, tol=0.0, max_cycles=8):
        """The V-cycle of ``ops.multigrid.make_vcycle`` with exchanged
        neighbourhoods and the burst smoother above.  The levels come from
        the global grid; once a shard's rows stop halving, the remaining
        coarse levels are gathered onto every shard and finished with the
        one-device V-cycle.  ``tol > 0`` targets the global rms residual
        (``psum``'d: every shard stops at the same cycle)."""
        hl, w = div.shape
        level = mg._levels(h_global, w)
        local_cap = mg.local_levels(hl)
        bottom = None
        if level > local_cap:
            remaining = level - local_cap + 1
            single_vcycle, _ = mg.make_vcycle(neighbors)

            def bottom(p, rhs, nu1, nu2, coarse_sweeps):
                comm = _comm()
                p_full = comm.all_gather(p, axis_name, dim=0)
                r_full = comm.all_gather(rhs, axis_name, dim=0)
                e = single_vcycle(p_full, r_full, remaining, nu1, nu2, coarse_sweeps)
                rows = p.shape[0]
                start = comm.axis_index(axis_name) * rows
                return e[start:start + rows]

        def _mg_prolong(e_c):
            # the bilinear prolongation's rows from the exchange (clamped at
            # the physical edges, as the one-device pad), its columns local
            ep = exchange_rows(e_c, 1, axis_name, edge="clamp")
            return mg.bilinear_from_padded(torch.cat([ep[:, :1], ep, ep[:, -1:]], dim=1))

        vcycle, _, probe, finish = mg.make_vcycle(
            _pad1, smooth_fn=_mg_smooth, bottom_fn=bottom, prolong_fn=_mg_prolong,
            smooth_res_fn=_mg_smooth_res, parts=True)

        def res_mean(r):
            # the global mean of the probe's residual, summed in shard order
            return _comm().psum(torch.sum(r * r), axis_name) / float(h_global * w)

        return mg.run_cycles(vcycle, probe, finish, res_mean, torch.zeros_like(div), -div,
                             min(level, local_cap), cycles, tol, max_cycles, 2, 2, 20)

    def _splat(kind):
        def splat(u, v, dye, cur, last, dt, force_scale, radius, color):
            ys_f, _, xs_f = _rows(u.shape[0], u.shape[1], axis_name, u.device)
            return ref.splat_core(u, v, dye, cur, last, dt, force_scale, radius, color,
                                  xs_f, ys_f, kind)

        return splat

    def boundary_strip(u, v, dye, rows):
        _, ys_i, _ = _rows(u.shape[-2], u.shape[-1], axis_name, u.device)
        return ref.boundary_strip_core(u, v, dye, rows, ys_i)

    def apply_bloom(rgba, pos, intense, radius):
        ys_f, _, xs_f = _rows(rgba.shape[-2], rgba.shape[-1], axis_name, rgba.device)
        return ref.bloom_core(rgba, pos, intense, radius, xs_f, ys_f)

    def render_frame(dye, pos, intense, radius, active):
        ys_f, _, xs_f = _rows(dye.shape[-2], dye.shape[-1], axis_name, dye.device)
        return ref.render_frame_core(dye, pos, intense, radius, active, xs_f, ys_f)

    ns.bilerp = ref.bilerp  # not called by the pipeline
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


def _schedule(config: FluidConfig, kernels):
    """(use_kernels, kernels): ``kernels`` given selects the kernel schedule
    on them; else the config's backend (``cuda``: :data:`KERNELS`)."""
    if kernels is not None:
        return True, kernels
    return config.resolve_backend() == "cuda", KERNELS


def _local_ops(config: FluidConfig, mesh: _mesh.Mesh, axis_name: str = "x", kernels=None,
               unbounded: bool = False):
    """Check the sharding geometry and build the shard-local op set
    (``unbounded``: the global step's advection, which no shard height
    bounds)."""
    n = mesh.shape[axis_name]
    if config.ny % n != 0:
        raise ValueError(f"ny={config.ny} not divisible by mesh axis {n}")
    hl = config.ny // n
    if hl < config.max_displacement and not unbounded:
        # silently tightening the advection bound would make the same config
        # produce different physics depending on device count
        raise ValueError(
            f"shard height {hl} is smaller than max_displacement="
            f"{config.max_displacement}; use fewer shards, a taller grid, or "
            f"a smaller max_displacement")
    use_kernels, kernels = _schedule(config, kernels)
    sep = (fastdiffuse.sharded_sep(config, apply=kernels.sep_apply)
           if config.fast_diffuse and use_kernels else None)
    return sharded_ops(axis_name, config.ny, config.max_displacement,
                       use_kernels=use_kernels, burst=min(config.jacobi_burst, hl),
                       packed_vel=config.fast_velocity, packed_dye=config.fast_dye,
                       fast_path=config.advect_fast_path, sep_diffuse=sep, kernels=kernels,
                       unbounded=unbounded)


def _sharded(mesh: _mesh.Mesh, per_shard):
    """``fn(state, impulse)`` over a :class:`ShardedState`: ``per_shard``
    on every shard in lockstep; ``fn.counts`` holds each shard's
    communicator counts of the last call."""

    def fn(state: ShardedState, imp) -> ShardedState:
        if state.mesh.dims != mesh.dims or len(state.shards) != mesh.size:
            raise ValueError(f"state sharded over {state.mesh}, the step over {mesh}")
        results, comms = _mesh.run(mesh, per_shard, [(s, imp) for s in state.shards])
        fn.counts = [c.counts for c in comms]
        return ShardedState(mesh, tuple(results))

    fn.counts = None
    return fn


def make_shardmap_step(config: FluidConfig, mesh: _mesh.Mesh, axis_name: str = "x",
                       kernels=None):
    """One step over the rows mesh: ``step(ShardedState, impulse)``.
    ``kernels`` runs the kernel schedule on the given functions whatever
    the backend (:data:`KERNELS`, whose wrappers run their plain versions
    on CPU shards, or :data:`PLAIN`)."""
    from cudafluidsimulation_tpu_torch.models.pipelines import make_step

    return _sharded(mesh, make_step(config, _local_ops(config, mesh, axis_name, kernels)))


def make_shardmap_rollout(config: FluidConfig, mesh: _mesh.Mesh, axis_name: str = "x",
                          kernels=None):
    """A whole rollout over the rows mesh, ``run(ShardedState, impulses)``:
    every shard steps through the stream in its own thread, meeting the
    others only at the collectives."""
    from cudafluidsimulation_tpu_torch.models.pipelines import make_step

    return _sharded(mesh, _rollout(make_step(config, _local_ops(config, mesh, axis_name,
                                                                 kernels))))


def _rollout(step):
    def run(state, impulses):
        for i in range(num_steps(impulses)):
            state = step(state, slice_step(impulses, i))
        return state

    return run
