"""SL-layout derive -> backward -> Armijo-slope pipeline.

The batched solver's derivative, AL-augmentation, backward and slope chain
runs in the SL layout ``[T, *dims, S, 128]`` (batch on the two trailing
axes), so the derivative stacks are born in the layout the backward
recursion (ops/packed_backward.py) reads, and no stack is ever re-laid-out.
Only the small outputs (gains K/k, per-instance scalars) leave that layout.

``make_derive_backward_sl`` serves the SL batched solver (core/solve_sl.py).
``make_derive_backward`` is the ``Options(backward_pass="packed")`` entry of
the per-instance solve: unbatched calls take the per-instance scan path,
and under ``vmap`` the batched rule runs this pipeline wherever the
recursion is the Pallas-Triton kernel (``packed_backward.riccati_impl``).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..core.spec import ProblemSpec
from . import packed_backward as pk


def _bt2_tmap(fn):
    """vmap a per-(x,u,w) function over [t, :, S, 128] SL-layout arrays
    (t on axis 0, batch split over the two trailing axes)."""
    return jax.vmap(
        jax.vmap(
            jax.vmap(fn, in_axes=-1, out_axes=-1), in_axes=-1, out_axes=-1
        ),
        in_axes=0,
        out_axes=0,
    )


def _grouped_bt2(fns, comb_key, rows, args):
    """SL-layout analog of derivatives._grouped over combined stage-type
    keys; args are [rows, :, S, 128] arrays."""
    uniq = np.unique(comb_key)
    if len(uniq) == 1:
        return _bt2_tmap(fns[int(uniq[0])])(*args)
    outs = None
    for key in uniq:
        idx = np.nonzero(comb_key == key)[0]
        res = _bt2_tmap(fns[int(key)])(*(a[idx] for a in args))
        if outs is None:
            outs = jax.tree.map(
                lambda r: jnp.zeros((rows,) + r.shape[1:], r.dtype), res
            )
        outs = jax.tree.map(lambda o, r, i=idx: o.at[i].set(r), outs, res)
    return outs


def _build(spec: ProblemSpec, options, interpret: bool = False):
    """Construct (single, batched_sl, batched) for this spec/options."""
    from . import al as al_ops
    from . import derivatives as dv
    from .backward import backward_pass
    from .forward import armijo_slope, trajectory_sensitivities

    T, nx, nu, nc = spec.T, spec.nx, spec.nu, spec.nc
    Tm1 = T - 1
    ineq_np = spec.ineq_mask
    x_mask_np = spec.x_mask
    u_mask_np = spec.u_mask

    # ---- per-instance path (also the reference semantics) -----------------

    def single(xs, us, ws, duals, penalty, c, reg):
        ineq = jnp.asarray(ineq_np)
        x_mask = jnp.asarray(x_mask_np)
        u_mask = jnp.asarray(u_mask_np)
        fx, fu = dv.dynamics_jacobians(spec, xs, us, ws)
        gx, gu = dv.cost_gradients(spec, xs, us, ws)
        gxx, guu, gux = dv.cost_hessians(spec, xs, us, ws)
        if nc > 0:
            cx, cu = dv.constraint_jacobians(spec, xs, us, ws)
            dgx, dgu, dgxx, dguu, dgux = al_ops.al_gradient_terms(
                c, cx, cu, duals, penalty, ineq
            )
            gx, gu = gx + dgx, gu + dgu
            gxx, guu, gux = gxx + dgxx, guu + dguu, gux + dgux
        K, k, Qx, Qu, p, _ok, reg_next = backward_pass(
            fx, fu, gx, gu, gxx, guu, gux, u_mask, reg, options
        )
        lx = jnp.abs(Qx - p) * x_mask[:-1]
        lu = jnp.abs(Qu) * u_mask
        grad_norm = jnp.maximum(jnp.max(lx), jnp.max(lu))
        zx, zu = trajectory_sensitivities(fx, fu, K, k, unroll=options.scan_unroll)
        slope = armijo_slope(Qx, Qu, p, zx, zu)
        return K, k, slope, grad_norm, reg_next

    # ---- batched batch-trailing pipeline -----------------------------------

    # combined per-timestep derivative function per (dyn, cost, con) type key
    n_cost = len(spec.cost_eval)
    n_con = len(spec.con_eval)
    comb_key = (
        spec.dyn_tidx.astype(np.int64) * n_cost + spec.cost_tidx[:Tm1]
    ) * n_con + spec.con_tidx[:Tm1]
    uniq_keys = np.unique(comb_key)
    fns = {}
    for key in uniq_keys:
        di, rest = divmod(int(key), n_cost * n_con)
        gi, ci = divmod(rest, n_con)
        dj, cg, ch, cj = (
            spec.dyn_jac[di], spec.cost_grad[gi], spec.cost_hess[gi],
            spec.con_jac[ci],
        )

        def per_t(x, u, w, dj=dj, cg=cg, ch=ch, cj=cj):
            fx, fu = dj(x, u, w)
            gx, gu = cg(x, u, w)
            gxx, guu, gux = ch(x, u, w)
            if nc > 0:
                cx, cu = cj(x, u, w)
                return fx, fu, gx, gu, gxx, guu, gux, cx, cu
            return fx, fu, gx, gu, gxx, guu, gux

        fns[int(key)] = per_t

    gT = int(spec.cost_tidx[-1])
    cT = int(spec.con_tidx[-1])
    impl = pk.riccati_impl(nx, nu, jax.default_backend(), interpret)

    def batched_sl(xs_t, us_t, ws_t, lam, rho, c_t, reg_sl, valid=None):
        """SL-native core: all arguments in SL layout [T, *dims, S, 128]
        (batch split over the two trailing axes), ``reg_sl`` [S, 128].

        The derivative stacks are born in the layout the backward recursion
        reads, so no stack is ever re-laid-out.  ``valid`` (bool [S, 128]
        or None) marks real batch lanes: padding lanes are excluded from the
        regularization-retry convergence test so garbage pads can never
        force extra recursion sweeps.

        Returns SL outputs (K [Tm1,nu,nx,S,L], k [Tm1,nu,S,L],
        slope [S,L], grad_norm [S,L], reg_next [S,L]).
        """
        dtype = xs_t.dtype
        S = xs_t.shape[-2]
        stacks = _grouped_bt2(
            fns, comb_key, Tm1, (xs_t[:-1], us_t, ws_t[:-1])
        )
        if nc > 0:
            fx, fu, gx_s, gu, gxx_s, guu, gux, cx_s, cu = stacks
        else:
            fx, fu, gx_s, gu, gxx_s, guu, gux = stacks

        # terminal stage (u = 0)
        u0 = jnp.zeros((nu, S, 128), dtype)
        bmap = lambda fn: jax.vmap(
            jax.vmap(fn, in_axes=-1, out_axes=-1), in_axes=-1, out_axes=-1
        )
        gxT, _ = bmap(spec.cost_grad[gT])(xs_t[-1], u0, ws_t[-1])
        gxxT, _, _ = bmap(spec.cost_hess[gT])(xs_t[-1], u0, ws_t[-1])
        gx = jnp.concatenate([gx_s, gxT[None]], axis=0)     # [T,nx,S,L]
        gxx = jnp.concatenate([gxx_s, gxxT[None]], axis=0)  # [T,nx,nx,S,L]

        # AL Gauss-Newton augmentation in SL layout
        if nc > 0:
            cxT, _ = bmap(spec.con_jac[cT])(xs_t[-1], u0, ws_t[-1])
            cx = jnp.concatenate([cx_s, cxT[None]], axis=0)  # [T,nc,nx,S,L]
            ineq = jnp.asarray(ineq_np)[:, :, None, None]
            inactive = ineq & (c_t < 0.0) & (lam == 0.0)
            a = jnp.where(inactive, 0.0, 1.0).astype(dtype)
            irho = rho * a
            ctmp = lam + irho * c_t
            # broadcast-multiply-reduce, NOT einsum: a dot_general with a
            # 4-wide contraction and (t, S, lane) batch dims relayouts
            # everything and dominates the pipeline (round-1 lesson,
            # ops/linalg_small.py); the reduce-of-product form fuses.
            cxr = cx * irho[:, :, None]                      # [t,c,i,a,b]
            cur = cu * irho[:-1, :, None]
            gx = gx + jnp.sum(cx * ctmp[:, :, None], axis=1)
            gxx = gxx + jnp.sum(
                cxr[:, :, :, None] * cx[:, :, None, :], axis=1
            )
            gu = gu + jnp.sum(cu * ctmp[:-1, :, None], axis=1)
            guu = guu + jnp.sum(
                cur[:, :, :, None] * cu[:, :, None, :], axis=1
            )
            gux = gux + jnp.sum(
                cur[:, :, :, None] * cx[:-1, :, None, :], axis=1
            )

        stacks_bw = (fx, fu, gx[:-1], gu, gxx[:-1], guu, gux)
        u_mask = jnp.asarray(u_mask_np)

        # adaptive-regularization retry around the recursion (same policy as
        # ops/backward.py::backward_pass, batched explicitly)
        reg_sl = reg_sl.astype(dtype)

        def run(reg_run):
            return pk.backward_pass_sl(
                stacks_bw, gxx[-1], gx[-1], reg_run, u_mask, impl=impl,
                unroll=options.scan_unroll,
            )

        def cond(s):
            i, _, _, ok, _ = s
            return (~jnp.all(ok)) & (i <= options.max_regularization_steps)

        def body(s):
            i, reg_try, reg_used, ok, _ = s
            reg_run = jnp.where(ok, reg_used, reg_try)
            outs = run(reg_run)
            ok_now = outs[-1] > 0.5
            if valid is not None:
                ok_now = ok_now | ~valid
            reg_next = jnp.clip(
                jnp.maximum(reg_run * options.regularization_scale,
                            options.regularization_min),
                options.regularization_min,
                options.regularization_max,
            )
            return (i + 1, jnp.where(ok_now, reg_run, reg_next),
                    reg_run, ok_now, outs)

        outs0 = jax.tree.map(
            jnp.zeros_like, jax.eval_shape(run, reg_sl)
        )
        state = (
            jnp.asarray(0), reg_sl, reg_sl,
            jnp.zeros(reg_sl.shape, bool), outs0,
        )
        _, _, reg_used, ok, outs = jax.lax.while_loop(cond, body, state)
        K_t, k_t, Qx_t, Qu_t, p_t, _ok_t = outs

        # per-instance scalars, computed in SL layout then flattened
        x_m = jnp.asarray(x_mask_np[:-1], dtype)[:, :, None, None]
        u_m = jnp.asarray(u_mask_np, dtype)[:, :, None, None]
        lx = jnp.abs(Qx_t - p_t) * x_m
        lu = jnp.abs(Qu_t) * u_m
        grad_sl = jnp.maximum(
            jnp.max(lx, axis=(0, 1)), jnp.max(lu, axis=(0, 1))
        )                                                     # [S, L]

        # Armijo slope via the closed-loop sensitivity recursion (SL scan)
        def step(zx, inp):
            fx_t, fu_t, K_tt, k_tt = inp
            # broadcast-multiply-reduce (see the AL-augmentation note)
            zu = k_tt + jnp.sum(K_tt * zx[None], axis=1)
            zx_next = (
                jnp.sum(fx_t * zx[None], axis=1)
                + jnp.sum(fu_t * zu[None], axis=1)
            )
            return zx_next, (zx, zu)

        zx0 = jnp.zeros((nx, S, 128), dtype)
        _, (zx, zu) = jax.lax.scan(
            step, zx0, (fx, fu, K_t, k_t), unroll=options.scan_unroll
        )
        slope_sl = jnp.sum((Qx_t - p_t) * zx, axis=(0, 1)) + jnp.sum(
            Qu_t * zu, axis=(0, 1)
        )

        # reg decay for the next iteration (ops/backward.py policy)
        reg_next_carry = jnp.where(
            reg_used <= options.regularization_min,
            jnp.zeros_like(reg_used),
            reg_used / options.regularization_scale,
        )

        return K_t, k_t, slope_sl, grad_sl, reg_next_carry

    def batched(xs, us, ws, duals, penalty, c, reg):
        """Batch-leading wrapper: [B, T, nx] etc in, batch-leading out.
        One small transpose per trajectory-sized array at each boundary;
        the 76MB derivative stacks never move (they are born SL inside
        ``batched_sl``)."""
        B = xs.shape[0]
        Bp = -(-B // pk.BATCH_GRAIN) * pk.BATCH_GRAIN
        S = Bp // 128

        def to_sl(a):
            if Bp != B:
                a = jnp.pad(a, [(0, Bp - B)] + [(0, 0)] * (a.ndim - 1))
            a = a.reshape((S, 128) + a.shape[1:])
            return jnp.moveaxis(a, (0, 1), (-2, -1))

        def from_sl(a):
            a = jnp.moveaxis(a, (-2, -1), (0, 1))
            return a.reshape((Bp,) + a.shape[2:])[:B]

        reg_sl = (jnp.pad(reg, (0, Bp - B)) if Bp != B else reg).reshape(
            S, 128
        )
        valid = None
        if Bp != B:
            valid = (jnp.arange(Bp) < B).reshape(S, 128)
        K_t, k_t, slope_sl, grad_sl, reg_next = batched_sl(
            to_sl(xs), to_sl(us), to_sl(ws), to_sl(duals), to_sl(penalty),
            to_sl(c), reg_sl, valid=valid,
        )
        return (
            from_sl(K_t), from_sl(k_t),
            slope_sl.reshape(Bp)[:B],
            grad_sl.reshape(Bp)[:B],
            reg_next.reshape(Bp)[:B],
        )

    return single, batched_sl, batched


def make_derive_backward_sl(spec: ProblemSpec, options):
    """SL-native derive+backward+slope for the SL batched solver
    (core/solve_sl.py).  Signature:
        (xs [T,nx,S,L], us [T-1,nu,S,L], ws [T,npar,S,L], duals [T,nc,S,L],
         penalty [T,nc,S,L], c [T,nc,S,L], reg [S,L], valid=None)
          -> (K [T-1,nu,nx,S,L], k [T-1,nu,S,L], slope [S,L],
              grad_norm [S,L], reg_next [S,L])
    """
    _, batched_sl, _ = _build(spec, options)
    return batched_sl


def make_derive_backward(spec: ProblemSpec, options, interpret: bool = False):
    """Build the custom-vmap derive+backward+slope dispatch.

    Per-instance signature:
        (xs [T,nx], us [T-1,nu], ws [T,npar], duals [T,nc], penalty [T,nc],
         c [T,nc], reg scalar)
          -> (K [T-1,nu,nx], k [T-1,nu], slope scalar, grad_norm scalar,
              reg_next scalar)

    Unbatched calls use the existing scan path.  Under vmap the batched rule
    runs the SL pipeline with the kernel where ``packed_backward.riccati_impl``
    picks it (``interpret`` runs the kernel in interpret mode), and vmaps the
    per-instance path where it picks the XLA scan.
    """
    single, _, batched = _build(spec, options, interpret)
    impl = pk.riccati_impl(spec.nx, spec.nu, jax.default_backend(), interpret)

    @jax.custom_batching.custom_vmap
    def dispatch(xs, us, ws, duals, penalty, c, reg):
        return single(xs, us, ws, duals, penalty, c, reg)

    @dispatch.def_vmap
    def _rule(axis_size, in_batched, xs, us, ws, duals, penalty, c, reg):
        if not all(in_batched[:2]):
            raise NotImplementedError("xs/us must be batched on axis 0")
        bc = lambda a, b, shape: a if b else jnp.broadcast_to(a, shape)
        B = axis_size
        ws_b = bc(ws, in_batched[2], (B,) + ws.shape[-2:])
        duals_b = bc(duals, in_batched[3], (B,) + duals.shape[-2:])
        pen_b = bc(penalty, in_batched[4], (B,) + penalty.shape[-2:])
        c_b = bc(c, in_batched[5], (B,) + c.shape[-2:])
        reg_b = reg if in_batched[6] else jnp.broadcast_to(reg, (B,))
        if impl == "xla":
            out = jax.vmap(single)(xs, us, ws_b, duals_b, pen_b, c_b, reg_b)
        else:
            out = batched(xs, us, ws_b, duals_b, pen_b, c_b, reg_b)
        return out, tuple(True for _ in out)

    return dispatch
