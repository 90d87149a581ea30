"""Horizon-stacked evaluation and differentiation of stage functions.

The reference compiles symbolic in-place derivative kernels and loops over the
horizon serially (reference: src/costs.jl:57-84, src/dynamics.jl:41-50,
src/constraints.jl:75-87).  Here each family is evaluated for the whole horizon
at once with ``jax.vmap`` over t; distinct per-timestep stage types are handled
by *static index grouping* — each unique function is vmapped over its own
(statically known) set of timesteps and results are scattered back — so XLA
sees only dense batched computation, no per-step dispatch.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..core.spec import ProblemSpec


def _grouped(fns, groups, rows, args):
    """vmap each fns[g] over its timestep group; scatter into [rows, ...] arrays.

    ``args`` are arrays with leading dim ``rows``; group indices are static
    numpy arrays, so the gathers/scatters lower to static slices.
    """
    if len(fns) == 1:
        return jax.vmap(fns[0])(*args)
    outs = None
    for fn, idx in zip(fns, groups):
        sub = tuple(a[idx] for a in args)
        res = jax.vmap(fn)(*sub)
        if outs is None:
            outs = jax.tree.map(
                lambda r: jnp.zeros((rows,) + r.shape[1:], r.dtype), res
            )
        outs = jax.tree.map(lambda o, r, i=idx: o.at[i].set(r), outs, res)
    return outs


def _us_full(spec: ProblemSpec, us, dtype):
    """Actions padded with a terminal zero row: cost/constraint stacks evaluate
    all T timesteps uniformly; terminal stage functions see u = 0 (their true
    action dim is 0, matching the reference's terminal Cost(.., num_action=0))."""
    return jnp.concatenate([us, jnp.zeros((1, spec.nu), dtype)], axis=0)


def stage_costs(spec: ProblemSpec, xs, us, ws):
    """Per-timestep cost values, [T] (reference: src/costs.jl:48-55 sums these)."""
    uf = _us_full(spec, us, xs.dtype)
    return _grouped(spec.cost_eval, spec.cost_groups, spec.T, (xs, uf, ws))


def total_cost(spec: ProblemSpec, xs, us, ws):
    return jnp.sum(stage_costs(spec, xs, us, ws))


def cost_gradients(spec: ProblemSpec, xs, us, ws):
    """gx [T,nx], gu [T-1,nu] (reference: src/costs.jl:57-68)."""
    uf = _us_full(spec, us, xs.dtype)
    gx, gu = _grouped(spec.cost_grad, spec.cost_groups, spec.T, (xs, uf, ws))
    return gx, gu[:-1]


def cost_hessians(spec: ProblemSpec, xs, us, ws):
    """gxx [T,nx,nx], guu [T-1,nu,nu], gux [T-1,nu,nx].

    Computed fresh every call — the reference accumulates Hessians across inner
    iterations via ``.+=`` with a single reset per solve (src/costs.jl:70-84 +
    src/solve.jl:10), an unintended-damping quirk deliberately not replicated
    (SURVEY.md "quirks").
    """
    uf = _us_full(spec, us, xs.dtype)
    gxx, guu, gux = _grouped(spec.cost_hess, spec.cost_groups, spec.T, (xs, uf, ws))
    return gxx, guu[:-1], gux[:-1]


def dynamics_values(spec: ProblemSpec, xs, us, ws):
    """f_t(x_t, u_t, w_t) for all t, [T-1, nx] (horizon-stacked evaluation)."""
    return _grouped(
        spec.dyn_eval, spec.dyn_groups, spec.T - 1, (xs[:-1], us, ws[:-1])
    )


def dynamics_jacobians(spec: ProblemSpec, xs, us, ws):
    """fx [T-1,nx,nx], fu [T-1,nx,nu] (reference: src/dynamics.jl:41-50)."""
    return _grouped(
        spec.dyn_jac, spec.dyn_groups, spec.T - 1, (xs[:-1], us, ws[:-1])
    )


def dynamics_hessians(spec: ProblemSpec, xs, us, ws):
    """Second derivatives of the dynamics, for full DDP (``Options.ddp``).

    Returns (fxx [T-1,nx,nx,nx], fuu [T-1,nx,nu,nu], fux [T-1,nx,nu,nx])
    with fxx[t,i,a,b] = d2 f_i/dx_a dx_b etc. (core/spec.py::hess_fn
    conventions).  The reference computes first derivatives only — its
    backward pass is Gauss-Newton iLQR (src/backward_pass.jl:42-90); these
    tensors feed the optional DDP terms in ops/backward.py.
    """
    return _grouped(
        spec.dyn_hess, spec.dyn_groups, spec.T - 1, (xs[:-1], us, ws[:-1])
    )


def stage_derivatives(spec: ProblemSpec, xs, us, ws):
    """All cost/dynamics derivative stacks in ONE fused pass.

    Computing dynamics Jacobians, cost gradients, and cost Hessians as
    separate vmapped passes issues 3+ kernels that each re-read the
    trajectory from device memory; evaluating one combined per-timestep
    function lets XLA fuse them (bitwise-identical results).  Stage types are grouped by the combined
    (dynamics, cost) type key; the terminal cost is evaluated separately.

    NOTE: not used by the solver — an isolated win on the first target
    hardware, it regressed the full solve there (layout interactions with
    the surrounding program; see core/solve.py::derive).  Kept as the starting point for a layout-aware
    derive + packed pallas backward (v2) pipeline.

    Returns (fx [T-1], fu [T-1], gx [T], gu [T-1], gxx [T], guu [T-1],
    gux [T-1]).
    """
    Tm1 = spec.T - 1
    dtype = xs.dtype
    comb = spec.dyn_tidx * len(spec.cost_eval) + spec.cost_tidx[:Tm1]
    uniq = np.unique(comb)

    def make_per_t(di, gi):
        dj = spec.dyn_jac[di]
        cg = spec.cost_grad[gi]
        ch = spec.cost_hess[gi]

        def per_t(x, u, w):
            fx, fu = dj(x, u, w)
            gx, gu = cg(x, u, w)
            gxx, guu, gux = ch(x, u, w)
            return fx, fu, gx, gu, gxx, guu, gux

        return per_t

    if len(uniq) == 1:
        di, gi = divmod(int(uniq[0]), len(spec.cost_eval))
        outs = jax.vmap(make_per_t(di, gi))(xs[:-1], us, ws[:-1])
        fx, fu, gx_s, gu, gxx_s, guu, gux = outs
    else:
        outs = None
        for key in uniq:
            di, gi = divmod(int(key), len(spec.cost_eval))
            idx = np.nonzero(comb == key)[0]
            res = jax.vmap(make_per_t(di, gi))(xs[idx], us[idx], ws[idx])
            if outs is None:
                outs = jax.tree.map(
                    lambda r: jnp.zeros((Tm1,) + r.shape[1:], r.dtype), res
                )
            outs = jax.tree.map(lambda o, r, i=idx: o.at[i].set(r), outs, res)
        fx, fu, gx_s, gu, gxx_s, guu, gux = outs

    # terminal stage: u = 0 (terminal cost has num_action == 0)
    gT = spec.cost_tidx[-1]
    u0 = jnp.zeros((spec.nu,), dtype)
    gxT, _ = spec.cost_grad[gT](xs[-1], u0, ws[-1])
    gxxT, _, _ = spec.cost_hess[gT](xs[-1], u0, ws[-1])
    gx = jnp.concatenate([gx_s, gxT[None]], axis=0)
    gxx = jnp.concatenate([gxx_s, gxxT[None]], axis=0)
    return fx, fu, gx, gu, gxx, guu, gux


def constraint_values(spec: ProblemSpec, xs, us, ws):
    """c [T,nc]; padded rows are exactly zero (reference: src/constraints.jl:66-73)."""
    if spec.nc == 0:
        return jnp.zeros((spec.T, 0), xs.dtype)
    uf = _us_full(spec, us, xs.dtype)
    return _grouped(spec.con_eval, spec.con_groups, spec.T, (xs, uf, ws))


def constraint_jacobians(spec: ProblemSpec, xs, us, ws):
    """cx [T,nc,nx], cu [T-1,nc,nu] (reference: src/constraints.jl:75-87; the
    terminal constraint has no action Jacobian, src/data/constraints.jl:14)."""
    if spec.nc == 0:
        return (
            jnp.zeros((spec.T, 0, spec.nx), xs.dtype),
            jnp.zeros((spec.T - 1, 0, spec.nu), xs.dtype),
        )
    uf = _us_full(spec, us, xs.dtype)
    cx, cu = _grouped(spec.con_jac, spec.con_groups, spec.T, (xs, uf, ws))
    return cx, cu[:-1]
