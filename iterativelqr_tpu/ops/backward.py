"""Backward Riccati/DDP recursion.

Batched replacements for the reference's sequential Julia loop with BLAS
``mul!`` and *unchecked* LAPACK Cholesky (reference: src/backward_pass.jl:42-90,
SURVEY.md "hard parts" #1):

* ``backward_pass_scan`` — reverse ``lax.scan``; the per-step small-matrix
  algebra fuses into one compiled loop body.  Cholesky failure (indefinite Quu)
  is detected via NaN/non-positive diagonals instead of ignored.
* ``backward_pass`` — adaptive Levenberg-style regularization wrapper: retries
  the recursion with geometrically increasing ``reg`` until Quu + reg*I is
  positive definite at every timestep.  Under ``vmap`` the retry loop masks
  per-instance, so one ill-conditioned problem in a batch cannot poison the
  rest.
* ``backward_pass_associative`` (ops/assoc.py) — O(log T)-depth parallel-prefix
  variant, selected via Options.backward_pass.

Padded action dimensions carry an identity Quu block and zero gains, so padded
and exact-dimension solves agree (property-tested in tests/test_padding.py).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..core.options import Options
from . import linalg_small


def riccati_step(P, p, fx_t, fu_t, gx_t, gu_t, gxx_t, guu_t, gux_t, um, reg,
                 f2_t=None):
    """One backward step at time t given the value function (P, p) at t+1.

    Mirrors reference src/backward_pass.jl:44-89 (Q-expansion, gains, value
    update), with padding masks and regularization added.  ``um`` is the float
    action-validity mask [nu].

    ``f2_t``: optional (fxx, fuu, fux) dynamics second derivatives at t
    (``Options.ddp``) — adds the full-DDP curvature terms
    ``Q** += sum_i Vx_i(t+1) * f2_i`` that Gauss-Newton iLQR (and the
    reference) drop.  The contraction uses the carried ``p`` (the value
    gradient at t+1), so it cannot ride the associative-scan or packed-kernel
    formulations, whose per-step elements must not depend on downstream V.
    """
    # all products via broadcast-multiply-reduce (linalg_small.matmul): a
    # dot_general per 4x4 product is a kernel of its own; this form lets
    # XLA fuse the whole step body into a handful of kernels
    mm, mv = linalg_small.matmul, linalg_small.matvec
    fxT = jnp.swapaxes(fx_t, -1, -2)
    fuT = jnp.swapaxes(fu_t, -1, -2)
    Qx = gx_t + mv(fxT, p)
    Qu = gu_t + mv(fuT, p)
    fxTP = mm(fxT, P)
    fuTP = mm(fuT, P)
    Qxx = gxx_t + mm(fxTP, fx_t)
    Quu = guu_t + mm(fuTP, fu_t)
    Qux = gux_t + mm(fuTP, fx_t)
    if f2_t is not None:
        fxx_t, fuu_t, fux_t = f2_t
        pw = p[:, None, None]
        Qxx = Qxx + jnp.sum(pw * fxx_t, axis=0)
        Quu = Quu + jnp.sum(pw * fuu_t, axis=0)
        Qux = Qux + jnp.sum(pw * fux_t, axis=0)

    # padded action dims: identity diagonal so the factorization is well posed
    # and the corresponding gain rows vanish
    mask2 = um[:, None] * um[None, :]
    Quu_eff = Quu * mask2 + jnp.diag(1.0 - um)
    if f2_t is not None:
        # DDP needs STATE regularization (Tassa et al. 2012): the curvature
        # terms make plain Quu-diagonal damping steer the gains through an
        # indefinite Qux far from the optimum (measured on acrobot T=101:
        # control-reg DDP wanders to a 5x-worse local optimum in 321
        # iterations).  Regularize through the value function for the GAIN
        # computation only — Quu~ = guu + fuT (P + reg I) fu + Vx.fuu,
        # Qux~ = gux + fuT (P + reg I) fx + Vx.fux — and keep the value
        # update on the unregularized quantities, as in the GN branch.
        fuT_reg = fuT * reg
        Quu_g = Quu_eff + mm(fuT_reg, fu_t) * mask2
        Qux_g = Qux + mm(fuT_reg, fx_t)
        # a SMALL diagonal share of reg rides along: state reg alone
        # (reg*fuT fu) is singular along null(fu), so an indefinite Vx.fuu
        # term there could never be cured and the retry loop would exhaust
        # (NaN gains).  The 1e-3 weighting keeps the damping's state-reg
        # character (equal weighting was measured to triple acrobot DDP
        # iterations and land a worse optimum) while regularization_max =
        # 1e12 still pushes 1e9 onto the diagonal in the limit, so
        # escalation provably terminates.  At reg=0 (the common converged
        # case) this is exactly the GN factorization.
        Quu_reg = Quu_g + (1.0e-3 * reg) * jnp.diag(um)
    else:
        Qux_g = Qux
        Quu_reg = Quu_eff + reg * jnp.diag(um)

    # unrolled small-matrix Cholesky/solves (ops/linalg_small.py): the stock
    # blocked factorizations dominate the whole backward pass at these tiny
    # dimensions
    L = linalg_small.cholesky(Quu_reg)
    diag = jnp.diagonal(L)
    ok = jnp.all(jnp.isfinite(diag) & (diag > 0.0))

    # K = -Quu \ Qux ; k = -Quu \ Qu  (reference: src/backward_pass.jl:66-75)
    sol = linalg_small.cho_solve(L, jnp.concatenate([Qux_g, Qu[:, None]], axis=1))
    K = -sol[:, :-1] * um[:, None]
    k = -sol[:, -1] * um

    # value update with the *unregularized* Quu, matching the reference exactly
    # when no regularization was needed (src/backward_pass.jl:77-89)
    KT = jnp.swapaxes(K, -1, -2)
    QuxT = jnp.swapaxes(Qux, -1, -2)
    QuuK = mm(Quu_eff, K)
    P_new = Qxx + mm(KT, QuuK) + mm(KT, Qux) + mm(QuxT, K)
    P_new = 0.5 * (P_new + jnp.swapaxes(P_new, -1, -2))
    p_new = Qx + mv(jnp.swapaxes(QuuK, -1, -2), k) + mv(KT, Qu) + mv(QuxT, k)
    return P_new, p_new, ok, K, k, Qx, Qu


def backward_pass_scan(fx, fu, gx, gu, gxx, guu, gux, u_mask, reg, unroll=1,
                       f2=None):
    """Reverse-scan Riccati recursion.

    Returns (K [T-1,nu,nx], k [T-1,nu], Qx [T-1,nx], Qu [T-1,nu],
    p [T-1,nx] — the value gradient *at* t, used by the Lagrangian gradient —
    and an all-timesteps PD-success flag).
    Terminal init P=gxx_T, p=gx_T (reference: src/backward_pass.jl:39-40).

    ``f2``: optional (fxx [T-1,nx,nx,nx], fuu, fux) stacks for full DDP
    (see ``riccati_step``).
    """
    dtype = gx.dtype
    um = u_mask.astype(dtype)

    def step(carry, inp):
        P, p, ok = carry
        fx_t, fu_t, gx_t, gu_t, gxx_t, guu_t, gux_t, um_t = inp[:8]
        f2_t = inp[8:] if len(inp) > 8 else None
        P_new, p_new, ok_t, K, k, Qx, Qu = riccati_step(
            P, p, fx_t, fu_t, gx_t, gu_t, gxx_t, guu_t, gux_t, um_t, reg,
            f2_t=f2_t,
        )
        return (P_new, p_new, ok & ok_t), (K, k, Qx, Qu, p_new)

    xs_in = (fx, fu, gx[:-1], gu, gxx[:-1], guu, gux, um)
    if f2 is not None:
        xs_in = xs_in + tuple(f2)
    init = (gxx[-1], gx[-1], jnp.asarray(True))
    (_, _, ok), (K, k, Qx, Qu, p) = jax.lax.scan(
        step,
        init,
        xs_in,
        reverse=True,
        unroll=unroll,
    )
    return K, k, Qx, Qu, p, ok


import functools


def _assoc_wins(B: int, T: int) -> bool:
    """(B, T) regime rule for the backward pass: the O(log T) associative
    scan wins only when the batch underfills the device — B=1 at every T,
    small batches once T is long; device-filling batches take the
    sequential scan's cheaper element composition.  The rule predates the
    GPU port and is not yet measured on the H100
    (benchmarks/horizon_bench.py re-derives it)."""
    return B <= max(1, T // 7)


@functools.lru_cache(maxsize=None)
def _make_auto_dispatch(unroll: int):
    """custom_vmap dispatcher: associative scan for unbatched (and, via the
    measured regime rule, small-batch/long-horizon) calls; reverse scan for
    chip-filling batches."""
    from .assoc import backward_pass_associative

    @jax.custom_batching.custom_vmap
    def dispatch(fx, fu, gx, gu, gxx, guu, gux, u_mask, reg):
        return backward_pass_associative(
            fx, fu, gx, gu, gxx, guu, gux, u_mask, reg
        )

    @dispatch.def_vmap
    def _rule(axis_size, in_batched, fx, fu, gx, gu, gxx, guu, gux, u_mask, reg):
        um_b = in_batched[7]
        reg_b = in_batched[8]
        um = u_mask[0] if um_b else u_mask
        reg_v = reg if reg_b else jnp.broadcast_to(reg, (axis_size,))
        # constant-coefficient stacks (e.g. linear dynamics: fx/fu carry no
        # batch dependence) arrive unbatched — map them with in_axes=None
        stacks = (fx, fu, gx, gu, gxx, guu, gux)
        axes = tuple(0 if b else None for b in in_batched[:7])
        T = (fx.shape[1] if in_batched[0] else fx.shape[0]) + 1
        if _assoc_wins(axis_size, T):
            bp = backward_pass_associative
        else:
            bp = functools.partial(backward_pass_scan, unroll=unroll)
        out = jax.vmap(
            lambda *a: bp(*a[:7], um, a[7]), in_axes=axes + (0,)
        )(*stacks, reg_v)
        return out, tuple(True for _ in out)

    return dispatch


def backward_pass(fx, fu, gx, gu, gxx, guu, gux, u_mask, reg_carry, options: Options,
                  impl=None):
    """Backward pass with adaptive Quu regularization.

    First attempt uses the carried ``reg`` (0 once the problem is locally PD,
    giving exact reference-parity gains); on failure ``reg`` is escalated
    geometrically and the recursion re-run.  On success the carried value
    decays so regularization vanishes when no longer needed.

    ``impl``: optional recursion override with the ``backward_pass_scan``
    signature/returns (sans ``unroll``) — e.g. the horizon-sharded backward
    (parallel/horizon.py) — wrapped in the same regularization retry loop.
    """
    if impl is not None:
        bp = lambda *a, unroll=None: impl(*a)
    elif options.backward_pass == "associative":
        from .assoc import backward_pass_associative as bp
    elif options.backward_pass == "auto":
        # regime selection by batchedness (measured, docs/design.md section 3):
        # single-instance solves are latency-bound on the T-step recursion ->
        # O(log T) associative scan; under vmap the batch saturates the chip
        # and the sequential scan's cheaper composition wins
        dispatch = _make_auto_dispatch(options.scan_unroll)
        bp = lambda *a, unroll=None: dispatch(*a)
    else:
        bp = backward_pass_scan

    # The recursion is traced exactly ONCE (inside the retry body; the first
    # loop iteration is the unregularized/carried-reg attempt) — trace time of
    # the jitted solve is dominated by Python tracing, not XLA compilation, so
    # every extra trace of the scan body is expensive.
    dtype = gx.dtype
    Tm1, nx, nu = fx.shape[0], fx.shape[1], u_mask.shape[1]
    zero_out = (
        jnp.zeros((Tm1, nu, nx), dtype),
        jnp.zeros((Tm1, nu), dtype),
        jnp.zeros((Tm1, nx), dtype),
        jnp.zeros((Tm1, nu), dtype),
        jnp.zeros((Tm1, nx), dtype),
    )
    state = (
        jnp.asarray(0),
        reg_carry,          # reg to try next
        reg_carry,          # reg actually used by the last attempt
        jnp.asarray(False), # last attempt ok
        zero_out,
    )

    def cond(s):
        i, _, _, ok, _ = s
        return (~ok) & (i <= options.max_regularization_steps)

    def body(s):
        i, reg, _, _, _ = s
        K, k, Qx, Qu, p, ok = bp(
            fx, fu, gx, gu, gxx, guu, gux, u_mask, reg,
            unroll=options.scan_unroll,
        )
        reg_next = jnp.maximum(reg * options.regularization_scale,
                               options.regularization_min)
        reg_next = jnp.minimum(reg_next, options.regularization_max)
        return (i + 1, reg_next, reg, ok, (K, k, Qx, Qu, p))

    _, _, reg_used, ok, (K, k, Qx, Qu, p) = jax.lax.while_loop(cond, body, state)

    # decay for the next iteration's first attempt
    reg_next_carry = jnp.where(
        reg_used <= options.regularization_min,
        jnp.zeros_like(reg_used),
        reg_used / options.regularization_scale,
    )
    return K, k, Qx, Qu, p, ok, reg_next_carry
