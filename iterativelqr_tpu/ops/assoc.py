"""Parallel-prefix (associative-scan) Riccati recursion.

O(log T)-depth replacement for the sequential backward recursion (reference:
src/backward_pass.jl:42-90 is a strict t = H-1..1 for-loop; SURVEY.md
section 5 "long-context" row).  Based on the temporal-parallelization of LQT
dynamic programming (PAPERS.md: "The Parallelization of Riccati Recursion"):
the conditional value function between two timesteps is closed under
composition, so the whole backward sweep is one ``jax.lax.associative_scan``.

Each stage element encodes, after completing the square in the action,

    V_{t, t+1}(x, z) = 1/2 (z - A x - b)' C^+ (z - A x - b)
                       + 1/2 x' J x - eta' x  (+ const)

with
    A   = fx - fu Guu^{-1} Gux          b  = -fu Guu^{-1} gu
    C   = fu Guu^{-1} fu'               J  = Gxx - Gux' Guu^{-1} Gux
    eta = -(gx - Gux' Guu^{-1} gu)

(Guu/Gxx/Gux are the *stage* Hessians; the iLQR delta-form has no affine
dynamics residual because the nominal trajectory is dynamically feasible.)
The terminal element is (A=0, b=0, C=0, J=gxx_T, eta=-gx_T).  Composition of a
temporally earlier element ``i`` with a later element ``j``:

    D     = (I + C_i J_j)^{-1}
    A_ij  = A_j D A_i
    b_ij  = A_j D (b_i + C_i eta... ) ...  (see ``_combine``)

After the reverse scan, element t holds the value function at x_t:
P_t = J, p_t = -eta.  Gains then come from one *batched* (vmapped) Q-expansion
over all timesteps — no sequential dependence anywhere.

Numerical regime: composition requires stage Guu (plus reg) to be positive
definite, a slightly stronger condition than the sequential path's Quu
PD-check; both paths share the same adaptive-regularization wrapper
(ops/backward.py), so indefinite stages escalate ``reg`` identically.
Validated against the sequential scan in tests/test_assoc.py.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from . import linalg_small


def _combine(ei, ej):
    """Compose value-function elements: ``ei`` earlier in time than ``ej``."""
    Ai, bi, Ci, etai, Ji = ei
    Aj, bj, Cj, etaj, Jj = ej
    nx = Ai.shape[-1]
    I = jnp.eye(nx, dtype=Ai.dtype)
    # D = (I + C_i J_j)^{-1}; solve once, reuse transposed identity
    # (I + J_j C_i)^{-1} = D'-conjugate via transpose of the same LU
    # one unrolled Gaussian solve per operator (ops/linalg_small.py) — the
    # batched LAPACK-style LU was far slower than the whole sequential scan
    # where measured.  M = I + C_i J_j is well conditioned (C, J PSD => Re(eig) >= 1).
    mm, mv = linalg_small.matmul, linalg_small.matvec
    M = I + mm(Ci, Jj)
    rhs = jnp.concatenate([Ai, (bi + mv(Ci, etaj))[:, None], Ci], axis=1)
    sol = linalg_small.solve(M, rhs)
    D_Ai, D_bCe, D_Ci = sol[:, :nx], sol[:, nx], sol[:, nx + 1 :]
    A = mm(Aj, D_Ai)
    b = mv(Aj, D_bCe) + bj
    C = mm(mm(Aj, D_Ci), Aj.T) + Cj
    C = 0.5 * (C + C.T)
    # (I + J_j C_i)^{-1} v  =  solve(M', v) since M' = I + J_j' C_i' = I + Jj Ci
    # for symmetric Jj, Ci
    rhsT = jnp.concatenate([(etaj - mv(Jj, bi))[:, None], mm(Jj, Ai)], axis=1)
    solT = linalg_small.solve(M.T, rhsT)
    eta = mv(Ai.T, solT[:, 0]) + etai
    J = mm(Ai.T, solT[:, 1:]) + Ji
    J = 0.5 * (J + J.T)
    return A, b, C, eta, J


def _make_element(fx_t, fu_t, gx_t, gu_t, gxx_t, guu_t, gux_t, um_t, reg):
    """One stage's value-function element (module docstring); vmap over t."""
    mask2 = um_t[:, None] * um_t[None, :]
    Guu = guu_t * mask2 + jnp.diag(1.0 - um_t) + reg * jnp.diag(um_t)
    L = linalg_small.cholesky(Guu)
    diag = jnp.diagonal(L)
    ok_t = jnp.all(jnp.isfinite(diag) & (diag > 0.0))
    sol = linalg_small.cho_solve(
        L, jnp.concatenate([gux_t, gu_t[:, None], fu_t.T], axis=1)
    )
    Gi_Gux = sol[:, : gux_t.shape[1]]                        # Guu^{-1} Gux
    Gi_gu = sol[:, gux_t.shape[1]]
    Gi_fuT = sol[:, gux_t.shape[1] + 1 :]                    # Guu^{-1} fu'
    A = fx_t - fu_t @ Gi_Gux
    b = -fu_t @ Gi_gu
    C = fu_t @ Gi_fuT
    C = 0.5 * (C + C.T)
    J = gxx_t - gux_t.T @ Gi_Gux
    J = 0.5 * (J + J.T)
    eta = -(gx_t - gux_t.T @ Gi_gu)
    return (A, b, C, eta, J), ok_t


def _gains(fx_t, fu_t, gx_t, gu_t, gxx_t, guu_t, gux_t, um_t, P1, p1, reg):
    """Feedback/feedforward gains from the value function at t+1; vmap
    over t (no sequential dependence)."""
    fuT = fu_t.T
    Qx = gx_t + fx_t.T @ p1
    Qu = gu_t + fuT @ p1
    fuTP = fuT @ P1
    Quu = guu_t + fuTP @ fu_t
    Qux = gux_t + fuTP @ fx_t
    mask2 = um_t[:, None] * um_t[None, :]
    Quu_eff = Quu * mask2 + jnp.diag(1.0 - um_t)
    L = linalg_small.cholesky(Quu_eff + reg * jnp.diag(um_t))
    diag = jnp.diagonal(L)
    ok_t = jnp.all(jnp.isfinite(diag) & (diag > 0.0))
    sol = linalg_small.cho_solve(L, jnp.concatenate([Qux, Qu[:, None]], axis=1))
    K = -sol[:, :-1] * um_t[:, None]
    k = -sol[:, -1] * um_t
    return K, k, Qx, Qu, ok_t


def identity_element(nx, dtype):
    """The combine operator's identity: composing it on either side leaves
    the other element unchanged (A=I, b=0, C=0, eta=0, J=0).  Used to pad
    the time axis for even device sharding (parallel/horizon.py)."""
    return (
        jnp.eye(nx, dtype=dtype),
        jnp.zeros((nx,), dtype),
        jnp.zeros((nx, nx), dtype),
        jnp.zeros((nx,), dtype),
        jnp.zeros((nx, nx), dtype),
    )


def backward_pass_associative(fx, fu, gx, gu, gxx, guu, gux, u_mask, reg, unroll=1):
    """Associative-scan Riccati; same signature/returns as backward_pass_scan.

    Returns (K [T-1,nu,nx], k [T-1,nu], Qx [T-1,nx], Qu [T-1,nu], p [T-1,nx],
    ok) — ``p`` is the value gradient at t, matching ops/backward.py.
    """
    dtype = gx.dtype
    Tm1, nx = fx.shape[0], fx.shape[1]
    um = u_mask.astype(dtype)

    stage_elems, ok_stage = jax.vmap(
        lambda *a: _make_element(*a, reg)
    )(fx, fu, gx[:-1], gu, gxx[:-1], guu, gux, um)

    # append the terminal element
    zA = jnp.zeros((1, nx, nx), dtype)
    term = (
        zA,
        jnp.zeros((1, nx), dtype),
        zA,
        -gx[-1][None],
        gxx[-1][None],
    )
    elems = jax.tree.map(
        lambda s, t: jnp.concatenate([s, t], axis=0), stage_elems, term
    )

    # reverse prefix: result[t] = e_t (x) e_{t+1} (x) ... (x) e_{T-1}.
    # Under reverse=True the scan is a forward scan over flipped inputs, so the
    # operator's first argument is the temporally *later* accumulation — swap
    # into _combine's (earlier, later) convention.
    res = jax.lax.associative_scan(
        jax.vmap(lambda a, b: _combine(b, a)), elems, reverse=True, axis=0
    )
    _, _, _, eta_all, J_all = res
    P = J_all   # [T, nx, nx]; value Hessian at each t
    p = -eta_all  # [T, nx];    value gradient at each t

    # gains from the value function at t+1: one batched Q-expansion
    K, k, Qx, Qu, ok_gain = jax.vmap(
        lambda *a: _gains(*a, reg)
    )(fx, fu, gx[:-1], gu, gxx[:-1], guu, gux, um, P[1:], p[1:])
    ok = jnp.all(ok_stage) & jnp.all(ok_gain) & jnp.all(jnp.isfinite(p))
    return K, k, Qx, Qu, p[:-1], ok
