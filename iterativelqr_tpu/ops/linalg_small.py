"""Unrolled small-matrix linear algebra for the Riccati hot loop.

``jax.numpy.linalg.cholesky`` / ``cho_solve`` / ``solve`` lower to blocked
algorithms (library calls / internal while-loops) built for large matrices,
not for the tiny per-timestep matrices of trajectory optimization, where
they dominated the batched backward pass.  State/action dimensions here are
single digits, so every factorization unrolls into a static sequence of
elementwise multiply-adds that vectorize over the batch — no pivoting, no
loops, no library calls.

All functions take ``[..., m, m]`` / ``[..., m, k]`` arrays and unroll over
the *static* trailing dims; above ``_UNROLL_MAX`` they fall back to the
stock implementations (correct everywhere, fast where it matters).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

_UNROLL_MAX = 12


def matmul(a, b):
    """Small-matrix product as broadcast-multiply-reduce.

    ``dot_general`` on [..., m, m] tiles lowers to one kernel per product
    (the Riccati step body has ~10 of them).  A broadcasted multiply + sum is plain
    elementwise/reduce work that XLA fuses across the whole step body.  Only
    for small static dims; the [..., m, k, n] intermediate fuses away.
    """
    m, k = a.shape[-2], a.shape[-1]
    n = b.shape[-1]
    if k > _UNROLL_MAX or m * k * n > 1024:
        return a @ b
    return jnp.sum(a[..., :, :, None] * b[..., None, :, :], axis=-2)


def matvec(a, v):
    """[..., m, k] @ [..., k] -> [..., m] via broadcast-multiply-reduce."""
    if a.shape[-1] > _UNROLL_MAX * 2:
        return jnp.einsum("...mk,...k->...m", a, v)
    return jnp.sum(a * v[..., None, :], axis=-1)


def cholesky(A):
    """Lower-triangular Cholesky factor of PSD ``A`` [..., m, m].

    Returns NaN entries (like ``jnp.linalg.cholesky``) when a pivot is
    non-positive, which the callers' PD checks detect.
    """
    m = A.shape[-1]
    if m > _UNROLL_MAX:
        return jnp.linalg.cholesky(A)
    L = [[None] * m for _ in range(m)]
    for i in range(m):
        for j in range(i + 1):
            s = A[..., i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            if i == j:
                # sqrt of a negative pivot -> NaN, matching lapack semantics
                L[i][j] = jnp.sqrt(s)
            else:
                L[i][j] = s / L[j][j]
    rows = [
        jnp.stack(
            [L[i][j] if j <= i else jnp.zeros_like(A[..., 0, 0]) for j in range(m)],
            axis=-1,
        )
        for i in range(m)
    ]
    return jnp.stack(rows, axis=-2)


def cho_solve(L, B):
    """Solve A X = B given the Cholesky factor ``L`` of A; B is [..., m, k]."""
    m = L.shape[-1]
    if m > _UNROLL_MAX:
        return jax.scipy.linalg.cho_solve((L, True), B)
    # forward substitution: L Y = B
    Y = [None] * m
    for i in range(m):
        s = B[..., i, :]
        for k in range(i):
            s = s - L[..., i, k][..., None] * Y[k]
        Y[i] = s / L[..., i, i][..., None]
    # back substitution: L^T X = Y
    X = [None] * m
    for i in range(m - 1, -1, -1):
        s = Y[i]
        for k in range(i + 1, m):
            s = s - L[..., k, i][..., None] * X[k]
        X[i] = s / L[..., i, i][..., None]
    return jnp.stack(X, axis=-2)


def solve(M, B):
    """General solve M X = B for small square M [..., m, m] via unrolled
    Gaussian elimination without pivoting.

    Valid for the well-conditioned diagonally-dominant systems of the
    associative Riccati composition (M = I + C J with C, J PSD has eigenvalues
    with real part >= 1); falls back to ``jnp.linalg.solve`` above the unroll
    limit.
    """
    m = M.shape[-1]
    if m > _UNROLL_MAX:
        return jnp.linalg.solve(M, B)
    # build augmented rows as lists of [..., k] columns
    A = [[M[..., i, j] for j in range(m)] for i in range(m)]
    R = [B[..., i, :] for i in range(m)]
    # forward elimination
    for p in range(m):
        inv = 1.0 / A[p][p]
        for i in range(p + 1, m):
            f = A[i][p] * inv
            for j in range(p + 1, m):
                A[i][j] = A[i][j] - f * A[p][j]
            R[i] = R[i] - f[..., None] * R[p]
    # back substitution
    X = [None] * m
    for i in range(m - 1, -1, -1):
        s = R[i]
        for j in range(i + 1, m):
            s = s - A[i][j][..., None] * X[j]
        X[i] = s / A[i][i][..., None]
    return jnp.stack(X, axis=-2)
