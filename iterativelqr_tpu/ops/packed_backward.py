"""Batched backward Riccati recursion in SL layout: a Pallas-Triton kernel
and its plain XLA reference.

Every operand is in the SL layout of the batched solver (core/solve_sl.py):
``[Tm1, *dims, S, 128]`` with the batch riding the two trailing axes.  The
recursion is a T-step sequential chain of tiny per-lane matrix algebra.
Under XLA every step is at least one kernel launch inside a while loop; the
kernel below runs the whole chain in ONE launch: each program owns a block
of ``LANE_BLOCK`` batch lanes, walks ``t = Tm1-1 .. 0`` in a loop, keeps the
value function (P, p) and the PD flag in registers, reads each step's
derivative slices straight from device memory and writes the gains.

The reference (``riccati_scan_sl``) runs ``_riccati_step`` — broadcast-
multiply-reduce over ``[*dims, S, 128]`` arrays — under ``lax.scan``.  The
kernel runs the same recursion as ``_riccati_step_lanes``, on nested Python
lists whose leaves are ``[BL]`` lane vectors: the Triton lowering has no
slicing, gathering or general concatenation of in-register tensors, and
every tensor it loads must have a power-of-two size, so the per-lane
matrices are unrolled into their entries.  Both share the unrolled
Cholesky (``_chol``, ``_chol_solve``).  There are no dot products on either
side, so both run at full f32 (no TF32); they differ only in the order of
roundings.

Reference recursion: src/backward_pass.jl:42-90.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

# Batch lanes per kernel program (a power of two).
LANE_BLOCK = 128
# The SL layout pads the batch to a multiple of this.  It is also the
# smallest batch the compaction driver re-packs to: below a few lane blocks
# per streaming multiprocessor group the card is not filled, and every
# further batch shape costs one more compiled program.
BATCH_GRAIN = 8 * LANE_BLOCK
# Largest n*n + m*n (entries of P plus K) the kernel takes; wider problems
# use the XLA scan.  The unrolled step grows as n^3: on an H100 the kernel
# compiled in 2 s at n=4, m=1 (20 entries) and had not compiled after 12
# minutes at n=12, m=4 (192 entries), so the limit is the largest width
# measured to compile.
KERNEL_MAX_ENTRIES = 20


def _mm(a, b):
    """(i,k,...lanes),(k,j,...lanes) -> (i,j,...lanes)"""
    return jnp.sum(a[:, :, None] * b[None, :, :], axis=1)


def _mv(a, v):
    """(i,k,...lanes),(k,...lanes) -> (i,...lanes)"""
    return jnp.sum(a * v[None], axis=1)


def _t(a):
    return jnp.swapaxes(a, 0, 1)


def _chol(A, m):
    """Unrolled Cholesky factor (lists of lane entries) of ``A``, indexable
    as ``A[i][j]`` (an array or nested lists)."""
    L = [[None] * m for _ in range(m)]
    for i in range(m):
        for j in range(i + 1):
            s = A[i][j]
            for kk in range(j):
                s = s - L[i][kk] * L[j][kk]
            L[i][j] = jnp.sqrt(s) if i == j else s / L[j][j]
    return L


def _chol_solve(L, col, m):
    """Solve (L L^T) x = col by unrolled substitution; lists of entries."""
    y = [None] * m
    for i in range(m):
        s = col[i]
        for kk in range(i):
            s = s - L[i][kk] * y[kk]
        y[i] = s / L[i][i]
    x = [None] * m
    for i in range(m - 1, -1, -1):
        s = y[i]
        for kk in range(i + 1, m):
            s = s - L[kk][i] * x[kk]
        x[i] = s / L[i][i]
    return x


def _riccati_step(n, m, reg, P, p, ok, fx, fu, gx, gu, gxx, guu, gux):
    """The reference's backward step on arrays ``[*dims, ...lanes]``;
    returns (K, kff, Qx, Qu, P_new, p_new, ok)."""
    fxT = _t(fx)
    fuT = _t(fu)
    Qx = gx + _mv(fxT, p)
    Qu = gu + _mv(fuT, p)
    fxTP = _mm(fxT, P)
    fuTP = _mm(fuT, P)
    Qxx = gxx + _mm(fxTP, fx)
    Quu = guu + _mm(fuTP, fu)
    Qux = gux + _mm(fuTP, fx)

    Lf = _chol(
        [[Quu[a, b] + (reg if a == b else 0.0) for b in range(m)]
         for a in range(m)], m
    )
    for a in range(m):
        d = Lf[a][a]
        ok = ok * (jnp.isfinite(d) & (d > 0.0)).astype(ok.dtype)

    sols = [_chol_solve(Lf, Qux[:, jj], m) for jj in range(n)]
    K = -jnp.stack([jnp.stack(x, axis=0) for x in sols], axis=1)
    kff = -jnp.stack(_chol_solve(Lf, Qu, m), axis=0)

    KT = _t(K)
    QuxT = _t(Qux)
    QuuK = _mm(Quu, K)
    P_new = Qxx + _mm(KT, QuuK) + _mm(KT, Qux) + _mm(QuxT, K)
    P_new = 0.5 * (P_new + _t(P_new))
    p_new = Qx + _mv(_t(QuuK), kff) + _mv(KT, Qu) + _mv(QuxT, kff)
    return K, kff, Qx, Qu, P_new, p_new, ok


def _riccati_step_lanes(n, m, reg, P, p, ok, fx, fu, gx, gu, gxx, guu, gux):
    """The kernel's backward step, on lists of lane vectors.

    ``P`` [n][n], ``p`` [n], ``fx`` [n][n], ``fu`` [n][m], ``gx`` [n],
    ``gu`` [m], ``gxx`` [n][n], ``guu`` [m][m], ``gux`` [m][n]; ``reg`` and
    ``ok`` are lane vectors.  Returns (K [m][n], kff [m], Qx [n], Qu [m],
    P_new [n][n], p_new [n], ok)."""
    rn, rm = range(n), range(m)

    def dot(a, b):
        return functools.reduce(
            lambda s, t: s + t, (x * y for x, y in zip(a, b))
        )

    fxT = [[fx[k][i] for k in rn] for i in rn]
    fuT = [[fu[k][a] for k in rn] for a in rm]
    Qx = [gx[i] + dot(fxT[i], p) for i in rn]
    Qu = [gu[a] + dot(fuT[a], p) for a in rm]
    Pc = [[P[k][j] for k in rn] for j in rn]           # columns of P
    fxTP = [[dot(fxT[i], Pc[j]) for j in rn] for i in rn]
    fuTP = [[dot(fuT[a], Pc[j]) for j in rn] for a in rm]
    fxc = [[fx[k][j] for k in rn] for j in rn]         # columns of fx
    fuc = [[fu[k][b] for k in rn] for b in rm]
    Qxx = [[gxx[i][j] + dot(fxTP[i], fxc[j]) for j in rn] for i in rn]
    Quu = [[guu[a][b] + dot(fuTP[a], fuc[b]) for b in rm] for a in rm]
    Qux = [[gux[a][j] + dot(fuTP[a], fxc[j]) for j in rn] for a in rm]

    L = _chol([[Quu[i][j] + (reg if i == j else 0.0) for j in rm]
               for i in rm], m)
    for a in rm:
        d = L[a][a]
        ok = jnp.where(jnp.isfinite(d) & (d > 0.0), ok, jnp.zeros_like(ok))
    solve = lambda col: _chol_solve(L, col, m)

    Kc = [solve([Qux[a][j] for a in rm]) for j in rn]  # columns of -K
    K = [[-Kc[j][a] for j in rn] for a in rm]
    kff = [-v for v in solve(Qu)]

    Kcol = [[K[a][j] for a in rm] for j in rn]
    Quxc = [[Qux[a][j] for a in rm] for j in rn]
    QuuK = [[dot(Quu[a], [K[b][j] for b in rm]) for j in rn] for a in rm]
    QuuKc = [[QuuK[a][j] for a in rm] for j in rn]
    Pn = [
        [
            Qxx[i][j] + dot(Kcol[i], QuuKc[j]) + dot(Kcol[i], Quxc[j])
            + dot(Quxc[i], Kcol[j])
            for j in rn
        ]
        for i in rn
    ]
    P_new = [[0.5 * (Pn[i][j] + Pn[j][i]) for j in rn] for i in rn]
    p_new = [
        Qx[i] + dot(QuuKc[i], kff) + dot(Kcol[i], Qu) + dot(Quxc[i], kff)
        for i in rn
    ]
    return K, kff, Qx, Qu, P_new, p_new, ok


def kernel_fits(n: int, m: int) -> bool:
    """Whether problem widths (n states, m controls) fit the kernel."""
    return n * n + m * n <= KERNEL_MAX_ENTRIES


def riccati_impl(n: int, m: int, platform: str, interpret: bool = False) -> str:
    """The recursion the SL solver runs: ``"triton"`` (the kernel, compiled
    for the card), ``"interpret"`` (the kernel in interpret mode, on
    explicit request) or ``"xla"`` (the lax.scan reference)."""
    if interpret:
        return "interpret"
    if platform == "gpu" and kernel_fits(n, m):
        return "triton"
    return "xla"


def fixup_guu(guu, u_mask):
    """Unit diagonal on the invalid (padded) action dims of ``guu``
    [Tm1, m, m, S, L]: their derivative rows and columns are exactly zero
    by construction (core/spec.py), so the factorization stays PD and their
    gains stay 0."""
    m = guu.shape[1]
    um = u_mask.astype(guu.dtype)                               # [Tm1, m]
    eye = jnp.eye(m, dtype=guu.dtype)[None] * (1.0 - um)[:, None, :]
    return guu + eye[..., None, None]


def riccati_scan_sl(stacks, gxxT, gxT, reg_sl, unroll: int = 1):
    """The plain reference: ``_riccati_step`` under a reverse ``lax.scan``
    (XLA only).

    ``stacks`` = (fx, fu, gx, gu, gxx, guu, gux), each [Tm1, *dims, S, L];
    ``gxxT`` [n, n, S, L], ``gxT`` [n, S, L], ``reg_sl`` [S, L].  Returns
    (K [Tm1, m, n, S, L], k [Tm1, m, S, L], Qx [Tm1, n, S, L],
    Qu [Tm1, m, S, L], p [Tm1, n, S, L], ok [S, L] in the stacks' dtype)."""
    fx = stacks[0]
    n, m = fx.shape[1], stacks[1].shape[2]
    dtype = fx.dtype
    reg = reg_sl.astype(dtype)

    def step(carry, inp):
        P, p, ok = carry
        K, kff, Qx, Qu, P, p, ok = _riccati_step(n, m, reg, P, p, ok, *inp)
        return (P, p, ok), (K, kff, Qx, Qu, p)

    ok0 = jnp.ones(reg.shape, dtype)
    (_, _, ok), (K, k, Qx, Qu, p) = jax.lax.scan(
        step, (gxxT, gxT, ok0), stacks, reverse=True, unroll=unroll
    )
    return K, k, Qx, Qu, p, ok


def _kernel(n, m, Tm1, lanes, bl,
            fx_ref, fu_ref, gx_ref, gu_ref, gxx_ref, guu_ref, gux_ref,
            gxxT_ref, gxT_ref, reg_ref,
            K_ref, k_ref, Qx_ref, Qu_ref, p_ref, ok_ref):
    """One program: ``bl`` lanes starting at ``program_id * bl``; operands
    are flattened to [Tm1, entries, lanes]."""
    l0 = pl.program_id(0) * bl
    idx = pl.ds(l0, bl)
    mask = l0 + jnp.arange(bl, dtype=jnp.int32) < lanes

    def at(ref, i):
        # one index type (int32, like program_id) for the interpreter under x64
        return ref.at[tuple(jnp.int32(x) for x in i) + (idx,)]

    def ld(ref, *i):
        return plgpu.load(at(ref, i), mask=mask, other=0.0)

    def st(ref, v, *i):
        plgpu.store(at(ref, i), v, mask=mask)

    def mat(ref, t, r, c):
        return [[ld(ref, t, i * c + j) for j in range(c)] for i in range(r)]

    def vec(ref, t, r):
        return [ld(ref, t, i) for i in range(r)]

    reg = ld(reg_ref)
    P0 = [[ld(gxxT_ref, i * n + j) for j in range(n)] for i in range(n)]
    p0 = [ld(gxT_ref, i) for i in range(n)]
    ok0 = jnp.ones_like(reg)

    def body(it, carry):
        P, p, ok = carry
        t = Tm1 - 1 - it
        K, kff, Qx, Qu, P, p, ok = _riccati_step_lanes(
            n, m, reg, P, p, ok,
            mat(fx_ref, t, n, n), mat(fu_ref, t, n, m), vec(gx_ref, t, n),
            vec(gu_ref, t, m), mat(gxx_ref, t, n, n), mat(guu_ref, t, m, m),
            mat(gux_ref, t, m, n),
        )
        for a in range(m):
            for j in range(n):
                st(K_ref, K[a][j], t, a * n + j)
            st(k_ref, kff[a], t, a)
            st(Qu_ref, Qu[a], t, a)
        for i in range(n):
            st(Qx_ref, Qx[i], t, i)
            st(p_ref, p[i], t, i)
        return P, p, ok

    _, _, ok = jax.lax.fori_loop(
        jnp.int32(0), jnp.int32(Tm1), body, (P0, p0, ok0)
    )
    st(ok_ref, ok)


def riccati_triton(stacks, gxxT, gxT, reg_sl, *, interpret: bool = False,
                   lane_block: int = LANE_BLOCK, num_warps: int = 4):
    """The recursion as one Pallas-Triton kernel; same contract as
    ``riccati_scan_sl``.  The lane count need not be a multiple of
    ``lane_block``: the last program masks its loads and stores."""
    fx = stacks[0]
    Tm1, n, m = fx.shape[0], fx.shape[1], stacks[1].shape[2]
    lane_shape = fx.shape[-2:]
    lanes = lane_shape[0] * lane_shape[1]
    dtype = fx.dtype
    flat = lambda a: a.reshape((Tm1, -1, lanes))
    ins = [flat(a) for a in stacks] + [
        gxxT.reshape(n * n, lanes), gxT.reshape(n, lanes),
        reg_sl.astype(dtype).reshape(lanes),
    ]
    out_shape = [
        jax.ShapeDtypeStruct((Tm1, m * n, lanes), dtype),
        jax.ShapeDtypeStruct((Tm1, m, lanes), dtype),
        jax.ShapeDtypeStruct((Tm1, n, lanes), dtype),
        jax.ShapeDtypeStruct((Tm1, m, lanes), dtype),
        jax.ShapeDtypeStruct((Tm1, n, lanes), dtype),
        jax.ShapeDtypeStruct((lanes,), dtype),
    ]
    K, k, Qx, Qu, p, ok = pl.pallas_call(
        functools.partial(_kernel, n, m, Tm1, lanes, lane_block),
        out_shape=out_shape,
        grid=(pl.cdiv(lanes, lane_block),),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=num_warps,
                                             num_stages=1),
        interpret=interpret,
        name="riccati_sl",
    )(*ins)
    sl = lambda a, *d: a.reshape((Tm1,) + d + lane_shape)
    return (sl(K, m, n), sl(k, m), sl(Qx, n), sl(Qu, m), sl(p, n),
            ok.reshape(lane_shape))


def backward_pass_sl(stacks, gxxT, gxT, reg_sl, u_mask, *, impl: str,
                     unroll: int = 1):
    """Dispatch one recursion sweep to ``impl`` (see ``riccati_impl``)
    after the padded-action fixup of ``guu``."""
    fx, fu, gx, gu, gxx, guu, gux = stacks
    stacks = (fx, fu, gx, gu, gxx, fixup_guu(guu, u_mask), gux)
    if impl == "xla":
        return riccati_scan_sl(stacks, gxxT, gxT, reg_sl, unroll=unroll)
    return riccati_triton(stacks, gxxT, gxT, reg_sl,
                          interpret=impl == "interpret")
