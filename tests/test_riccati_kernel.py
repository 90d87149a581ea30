"""The SL backward recursion (ops/packed_backward.py): the Pallas-Triton
kernel in interpret mode against the XLA scan reference, the reference
against the per-instance ``backward_pass_scan``, and the wrapper's choice of
recursion.

The kernel and the reference share ``_riccati_step``; the per-instance
``backward_pass_scan`` is independent code (ops/backward.py), which pins the
shared step algebra itself.  The kernel compiled for the card is compared
with the reference at real widths by ``chip_smoke.py``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from iterativelqr_tpu.ops import packed_backward as pk
from iterativelqr_tpu.ops.backward import backward_pass_scan

_NAMES = ("K", "k", "Qx", "Qu", "p")


def _stacks(n, m, B, Tm1, dtype, seed=0):
    """Batch-leading random derivative stacks with a PD cost Hessian."""
    ks = jax.random.split(jax.random.PRNGKey(seed), 7)
    fx = 0.2 * jax.random.normal(ks[0], (B, Tm1, n, n), dtype) + jnp.eye(
        n, dtype=dtype
    )
    fu = jax.random.normal(ks[1], (B, Tm1, n, m), dtype)
    gx = jax.random.normal(ks[2], (B, Tm1 + 1, n), dtype)
    gu = jax.random.normal(ks[3], (B, Tm1, m), dtype)

    def spd(k, rows, d):
        A = jax.random.normal(k, (B, rows, d, d), dtype)
        return (A @ jnp.swapaxes(A, -1, -2)) / d + 2.0 * jnp.eye(d, dtype=dtype)

    gxx = spd(ks[4], Tm1 + 1, n)
    guu = spd(ks[5], Tm1, m)
    gux = 0.2 * jax.random.normal(ks[6], (B, Tm1, m, n), dtype)
    return fx, fu, gx, gu, gxx, guu, gux


def _sl(a):
    """[B, ...] -> [..., B // 128, 128]."""
    a = jnp.moveaxis(a, 0, -1)
    return a.reshape(a.shape[:-1] + (a.shape[-1] // 128, 128))


def _unsl(a):
    """[..., S, 128] -> [S * 128, ...]."""
    a = a.reshape(a.shape[:-2] + (-1,))
    return jnp.moveaxis(a, -1, 0)


def _sl_args(fx, fu, gx, gu, gxx, guu, gux):
    stacks = tuple(_sl(a) for a in (fx, fu, gx[:, :-1], gu, gxx[:, :-1], guu, gux))
    return stacks, _sl(gxx[:, -1]), _sl(gx[:, -1])


@functools.lru_cache(maxsize=None)
def _reference_case(n, m, dtype):
    """Operands and XLA-reference outputs, shared by the full and ragged
    kernel cases (the reference compile dominates at quadrotor widths)."""
    stacks, gxxT, gxT = _sl_args(*_stacks(n, m, 384, 5, dtype, seed=n + m))
    reg = jnp.full(gxT.shape[1:], 1e-3, dtype)
    return (stacks, gxxT, gxT, reg), pk.riccati_scan_sl(stacks, gxxT, gxT, reg)


@pytest.mark.parametrize("ragged", [False, True], ids=["full", "ragged"])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("n,m", [(2, 1), (3, 2), (4, 1), (12, 4)])
def test_kernel_matches_xla_reference(n, m, dtype, ragged):
    """Kernel (interpret mode) == XLA scan reference, lane for lane.  With
    ``ragged`` the 384 lanes are not a multiple of the 256-lane block, so
    the last program masks its loads and stores."""
    args, ref = _reference_case(n, m, dtype)
    out = pk.riccati_triton(
        *args, interpret=True, lane_block=256 if ragged else 128
    )
    tol = 1e-5 if dtype == jnp.float32 else 1e-12
    for name, a, b in zip(_NAMES, ref, out):
        assert a.shape == b.shape, name
        np.testing.assert_allclose(
            np.asarray(b), np.asarray(a), rtol=tol, atol=tol, err_msg=name
        )
    np.testing.assert_array_equal(np.asarray(out[5]), np.asarray(ref[5]))
    assert bool(jnp.all(ref[5] == 1.0))


@pytest.mark.parametrize("n,m", [(2, 1), (3, 2), (4, 1), (5, 3)])
def test_xla_reference_matches_backward_pass_scan(n, m):
    """The SL reference == vmapped per-instance ``backward_pass_scan``."""
    B, Tm1, dtype = 128, 6, jnp.float64
    fx, fu, gx, gu, gxx, guu, gux = _stacks(n, m, B, Tm1, dtype, seed=3)
    um = jnp.ones((Tm1, m), bool)
    stacks, gxxT, gxT = _sl_args(fx, fu, gx, gu, gxx, guu, gux)
    out = pk.backward_pass_sl(
        stacks, gxxT, gxT, jnp.zeros((1, 128), dtype), um, impl="xla"
    )
    ref = jax.vmap(
        lambda *a: backward_pass_scan(*a, um, jnp.zeros((), dtype))
    )(fx, fu, gx, gu, gxx, guu, gux)
    for name, a, b in zip(_NAMES, ref[:5], out[:5]):
        np.testing.assert_allclose(
            np.asarray(_unsl(b)), np.asarray(a), rtol=1e-10, atol=1e-10,
            err_msg=name,
        )
    assert bool(jnp.all(out[5] == 1.0))


@pytest.mark.parametrize("impl", ["xla", "interpret"])
def test_ok_flag_is_per_lane(impl):
    """Lanes whose Quu is indefinite report ok=0; every other lane keeps
    ok=1 and exactly the gains it gets when solved on its own."""
    n, m, B, Tm1, dtype = 4, 1, 128, 4, jnp.float64
    fx, fu, gx, gu, gxx, guu, gux = _stacks(n, m, B, Tm1, dtype, seed=5)
    bad = np.zeros(B, bool)
    bad[[3, 77]] = True
    guu_bad = guu.at[bad, 1].set(-1e4)
    um = jnp.ones((Tm1, m), bool)
    reg = jnp.zeros((1, 128), dtype)
    stacks, gxxT, gxT = _sl_args(fx, fu, gx, gu, gxx, guu_bad, gux)
    out = pk.backward_pass_sl(stacks, gxxT, gxT, reg, um, impl=impl)
    ok = np.asarray(out[5]).reshape(B)
    np.testing.assert_array_equal(ok, (~bad).astype(ok.dtype))
    stacks_ok, _, _ = _sl_args(fx, fu, gx, gu, gxx, guu, gux)
    clean = pk.backward_pass_sl(stacks_ok, gxxT, gxT, reg, um, impl=impl)
    for name, a, b in zip(_NAMES, clean, out):
        np.testing.assert_allclose(
            np.asarray(_unsl(b))[~bad], np.asarray(_unsl(a))[~bad],
            rtol=1e-12, atol=1e-12, err_msg=name,
        )


def test_u_mask_fixup_gives_zero_gains_on_padded_controls():
    """Padded action dims (u_mask False) carry exactly-zero derivative rows;
    the unit-diagonal fixup keeps the factorization PD and their gains 0,
    and the real control's gains equal the unpadded problem's."""
    n, B, Tm1, dtype = 3, 128, 5, jnp.float64
    fx, fu, gx, gu, gxx, guu, gux = _stacks(n, 1, B, Tm1, dtype, seed=9)
    zpad = lambda a, axis: jnp.concatenate(
        [a, jnp.zeros_like(a.take(jnp.arange(1), axis=axis))], axis=axis
    )
    fu2 = zpad(fu, 3)
    gu2 = zpad(gu, 2)
    guu2 = zpad(zpad(guu, 2), 3)
    gux2 = zpad(gux, 2)
    um = jnp.asarray(np.tile([True, False], (Tm1, 1)))
    reg = jnp.zeros((1, 128), dtype)
    stacks2, gxxT, gxT = _sl_args(fx, fu2, gx, gu2, gxx, guu2, gux2)
    stacks1, _, _ = _sl_args(fx, fu, gx, gu, gxx, guu, gux)
    for impl in ("xla", "interpret"):
        out = pk.backward_pass_sl(stacks2, gxxT, gxT, reg, um, impl=impl)
        ref = pk.backward_pass_sl(
            stacks1, gxxT, gxT, reg, jnp.ones((Tm1, 1), bool), impl=impl
        )
        assert bool(jnp.all(out[5] == 1.0)), impl
        np.testing.assert_array_equal(np.asarray(out[0][:, 1]), 0.0)
        np.testing.assert_array_equal(np.asarray(out[1][:, 1]), 0.0)
        np.testing.assert_allclose(
            np.asarray(out[0][:, :1]), np.asarray(ref[0]), rtol=1e-12,
            atol=1e-12,
        )
        np.testing.assert_allclose(
            np.asarray(out[4]), np.asarray(ref[4]), rtol=1e-12, atol=1e-12
        )


@pytest.mark.parametrize(
    "n,m,platform,interpret,want",
    [
        (4, 1, "gpu", False, "triton"),     # acrobot / cartpole widths
        (3, 2, "gpu", False, "triton"),     # car
        (6, 2, "gpu", False, "xla"),        # past the kernel's limit
        (12, 4, "gpu", False, "xla"),       # quadrotor
        (4, 1, "cpu", False, "xla"),        # no card: never the kernel
        (12, 4, "cpu", True, "interpret"),  # the tests' explicit request
    ],
)
def test_riccati_impl_choice(n, m, platform, interpret, want):
    assert pk.riccati_impl(n, m, platform, interpret) == want
    assert pk.kernel_fits(n, m) == (n * n + m * n <= pk.KERNEL_MAX_ENTRIES)


@pytest.mark.gpu
def test_compiled_kernel_matches_reference_on_gpu(gpu_device):
    """The kernel compiled for the card (never interpreted) against the XLA
    reference at acrobot widths, f32."""
    with jax.default_device(gpu_device):
        args, ref = _reference_case(4, 1, jnp.float32)
        out = jax.jit(pk.riccati_triton)(*args)
    for name, a, b in zip(_NAMES, ref, out):
        np.testing.assert_allclose(
            np.asarray(b), np.asarray(a), rtol=1e-4, atol=1e-4, err_msg=name
        )
