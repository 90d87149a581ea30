"""Per-stage microbenchmarks (analog of reference test/benchmark.jl).

Times each solver stage in isolation at a given (B, T) on the GPU:
objective/constraint evaluation, derivative stacks + AL augmentation,
backward pass (scan and associative variants), closed-loop rollout, and the
full parallel-alpha line search, plus the SL-layout stages of the batched
solver.  Prints one JSON line per stage, each naming its device.  With no
GPU it exits non-zero.

Usage: python benchmarks/stage_bench.py [--batch 4096] [--horizon 101]
       [--roofline]
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir))

import jax
import jax.numpy as jnp

# Published peaks by JAX device_kind: (device-memory bytes/s, float32
# FLOP/s outside the tensor cores).  Source: NVIDIA H100 Tensor Core GPU
# data sheet, SXM part, dense rates at the 700 W power limit.  A device
# that is not listed is an error, not a default.
PEAKS = {
    "NVIDIA H100 80GB HBM3": (3.35e12, 67e12),
}


def peaks(device_kind):
    """(bytes/s, FLOP/s) for ``device_kind``; KeyError when unlisted."""
    if device_kind not in PEAKS:
        raise KeyError(f"no published peaks for device {device_kind!r}")
    return PEAKS[device_kind]


def timeit(fn, args, reps=20, warmup=2):
    for _ in range(warmup):
        out = fn(*args)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / reps


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--horizon", type=int, default=101)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument(
        "--roofline", action="store_true",
        help="add XLA cost_analysis (bytes accessed / flops) per stage and "
        "the roofline share against the device's published peaks; also "
        "times one full SL solver body iteration",
    )
    args = ap.parse_args()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"stage_bench: JAX finds no GPU (platform {dev.platform!r})")
    peak_bw, peak_flops = peaks(dev.device_kind) if args.roofline else (0, 0)
    from iterativelqr_tpu.utils.compile_cache import setup_compile_cache

    setup_compile_cache()

    from iterativelqr_tpu import Options
    from iterativelqr_tpu.core.spec import build_spec
    from iterativelqr_tpu.models import acrobot
    from iterativelqr_tpu.ops import al as al_ops
    from iterativelqr_tpu.ops import derivatives as dv
    from iterativelqr_tpu.ops.assoc import backward_pass_associative
    from iterativelqr_tpu.ops.backward import backward_pass_scan
    from iterativelqr_tpu.ops.forward import line_search
    from iterativelqr_tpu.ops.rollout import closed_loop_rollout

    B, T = args.batch, args.horizon
    dynamics, objective, constraints, x1, xT = acrobot.problem(T)
    spec = build_spec(dynamics, objective, constraints)
    opts = Options(verbose=False, record_traces=False)
    dtype = jnp.float32
    nx, nu, nc = spec.nx, spec.nu, spec.nc
    ineq = jnp.asarray(spec.ineq_mask)
    u_mask = jnp.asarray(spec.u_mask)

    key = jax.random.PRNGKey(0)
    xs = 0.1 * jax.random.normal(key, (B, T, nx), dtype)
    us = 0.05 * jnp.ones((B, T - 1, nu), dtype)
    ws = jnp.zeros((B, T, max(spec.npar, 0)), dtype)
    duals = jnp.zeros((B, T, nc), dtype)
    penalty = jnp.ones((B, T, nc), dtype)

    prec = jax.default_matmul_precision

    @jax.jit
    def stage_objective(xs, us, ws, duals, penalty):
        with prec("float32"):
            def one(xs, us, ws, duals, penalty):
                J = dv.total_cost(spec, xs, us, ws)
                c = dv.constraint_values(spec, xs, us, ws)
                return J + al_ops.al_terms(c, duals, penalty, ineq), c
            return jax.vmap(one)(xs, us, ws, duals, penalty)

    @jax.jit
    def stage_derive(xs, us, ws, duals, penalty):
        with prec("float32"):
            def one(xs, us, ws, duals, penalty):
                fx, fu = dv.dynamics_jacobians(spec, xs, us, ws)
                gx, gu = dv.cost_gradients(spec, xs, us, ws)
                gxx, guu, gux = dv.cost_hessians(spec, xs, us, ws)
                c = dv.constraint_values(spec, xs, us, ws)
                cx, cu = dv.constraint_jacobians(spec, xs, us, ws)
                dgx, dgu, dgxx, dguu, dgux = al_ops.al_gradient_terms(
                    c, cx, cu, duals, penalty, ineq
                )
                return fx, fu, gx + dgx, gu + dgu, gxx + dgxx, guu + dguu, gux + dgux
            return jax.vmap(one)(xs, us, ws, duals, penalty)

    stacks = stage_derive(xs, us, ws, duals, penalty)
    jax.block_until_ready(stacks)
    fx, fu, gx, gu, gxx, guu, gux = stacks
    reg = jnp.zeros((), dtype)

    @jax.jit
    def stage_backward_scan(fx, fu, gx, gu, gxx, guu, gux):
        with prec("float32"):
            return jax.vmap(
                lambda *a: backward_pass_scan(*a, u_mask, reg, unroll=opts.scan_unroll)
            )(fx, fu, gx, gu, gxx, guu, gux)

    @jax.jit
    def stage_backward_assoc(fx, fu, gx, gu, gxx, guu, gux):
        with prec("float32"):
            return jax.vmap(
                lambda *a: backward_pass_associative(*a, u_mask, reg)
            )(fx, fu, gx, gu, gxx, guu, gux)

    K, kff, Qx, Qu, p, ok = stage_backward_scan(fx, fu, gx, gu, gxx, guu, gux)
    jax.block_until_ready(K)

    @jax.jit
    def stage_rollout(xs, us, ws, K, kff):
        with prec("float32"):
            return jax.vmap(
                lambda xs, us, ws, K, kff: closed_loop_rollout(
                    spec, xs, us, ws, K, kff, 0.5, unroll=opts.scan_unroll
                )
            )(xs, us, ws, K, kff)

    def make_line_search(local_opts):
        @jax.jit
        def stage_line_search(xs, us, ws, K, kff, duals, penalty):
            with prec("float32"):
                def one(xs, us, ws, K, kff, duals, penalty):
                    def obj_fn(xs_, us_):
                        J = dv.total_cost(spec, xs_, us_, ws)
                        c = dv.constraint_values(spec, xs_, us_, ws)
                        return J + al_ops.al_terms(c, duals, penalty, ineq), c
                    J0, c0 = obj_fn(xs, us)
                    return line_search(
                        spec, obj_fn, xs, us, ws, K, kff,
                        jnp.asarray(-1.0, xs.dtype), J0, c0, local_opts,
                        duals=duals, penalty=penalty,
                    )
                return jax.vmap(one)(xs, us, ws, K, kff, duals, penalty)
        return stage_line_search

    import dataclasses as _dc

    stages = {
        "objective_eval": (stage_objective, (xs, us, ws, duals, penalty)),
        "derivatives_al": (stage_derive, (xs, us, ws, duals, penalty)),
        "backward_scan": (stage_backward_scan, (fx, fu, gx, gu, gxx, guu, gux)),
        "backward_assoc": (stage_backward_assoc, (fx, fu, gx, gu, gxx, guu, gux)),
        "rollout": (stage_rollout, (xs, us, ws, K, kff)),
        "line_search_full": (
            make_line_search(opts), (xs, us, ws, K, kff, duals, penalty)
        ),
        "line_search_8alpha": (
            make_line_search(_dc.replace(opts, min_step_size=4.0e-3)),
            (xs, us, ws, K, kff, duals, penalty),
        ),
        "line_search_unroll8": (
            make_line_search(_dc.replace(opts, scan_unroll=8)),
            (xs, us, ws, K, kff, duals, penalty),
        ),
    }
    # SL-layout stages of the batched solver (core/solve_sl.py): everything
    # [T, *dims, S, 128] with the batch on the two trailing axes
    from iterativelqr_tpu.ops.packed_backward import BATCH_GRAIN

    if B % BATCH_GRAIN == 0:
        from iterativelqr_tpu.ops.packed_pipeline import make_derive_backward_sl
        from iterativelqr_tpu.ops.sl_ops import SLOps, to_sl

        S = B // 128
        sl_ops = SLOps(spec, opts)
        derive_sl = make_derive_backward_sl(spec, opts)
        xs_sl, us_sl, ws_sl = to_sl(xs, S), to_sl(us, S), to_sl(ws, S)
        duals_sl = to_sl(duals, S)
        pen_sl = to_sl(penalty, S)
        reg_sl = jnp.zeros((S, 128), dtype)

        @jax.jit
        def stage_sl_objective(xs_sl, us_sl, ws_sl, duals_sl, pen_sl):
            with prec("float32"):
                return sl_ops.al_objective(xs_sl, us_sl, ws_sl, duals_sl, pen_sl)

        J_sl, c_sl = stage_sl_objective(xs_sl, us_sl, ws_sl, duals_sl, pen_sl)
        jax.block_until_ready(c_sl)

        @jax.jit
        def stage_sl_derive_backward(xs_sl, us_sl, ws_sl, duals_sl, pen_sl,
                                     c_sl, reg_sl):
            with prec("float32"):
                return derive_sl(
                    xs_sl, us_sl, ws_sl, duals_sl, pen_sl, c_sl, reg_sl
                )

        K_sl, k_sl, slope_sl, grad_sl, _ = stage_sl_derive_backward(
            xs_sl, us_sl, ws_sl, duals_sl, pen_sl, c_sl, reg_sl
        )
        jax.block_until_ready(K_sl)

        def make_sl_ls(local_opts):
            lops = SLOps(spec, local_opts)

            @jax.jit
            def stage_sl_line_search(xs_sl, us_sl, ws_sl, K_sl, k_sl,
                                     slope_sl, J_sl, c_sl, duals_sl, pen_sl):
                with prec("float32"):
                    return lops.line_search(
                        xs_sl, us_sl, ws_sl, K_sl, k_sl, slope_sl, J_sl,
                        c_sl, duals_sl, pen_sl,
                    )

            return stage_sl_line_search

        ls_args = (xs_sl, us_sl, ws_sl, K_sl, k_sl, slope_sl, J_sl, c_sl,
                   duals_sl, pen_sl)
        stages.update({
            "sl_objective_eval": (
                stage_sl_objective, (xs_sl, us_sl, ws_sl, duals_sl, pen_sl)
            ),
            "sl_derive_backward_slope": (
                stage_sl_derive_backward,
                (xs_sl, us_sl, ws_sl, duals_sl, pen_sl, c_sl, reg_sl),
            ),
            "sl_line_search_full": (make_sl_ls(opts), ls_args),
            "sl_line_search_8alpha": (
                make_sl_ls(_dc.replace(opts, min_step_size=4.0e-3)), ls_args
            ),
        })

    if args.roofline and B % BATCH_GRAIN == 0:
        # one full SL solver body iteration — the program the batched solve
        # dispatches per iteration (core/solve_sl.py); its measured time x
        # mean iterations is the whole-solve wall clock (minus compaction
        # and host overhead)
        from iterativelqr_tpu.core.solve_sl import make_sl_parts

        parts = make_sl_parts(
            spec, _dc.replace(opts, backward_pass="packed",
                              batched_solver="sl"),
        )
        carry0, ws_sl_full = jax.jit(parts.init)(xs, us, ws)
        jax.block_until_ready(carry0.J)
        body_fn = jax.jit(lambda s, w: parts.body(w)(s))
        stages["sl_body_full_iteration"] = (body_fn, (carry0, ws_sl_full))

    def cost_analysis(fn, a):
        """XLA's own program cost model: bytes accessed (HBM traffic as the
        compiler scheduled it) and flops.  Pallas custom calls are opaque to
        it — their memory traffic is not counted; treat kernel-stage bounds
        as lower bounds."""
        try:
            an = fn.lower(*a).compile().cost_analysis()
            if isinstance(an, (list, tuple)):
                an = an[0]
            return float(an.get("bytes accessed", 0.0)), float(
                an.get("flops", 0.0)
            )
        except Exception:
            return None, None

    for name, (fn, a) in stages.items():
        try:
            dt = timeit(fn, a, reps=args.reps)
            row = {
                "stage": name, "ms": round(dt * 1e3, 3), "batch": B,
                "horizon": T, "platform": dev.platform,
                "device_kind": dev.device_kind,
                "us_per_instance": round(dt / B * 1e6, 3),
            }
            if args.roofline:
                bytes_acc, flops = cost_analysis(fn, a)
                if bytes_acc is not None:
                    t_mem, t_flop = bytes_acc / peak_bw, flops / peak_flops
                    row.update({
                        "bytes_accessed": int(bytes_acc),
                        "flops": int(flops),
                        "bound_ms": max(t_mem, t_flop) * 1e3,
                        "bound_by": "memory" if t_mem >= t_flop else "flops",
                        "roofline_share": max(t_mem, t_flop) / dt,
                    })
            print(json.dumps(row), flush=True)
        except Exception as e:  # keep going; report the failure
            print(json.dumps({"stage": name, "error": str(e)[:200]}), flush=True)


if __name__ == "__main__":
    main()
