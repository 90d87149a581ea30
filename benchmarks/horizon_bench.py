"""Backward-pass regime map over (batch, horizon).

Times the scan and associative backward passes at each (B, T) grid point on
the current backend, in isolation (the stage dominates single-instance
latency and is the only stage whose optimal implementation flips with
regime).  The resulting table drives the ``backward_pass="auto"`` dispatch
rule (ops/backward.py) and docs/design.md section 3.

Usage: python benchmarks/horizon_bench.py [--cpu]
    [--batches 1,64,512,4096] [--horizons 101,251,501]
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir))

import jax
import jax.numpy as jnp


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--batches", default="1,64,512,4096")
    ap.add_argument("--horizons", default="101,251,501")
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    if not args.cpu and jax.devices()[0].platform != "gpu":
        sys.exit("horizon_bench: JAX finds no GPU (pass --cpu for a CPU run)")
    from iterativelqr_tpu.utils.compile_cache import setup_compile_cache

    setup_compile_cache()

    from iterativelqr_tpu.core.spec import build_spec
    from iterativelqr_tpu.models import acrobot
    from iterativelqr_tpu.ops.assoc import backward_pass_associative
    from iterativelqr_tpu.ops.backward import backward_pass_scan

    dtype = jnp.float32
    for T in [int(t) for t in args.horizons.split(",")]:
        dynamics, objective, constraints, x1, xT = acrobot.problem(T)
        spec = build_spec(dynamics, objective, constraints)
        nx, nu = spec.nx, spec.nu
        u_mask = jnp.asarray(spec.u_mask)
        for B in [int(b) for b in args.batches.split(",")]:
            key = jax.random.PRNGKey(0)
            ks = jax.random.split(key, 7)
            Tm1 = T - 1
            fx = 0.1 * jax.random.normal(ks[0], (B, Tm1, nx, nx), dtype) + jnp.eye(nx, dtype=dtype)
            fu = 0.1 * jax.random.normal(ks[1], (B, Tm1, nx, nu), dtype)
            gx = 0.1 * jax.random.normal(ks[2], (B, T, nx), dtype)
            gu = 0.1 * jax.random.normal(ks[3], (B, Tm1, nu), dtype)
            ex = jnp.eye(nx, dtype=dtype)
            eu = jnp.eye(nu, dtype=dtype)
            gxx = 0.2 * ex + jnp.zeros((B, T, nx, nx), dtype)
            guu = 0.2 * eu + jnp.zeros((B, Tm1, nu, nu), dtype)
            gux = jnp.zeros((B, Tm1, nu, nx), dtype)
            reg = jnp.zeros((B,), dtype)

            def bench(fn_name, fn):
                @jax.jit
                def run(fx, fu, gx, gu, gxx, guu, gux, reg):
                    with jax.default_matmul_precision("float32"):
                        return jax.vmap(
                            lambda *a: fn(*a[:7], u_mask, a[7])
                        )(fx, fu, gx, gu, gxx, guu, gux, reg)

                out = run(fx, fu, gx, gu, gxx, guu, gux, reg)
                jax.block_until_ready(out)
                t0 = time.perf_counter()
                for _ in range(args.reps):
                    out = run(fx, fu, gx, gu, gxx, guu, gux, reg)
                jax.block_until_ready(out)
                dt = (time.perf_counter() - t0) / args.reps
                print(json.dumps({
                    "T": T, "B": B, "variant": fn_name,
                    "ms": round(dt * 1e3, 3),
                    "us_per_instance": round(dt / B * 1e6, 2),
                    "backend": jax.default_backend(),
                }), flush=True)
                return dt

            t_scan = bench("scan", lambda *a: backward_pass_scan(*a, unroll=4))
            t_assoc = bench("assoc", backward_pass_associative)
            print(json.dumps({
                "T": T, "B": B,
                "winner": "assoc" if t_assoc < t_scan else "scan",
                "ratio_assoc_over_scan": round(t_assoc / t_scan, 3),
            }), flush=True)


if __name__ == "__main__":
    main()
