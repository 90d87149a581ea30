"""Time the compaction driver's chunk programs at each batch shape.

Verifies (or refutes) the hypothesis that the SL solve iteration is
latency-bound: if chunk(B=1024) costs ~= chunk(B=4096), straggler
compaction cannot shorten the tail and the parity lever is per-iteration
latency / tail iteration count instead.

Needs a GPU: a time from the CPU says nothing about the card.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--horizon", type=int, default=101)
    ap.add_argument("--preset", default="parity")
    ap.add_argument("--chunk", type=int, default=32)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from iterativelqr_tpu.utils.compile_cache import setup_compile_cache

    setup_compile_cache()

    from iterativelqr_tpu import Options
    from iterativelqr_tpu.core.solve_sl import make_sl_parts
    from iterativelqr_tpu.core.spec import build_spec
    from iterativelqr_tpu.models import acrobot

    T, B = args.horizon, args.batch
    dynamics, objective, constraints, x1, xT = acrobot.problem(T)
    spec = build_spec(dynamics, objective, constraints)
    if jax.devices()[0].platform != "gpu":
        sys.exit("chunk_timing: JAX finds no GPU")
    kw = dict(verbose=False, record_traces=False)
    if args.preset == "tuned":
        kw.update(initial_constraint_penalty=1000.0, min_step_size=4.0e-3)
    opts = Options(**kw)
    parts = make_sl_parts(spec, opts)

    dtype = jnp.float32
    key = jax.random.PRNGKey(0)
    x0 = 0.05 * jax.random.normal(key, (B, spec.nx), dtype)
    xs = jnp.zeros((B, T, spec.nx), dtype).at[:, 0, :].set(x0)
    us = 0.05 * jnp.ones((B, T - 1, spec.nu), dtype)
    ws = jnp.zeros((B, T, max(spec.npar, 0)), dtype)

    nK = jnp.int32(args.chunk)

    def chunk_host(carry, w):
        body = parts.body(w)

        def cond(st):
            i, s = st
            return (i < nK) & ~jnp.all(s.stop)

        def step(st):
            i, s = st
            return i + 1, body(s)

        _, s = jax.lax.while_loop(cond, step, (jnp.int32(0), carry))
        return s

    carry, ws_sl = jax.jit(parts.init)(xs, us, ws)

    for Bc in (4096, 1024):
        frac = Bc // 128
        sub = jax.tree.map(lambda a: a[..., :frac, :], carry)
        wsub = ws_sl[..., :frac, :]
        fn = jax.jit(chunk_host)
        out = fn(sub, wsub)
        jax.block_until_ready(out)
        # time a chunk from the initial carry (all lanes live, K iterations)
        reps = 3
        t0 = time.perf_counter()
        for _ in range(reps):
            out = fn(sub, wsub)
            jax.block_until_ready(out)
        dt = (time.perf_counter() - t0) / reps
        print(json.dumps({
            "B": Bc, "chunk_ms": round(dt * 1e3, 2),
            "per_iter_ms": round(dt * 1e3 / args.chunk, 3),
        }), flush=True)


if __name__ == "__main__":
    main()
