"""Straggler-compaction driver for the batched SL solve.

A batched ``lax.while_loop`` runs until the SLOWEST instance converges, so
wall clock is set by the iteration-count TAIL, not the mean.  Measured on
the acrobot T=101 B=4096 parity batch (benchmarks/tail_analysis.py): mean 72
iterations, p90 102, max 216 — and the live fraction collapses to 13.7% by
iteration 96 and 2% by 128.  Running the last ~120 iterations at B=4096 for
~500 live instances bills every lane for the slowest one.

This driver runs the SL solver (core/solve_sl.py) in bounded CHUNKS of
iterations and, between chunks, COMPACTS the still-live instances into a
smaller batch shape when they fit in a fraction of the current one:

    carry = init(xs, us, ws)                       # full batch  B0
    while live:
        carry = chunk(carry)                        # <= K iterations
        if ceil_grain(n_live) <= B_cur / shrink:    # worth re-packing
            scatter carry back into the full-batch carry
            gather live lanes (+ frozen fillers) into the smaller shape
    scatter; solution = finish(full carry)          # one pass, full batch

Per-instance semantics are EXACTLY those of the single-shot SL solver: each
lane's update sequence is independent (converged lanes are frozen by the
``live`` mask in the body), so chunk boundaries and lane moves change
nothing but wall clock; tests/test_solve_compact.py asserts bitwise-equal
Solutions on CPU.

This is a HOST-side loop (a few device syncs of one [S,128] bool per chunk)
— the returned callable is not jittable end-to-end.  Each distinct batch
shape is a separate compiled program, compiled on first use.

Reference analog: none (the reference solves one instance at a time); this
is batch-scheduling machinery.
"""

from __future__ import annotations

import dataclasses
import logging

import numpy as np

import jax
import jax.numpy as jnp

from .options import Options
from .solve import Solution
from ..ops.packed_backward import BATCH_GRAIN
from .solve_sl import make_sl_parts
from .spec import ProblemSpec

_log = logging.getLogger(__name__)


def _round_up(x, mult):
    return -(-x // mult) * mult


def make_compacted_solve_fn(
    spec: ProblemSpec,
    options: Options = Options(),
    *,
    chunk: int = 32,
    shrink: int = 2,
    dual_warm_start: bool = False,
    rescue: bool = True,
    rescue_options: Options | None = None,
    devices=None,
):
    """Build a host-callable ``(xs [B,T,nx], us, ws) -> Solution``.

    ``chunk``: iterations per device dispatch (tail granularity).
    ``shrink``: only re-pack when the live set fits in ``B_cur / shrink``.
    ``dual_warm_start``: the callable takes two extra batch-leading arrays
    ``(duals0 [B,T,nc], penalty0 [B,T,nc])``.
    ``rescue``: failed-lane re-solves from the ORIGINAL inputs, in one
    small grain-sized batch, patched into the Solution rows.  Two stages:
    (1) with ``early_round_iteration_cap`` set, any instance that exits
    infeasible under the truncated schedule is re-solved at the exact
    uncapped schedule — so the capped driver's solved set is always a
    superset of the uncapped solver's; (2) any instance still infeasible
    or NaN (genuine divergence, e.g. the f32 conditioning blow-ups seen
    at B=16384 — docs/design.md section 3 "Scale note") is re-solved once
    at escalated initial regularization (max(reg_init, 1e-3)).  All
    rescue programs are built lazily on first failure; each firing costs
    one extra dispatch of a BATCH_GRAIN-sized batch.

    ``devices``: a sequence of >1 jax devices runs PER-DEVICE compaction —
    the batch splits into one contiguous sub-batch per device, each with
    its own independent compaction loop, dispatches interleaved so every
    device's next chunk is queued before any device's host sync.  This is
    the multi-chip production path WITH straggler compaction (the
    shard_map route in parallel/shard.py runs the monolithic while-loop
    per shard and bills each shard's iteration tail).  Per-lane results
    remain bitwise those of the single-device driver.

    Exit-diagnostics caveat (for warm-start consumers): trajectories,
    iterates, duals, and violations are bitwise-identical to the
    single-shot SL solver, but ``Solution.K``/``k``/``grad_norm`` come
    from a separately-jitted finish program whose Cholesky-retry decision
    can flip on PD-marginal instances — measured <0.5% of instances
    differ (tests/test_solve_compact.py).  Re-derive gains from the
    returned trajectories if exact agreement with the single-shot
    solver's gains matters.
    """
    parts = make_sl_parts(
        spec, options, dual_warm_start=dual_warm_start
    )
    rescue_parts = None
    if rescue and options.early_round_iteration_cap is not None:
        rescue_parts = make_sl_parts(
            spec,
            dataclasses.replace(options, early_round_iteration_cap=None),
            dual_warm_start=dual_warm_start,
        )
    # generalized rescue (any schedule): lanes that exit infeasible or NaN
    # even UNCAPPED are re-solved once under ``rescue_options`` (default:
    # escalated initial regularization — the divergence signature at scale
    # is a conditioning blow-up in the first aggressive f32 iterations,
    # docs/design.md section 3 "Scale note", which a nonzero reg floor
    # damps).  Lazily built: the parts exist only if such a lane appears.
    rescue_strong_opts = None
    if rescue:
        rescue_strong_opts = rescue_options or dataclasses.replace(
            options,
            early_round_iteration_cap=None,
            regularization_initial=max(
                options.regularization_initial, 1.0e-3
            ),
        )
    rescue_strong_parts_box = []

    def _mk_chunk_host(p):
        def _chunk_host(carry, ws, n_iters):
            # n_iters is TRACED (one compiled program per batch shape serves
            # any dispatch size — the driver grows dispatches after
            # compaction to cut host-sync round trips)
            body = p.body(ws)

            def cond(st):
                i, s = st
                return (i < n_iters) & ~jnp.all(s.stop)

            def step(st):
                i, s = st
                return i + 1, body(s)

            _, s = jax.lax.while_loop(cond, step, (jnp.int32(0), carry))
            return s

        return _chunk_host

    _chunk_host = _mk_chunk_host(parts)

    def _gather_host(carry, ws, idx):
        # idx [B'] int32 lane indices into the flattened (S,128) batch
        S2 = idx.shape[0] // 128

        def g(a):
            # explicit lane count: -1 breaks on zero-size dims (npar=0)
            flat = a.reshape(a.shape[:-2] + (a.shape[-2] * a.shape[-1],))
            out = jnp.take(flat, idx, axis=-1)
            return out.reshape(out.shape[:-1] + (S2, 128))

        return jax.tree.map(g, carry), jax.tree.map(g, ws)

    def _scatter_host(carry_full, carry_small, idx):
        def sc(af, asm):
            flatf = af.reshape(af.shape[:-2] + (af.shape[-2] * af.shape[-1],))
            flats = asm.reshape(
                asm.shape[:-2] + (asm.shape[-2] * asm.shape[-1],)
            )
            out = flatf.at[..., idx].set(flats)
            return out.reshape(af.shape)

        return jax.tree.map(sc, carry_full, carry_small)

    # per-shape program tables, shared across solve() calls
    init_fns, finish_fns = {}, {}
    chunk_fns, gather_fns, scatter_fns = {}, {}, {}
    rescue_fns = {}

    def _put(a, dev):
        return a if dev is None else jax.device_put(a, dev)

    def _run_rescue(sol, failed, xs_b, us_b, ws_b, warm, dev=None,
                    parts_r=None, tag="rescue", opts_r=None):
        # re-solve of the failed lanes, from their ORIGINAL inputs, under
        # parts_r's schedule (tag "rescue": the exact uncapped schedule —
        # per-lane results bitwise the uncapped single-shot SL solver's;
        # tag "rescue_strong": escalated initial regularization).  One
        # dispatch: the while loop inside the chunk program runs to
        # all-stop under the uncapped worst-case iteration bound.
        Br = max(BATCH_GRAIN, _round_up(failed.size, BATCH_GRAIN))
        sel = np.resize(failed, Br)  # tile to fill; replicas discarded
        ins = tuple(
            _put(jnp.asarray(np.asarray(a)[sel]), dev)
            for a in (xs_b, us_b, ws_b, *warm)
        )
        opts_r = opts_r or options
        n_bound = jnp.int32(opts_r.max_iterations * opts_r.max_dual_updates)
        key = (tag, Br)
        if key not in rescue_fns:
            init_r = jax.jit(parts_r.init)
            chunk_r = jax.jit(_mk_chunk_host(parts_r))
            finish_r = jax.jit(lambda c, w: parts_r.finish(c, w, Br))
            rescue_fns[key] = (init_r, chunk_r, finish_r)
        init_r, chunk_r, finish_r = rescue_fns[key]
        carry_r, ws_r = init_r(*ins)
        sol_r = finish_r(chunk_r(carry_r, ws_r, n_bound), ws_r)

        def patch(a_full, a_small):
            a = np.array(a_full)
            a[failed] = np.asarray(a_small)[: failed.size]
            return jnp.asarray(a)

        return jax.tree.map(patch, sol, sol_r)

    class _DState:
        """One sub-batch's driver state (host bookkeeping + device arrays).

        The loop is split into ``_dispatch`` (queue the next chunk program —
        asynchronous) and ``_advance`` (block on THIS state's stop flags,
        then do compaction bookkeeping), so a multi-device driver can keep
        every device's next chunk queued before syncing any of them."""

        __slots__ = ("B", "Bp", "dev", "inputs", "carry_full", "carry",
                     "ws_full", "ws_cur", "idx", "pending")

    def _start(dev, xs_b, us_b, ws_b, *warm) -> "_DState":
        st = _DState()
        st.B = int(xs_b.shape[0])
        st.dev = dev
        st.inputs = (xs_b, us_b, ws_b, warm)
        args = tuple(_put(a, dev) for a in (xs_b, us_b, ws_b, *warm))
        if st.B not in init_fns:
            init_fns[st.B] = jax.jit(parts.init)
        st.carry_full, st.ws_full = init_fns[st.B](*args)
        st.Bp = st.carry_full.stop.shape[-2] * 128
        st.carry = None
        st.ws_cur = st.ws_full
        st.idx = None  # current-lane -> full-lane map; None = identity
        st.pending = None
        return st

    def _dispatch(st: "_DState"):
        cur = st.carry if st.idx is not None else st.carry_full
        Bc = cur.stop.shape[-2] * 128
        # grow dispatches at smaller shapes: the cheap post-compaction
        # phase should not pay one host round trip per `chunk` iterations
        n = jnp.int32(min(chunk * max(st.Bp // Bc, 1), 4 * chunk))
        if Bc not in chunk_fns:
            chunk_fns[Bc] = jax.jit(_chunk_host)
        st.pending = chunk_fns[Bc](cur, st.ws_cur, n)  # async

    def _fold_back(st: "_DState"):
        # fold the current small-batch carry into the full-batch carry
        Bc = st.carry.stop.shape[-2] * 128
        key = (st.Bp, Bc)
        if key not in scatter_fns:
            scatter_fns[key] = jax.jit(_scatter_host)
        st.carry_full = scatter_fns[key](st.carry_full, st.carry, st.idx)

    def _advance(st: "_DState") -> bool:
        """Sync the pending chunk; True when this sub-batch is all-stop."""
        cur, st.pending = st.pending, None
        if st.idx is None:
            st.carry_full = cur
        else:
            st.carry = cur
        stop = np.asarray(cur.stop).ravel()  # blocks on st.dev only
        if stop.all():
            return True
        live = np.flatnonzero(~stop)
        B_cur = stop.size
        B_next = max(BATCH_GRAIN, _round_up(len(live), BATCH_GRAIN))
        if B_next * shrink > B_cur:
            return False
        # re-pack: live lanes + frozen (stopped) fillers to B_next
        fill = np.flatnonzero(stop)[: B_next - len(live)]
        sel = np.concatenate([live, fill]).astype(np.int32)
        if st.idx is not None:
            _fold_back(st)
            sel = np.asarray(st.idx)[sel]  # to full-lane coordinates
        key = (st.Bp, B_next)
        st.idx = _put(jnp.asarray(sel, jnp.int32), st.dev)
        if key not in gather_fns:
            gather_fns[key] = jax.jit(_gather_host)
        st.carry, st.ws_cur = gather_fns[key](
            st.carry_full, st.ws_full, st.idx
        )
        return False

    def _finish_state(st: "_DState", counts=None) -> Solution:
        if st.idx is not None:
            _fold_back(st)
        if st.B not in finish_fns:
            finish_fns[st.B] = jax.jit(
                lambda c, w, B=st.B: parts.finish(c, w, B)
            )
        sol = finish_fns[st.B](st.carry_full, st.ws_full)
        tol = options.constraint_tolerance

        def _failed(s):
            # ~(viol <= tol), NOT viol > tol: NaN lanes (genuine f32
            # divergence) must count as failed
            viol = np.asarray(s.max_violation)
            return np.flatnonzero(~(viol <= tol))

        def _count(tag, n):
            # aggregated per solve() call: one warning per rescue kind
            # instead of one per device sub-batch
            if counts is not None:
                counts[tag][0] += n
                counts[tag][1] += 1

        if rescue_parts is not None:
            failed = _failed(sol)
            if failed.size:
                # a healthy default schedule (truncation_requires_progress)
                # should never need this
                _count("rescue", failed.size)
                xs_b, us_b, ws_b, warm = st.inputs
                sol = _run_rescue(
                    sol, failed, xs_b, us_b, ws_b, warm, dev=st.dev,
                    parts_r=rescue_parts, tag="rescue",
                )
        if rescue_strong_opts is not None:
            failed = _failed(sol)
            if failed.size:
                if not rescue_strong_parts_box:
                    rescue_strong_parts_box.append(make_sl_parts(
                        spec, rescue_strong_opts,
                        dual_warm_start=dual_warm_start,
                    ))
                _count("rescue_strong", failed.size)
                xs_b, us_b, ws_b, warm = st.inputs
                sol = _run_rescue(
                    sol, failed, xs_b, us_b, ws_b, warm, dev=st.dev,
                    parts_r=rescue_strong_parts_box[0], tag="rescue_strong",
                    opts_r=rescue_strong_opts,
                )
        return sol

    def _new_counts():
        return {"rescue": [0, 0], "rescue_strong": [0, 0]}

    def _log_rescues(counts):
        lanes, subs = counts["rescue"]
        if lanes:
            _log.warning(
                "[compact] rescue: %d lane(s) in %d sub-batch(es) exited "
                "infeasible under the truncated schedule; re-solved at the "
                "exact uncapped schedule", lanes, subs,
            )
        lanes, subs = counts["rescue_strong"]
        if lanes:
            _log.warning(
                "[compact] strong rescue: %d lane(s) in %d sub-batch(es) "
                "infeasible/NaN even uncapped; re-solved at escalated "
                "initial regularization (%g)", lanes, subs,
                rescue_strong_opts.regularization_initial,
            )

    def solve(xs_b, us_b, ws_b, *warm) -> Solution:
        st = _start(None, xs_b, us_b, ws_b, *warm)
        while True:
            _dispatch(st)
            if _advance(st):
                break
        counts = _new_counts()
        sol = _finish_state(st, counts)
        _log_rescues(counts)
        return sol

    if devices is None or len(devices) <= 1:
        return solve

    n_dev = len(devices)

    def solve_sharded(xs_b, us_b, ws_b, *warm) -> Solution:
        """Per-device straggler compaction: the batch splits into one
        contiguous sub-batch per device and each runs its OWN compaction
        loop.  Dispatches interleave — every live device has its next chunk
        queued before any device's stop flags are synced — so devices
        overlap despite the single host thread.  Per-lane results are
        bitwise those of the single-device driver (lanes are independent;
        only the batch shapes they ride differ)."""
        B = int(xs_b.shape[0])
        bounds = np.linspace(0, B, n_dev + 1).astype(int)
        states = []
        for i, dev in enumerate(devices):
            lo, hi = int(bounds[i]), int(bounds[i + 1])
            if lo == hi:
                continue
            states.append(_start(
                dev, xs_b[lo:hi], us_b[lo:hi], ws_b[lo:hi],
                *(w[lo:hi] for w in warm),
            ))
        for st in states:
            _dispatch(st)
        live = list(states)
        while live:
            nxt = []
            for st in live:
                if not _advance(st):
                    _dispatch(st)
                    nxt.append(st)
            live = nxt
        counts = _new_counts()
        sols = [_finish_state(st, counts) for st in states]
        _log_rescues(counts)
        if len(sols) == 1:
            return sols[0]
        return jax.tree.map(
            lambda *xs: jnp.concatenate(
                [jnp.asarray(np.asarray(x)) for x in xs], axis=0
            ),
            *sols,
        )

    return solve_sharded
