"""Device idle share of the bench path, from a profiler trace.

Traces one warm bench-path solve (SL solver + straggler compaction, acrobot
T=101) per preset inside a named host span, then reduces the trace: busy
time is the union of the device op intervals that overlap the span, and the
idle share is 1 - busy / span.  Also prints the device ops with the most
summed time.  Tracing slows the host, so the idle share it reports is an
upper bound on the untraced one.  Needs a GPU.

Usage: python benchmarks/trace_idle.py [--batch 8192] [--horizon 101]
"""

import argparse
import collections
import glob
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir))

SPAN = "bench_solve"


def union_ns(intervals):
    """Total length of the union of (start, end) intervals."""
    total, cur = 0, None
    for a, b in sorted(intervals):
        if cur is None or a > cur[1]:
            if cur is not None:
                total += cur[1] - cur[0]
            cur = [a, b]
        else:
            cur[1] = max(cur[1], b)
    if cur is not None:
        total += cur[1] - cur[0]
    return total


def reduce_trace(planes, span_name=SPAN, device_prefix="/device:GPU"):
    """(span_ns, busy_ns, Counter of op name -> summed ns) from profiler
    planes: the window is the first event named ``span_name`` on any plane;
    busy counts events on planes whose name starts with ``device_prefix``,
    clipped to the window."""
    planes = list(planes)  # the profiler hands out one-pass iterators
    win = None
    for plane in planes:
        for line in plane.lines:
            for ev in line.events:
                if ev.name == span_name and win is None:
                    win = (ev.start_ns, ev.end_ns)
    if win is None:
        raise ValueError(f"no {span_name!r} span in the trace")
    iv, per_op = [], collections.Counter()
    for plane in planes:
        if not plane.name.startswith(device_prefix):
            continue
        for line in plane.lines:
            for ev in line.events:
                a, b = max(ev.start_ns, win[0]), min(ev.end_ns, win[1])
                if b > a:
                    iv.append((a, b))
                    per_op[ev.name] += b - a
    return win[1] - win[0], union_ns(iv), per_op


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=8192)
    ap.add_argument("--horizon", type=int, default=101)
    args = ap.parse_args()

    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit("trace_idle: JAX finds no GPU")
    import chip_smoke
    from iterativelqr_tpu.core.solve_compact import make_compacted_solve_fn
    from iterativelqr_tpu.utils.compile_cache import setup_compile_cache

    setup_compile_cache()
    spec, xs, us, ws = chip_smoke._acrobot_batch(args.batch, args.horizon)
    for preset in ("tuned", "parity"):
        solve = make_compacted_solve_fn(
            spec, chip_smoke._preset(preset),
            chunk=48 if preset == "parity" else 32,
        )
        for _ in range(2):  # compile, then one warm call
            jax.block_until_ready(solve(xs, us, ws))
        with tempfile.TemporaryDirectory() as logdir:
            jax.profiler.start_trace(logdir)
            with jax.profiler.TraceAnnotation(SPAN):
                jax.block_until_ready(solve(xs, us, ws))
            jax.profiler.stop_trace()
            path = glob.glob(os.path.join(logdir, "**", "*.xplane.pb"),
                             recursive=True)[0]
            planes = jax.profiler.ProfileData.from_file(path).planes
            span, busy, per_op = reduce_trace(planes)
        print(f"{preset}: {dev.device_kind}, traced span {span / 1e9:.4f} s, "
              f"device busy {busy / 1e9:.4f} s, idle share "
              f"{1 - busy / span:.4f}", flush=True)
        tot = sum(per_op.values())
        for name, d in per_op.most_common(12):
            print(f"  {d / 1e6:9.3f} ms {100 * d / tot:5.1f}%  {name[:100]}")


if __name__ == "__main__":
    main()
