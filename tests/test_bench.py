"""bench.py, chip_smoke.py and the benchmark tools: CLI mapping, the
refusal to run without a GPU, the stage bench's peak table and the trace
reduction behind the idle share."""

import importlib.util
import os
import subprocess
import sys
import types

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(relpath, name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, relpath)
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _cli(**kw):
    base = dict(early_cap=None, mct=None, min_step=None, penalty=None)
    base.update(kw)
    return types.SimpleNamespace(**base)


def test_bench_cli_override_mapping():
    """--early-cap 0 must mean the UNCAPPED schedule (Options wants None —
    the no-cap control the tuned preset was swept against), and --min-step
    must reach Options.min_step_size."""
    bench = _load("bench.py", "bench_module")
    tuned = bench.preset_options("tuned", _cli())
    assert tuned.early_round_iteration_cap == 20  # the swept-in default
    nocap = bench.preset_options("tuned", _cli(early_cap=0))
    assert nocap.early_round_iteration_cap is None
    grid = bench.preset_options("tuned", _cli(min_step=1.6e-2))
    assert grid.min_step_size == pytest.approx(1.6e-2)
    assert grid.num_step_sizes == 6
    assert nocap != tuned and grid != tuned
    with pytest.raises(SystemExit):
        bench.preset_options("tuned", _cli(early_cap=-1))


def _run_cpu(args, cwd=REPO, timeout=240):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run(
        [sys.executable] + args, cwd=cwd, env=env, capture_output=True,
        text=True, timeout=timeout,
    )


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
def test_refuses_to_run_without_gpu(script):
    """With no GPU both entry points exit non-zero and print no result:
    chip_smoke.py no ``ok`` line, bench.py only its error record."""
    out = _run_cpu([os.path.join(REPO, script)])
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
    if script == "bench.py":
        assert '"error": "no_gpu"' in out.stdout
        assert '"value": null' in out.stdout


def test_chip_smoke_alone_fails(tmp_path):
    """A directory holding chip_smoke.py and nothing else of the repo
    cannot pass, whatever the platform."""
    import shutil

    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    out = _run_cpu([str(tmp_path / "chip_smoke.py")], cwd=tmp_path)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_stage_bench_peaks_keyed_by_device_kind():
    """The roofline peaks come from one table keyed by device_kind; an
    unknown device is an error, never a default."""
    sb = _load(os.path.join("benchmarks", "stage_bench.py"), "stage_bench")
    hbm, flops = sb.peaks("NVIDIA H100 80GB HBM3")
    assert hbm == pytest.approx(3.35e12)
    assert flops == pytest.approx(67e12)
    with pytest.raises(KeyError):
        sb.peaks("Unlisted Accelerator")
    with pytest.raises(KeyError):
        sb.peaks("cpu")


def test_trace_idle_reduction():
    """benchmarks/trace_idle.py: busy time is the union of device op
    intervals clipped to the named span; ops on other planes and outside
    the span do not count."""
    import collections

    ti = _load(os.path.join("benchmarks", "trace_idle.py"), "trace_idle")
    assert ti.union_ns([(0, 10), (5, 12), (20, 25), (25, 30)]) == 22
    Ev = collections.namedtuple("Ev", "name start_ns end_ns")
    Line = collections.namedtuple("Line", "events")
    Plane = collections.namedtuple("Plane", "name lines")
    planes = [
        Plane("/host:CPU", [Line([Ev(ti.SPAN, 100, 200), Ev("x", 0, 500)])]),
        Plane("/device:GPU:0", [
            Line([Ev("k1", 90, 120), Ev("k2", 150, 160)]),
            Line([Ev("k1", 155, 170), Ev("late", 250, 300)]),
        ]),
    ]
    span, busy, per_op = ti.reduce_trace(planes)
    assert (span, busy) == (100, 40)
    assert per_op == {"k1": 35, "k2": 10}
    with pytest.raises(ValueError):
        ti.reduce_trace(planes, span_name="absent")


def test_trace_idle_reads_a_real_trace(tmp_path):
    """The reduction runs on a trace jax.profiler writes (CPU here: the
    host plane stands in for the device)."""
    import glob

    import jax
    import jax.numpy as jnp

    ti = _load(os.path.join("benchmarks", "trace_idle.py"), "trace_idle")
    f = jax.jit(lambda x: jnp.sin(x) @ x)
    x = jnp.ones((64, 64))
    f(x).block_until_ready()
    jax.profiler.start_trace(str(tmp_path))
    with jax.profiler.TraceAnnotation(ti.SPAN):
        f(x).block_until_ready()
    jax.profiler.stop_trace()
    path = glob.glob(str(tmp_path / "**" / "*.xplane.pb"), recursive=True)[0]
    planes = jax.profiler.ProfileData.from_file(path).planes
    span, busy, _ = ti.reduce_trace(planes, device_prefix="/host:CPU")
    assert span > 0 and 0 < busy <= span
