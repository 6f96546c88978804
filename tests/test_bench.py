"""Bench harness and roofline accounting tests (CPU)."""

import jax
import jax.numpy as jnp
import pytest

from ldpcgputegra.bench import measure_call, throughput_report
from ldpcgputegra.bench.roofline import (
    PEAKS,
    device_spec,
    kernel_model,
    roofline_report,
)
from ldpcgputegra.codes.registry import load_code
from ldpcgputegra.ops.layered import LayeredSpec

H100 = "NVIDIA H100 80GB HBM3"


def test_measure_call_slope_positive():
    @jax.jit
    def f(x):
        return (x.astype(jnp.int32) ** 2).cumsum(axis=1).astype(jnp.int32)

    inputs = [jnp.ones((64, 512), jnp.int8) * i for i in range(4)]
    sec = measure_call(f, inputs, windows=2)
    assert sec > 0


def test_measure_call_alternates_a_dict_of_functions():
    """A dict of functions is warmed, then timed in alternating windows,
    each on its own inputs; one time per function comes back."""
    calls = []

    def tagged(tag):
        def f(x):
            calls.append(tag)
            return x + 1
        return f

    xs = {"a": [jnp.ones(4), jnp.ones(4)], "b": [jnp.ones(8)]}
    sec = measure_call({"a": tagged("a"), "b": tagged("b")}, xs, windows=2)
    assert set(sec) == {"a", "b"} and all(v > 0 for v in sec.values())
    assert calls == ["a", "a", "b"] * 3  # warm-up, then two windows
    shared = measure_call({"a": tagged("a"), "b": tagged("b")},
                          [jnp.ones(2)], windows=1)
    assert set(shared) == {"a", "b"}


def test_throughput_report_accounting():
    rep = throughput_report(0.01, frames=1000, n=2000)
    # Mbps = frames * N / t / 1e6 (main.cpp:311-315)
    assert rep["coded_mbps"] == pytest.approx(1000 * 2000 / 0.01 / 1e6)
    assert rep["ms_per_call"] == pytest.approx(10.0)
    assert rep["frames_per_s"] == pytest.approx(1e5)


def test_roofline_model_scales_with_iters_and_batch():
    code = load_code("576x288")
    m1 = kernel_model(code, LayeredSpec(iters=10), batch=1024)
    m2 = kernel_model(code, LayeredSpec(iters=20), batch=1024)
    m3 = kernel_model(code, LayeredSpec(iters=10), batch=2048)
    assert m2["int32_ops"] == 2 * m1["int32_ops"]
    assert m3["int32_ops"] == 2 * m1["int32_ops"]
    assert m3["hbm_bytes"] == 2 * m1["hbm_bytes"]
    # message and APP traffic grows with the iteration count
    assert m2["hbm_bytes"] > m1["hbm_bytes"]


def test_roofline_report_bounds():
    code = load_code("576x288")
    spec = LayeredSpec(iters=10)
    hw = device_spec(H100)
    m = kernel_model(code, spec, batch=1024)
    t_bound = max(m["int32_ops"] / hw.int32_ops, m["hbm_bytes"] / hw.hbm_bw)
    r = roofline_report(code, spec, 1024, seconds=t_bound, device_kind=H100)
    assert r["roofline_frac"] == pytest.approx(1.0)
    assert r["bound"] in ("alu", "hbm")


def test_roofline_table_knows_h100_with_source():
    hw = device_spec(H100)
    assert hw.hbm_bw == pytest.approx(3.35e12)
    assert "data sheet" in hw.source
    assert set(PEAKS) == {H100}


def test_roofline_unknown_device_raises():
    with pytest.raises(ValueError, match="no published peaks"):
        device_spec("cpu")
    with pytest.raises(ValueError):
        roofline_report(load_code("576x288"), LayeredSpec(), 128, 1.0,
                        device_kind="Some Accelerator v9")


def test_bench_latency_row_cpu():
    """bench_latency measures a 128-frame call and reports the
    reference's latency fields (main.cpp/ARM (PERF) analogue)."""
    from ldpcgputegra.bench.suite import bench_latency

    r = bench_latency("576x288", iters=2, quick=True)
    assert r["batch"] == 128
    assert r["ms_per_call"] > 0
    assert r["us_per_frame"] == pytest.approx(
        r["ms_per_call"] * 1e3 / 128, rel=0.01
    )
    assert r["coded_mbps"] > 0
