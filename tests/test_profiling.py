"""`parse_device_trace` on a small synthetic trace shaped like the Chrome
trace `jax.profiler` writes on a GPU: one process per card named
"/device:GPU:<n>" with a thread per stream, and host processes."""

import gzip
import json

import pytest

from stark_tpu.utils.profiling import parse_device_trace


def _write(tmp_path, events):
    d = tmp_path / "plugins" / "profile" / "2026_01_01_00_00_00"
    d.mkdir(parents=True)
    with gzip.open(d / "host.trace.json.gz", "wt") as f:
        json.dump({"traceEvents": events}, f)
    return str(tmp_path)


def _meta(pid, name):
    return {"ph": "M", "name": "process_name", "pid": pid, "args": {"name": name}}


def _x(pid, tid, name, ts, dur, module=None):
    e = {"ph": "X", "pid": pid, "tid": tid, "name": name, "ts": ts, "dur": dur}
    if module:
        e["args"] = {"hlo_module": module}
    return e


@pytest.fixture()
def trace(tmp_path):
    evs = [
        _meta(1, "/device:GPU:0"),
        _meta(2, "/host:CPU"),
        _meta(3, "python3"),
        # phase A: two overlapping kernels on two streams (union 0..150 us)
        _x(1, 10, "loop_multiply_fusion", 0, 100),
        _x(1, 11, "cutlass_gemm_f32", 50, 100),
        _x(1, 10, "loop_add_fusion", 200, 10, module="jit_stark_phase_barrier"),
        # phase B: one kernel after a 90 us gap
        _x(1, 10, "loop_multiply_fusion", 300, 200),
        _x(1, 10, "loop_add_fusion", 500, 10, module="jit_stark_phase_barrier"),
        # host work never counts as device time
        _x(2, 20, "PjitFunction(step)", 0, 5000),
        _x(3, 30, "loop_multiply_fusion", 0, 5000),
    ]
    return _write(tmp_path, evs)


def test_device_busy_is_union_of_gpu_kernels(trace):
    out = parse_device_trace(trace)
    assert out["device_busy_s"] == pytest.approx(350e-6)  # 150 + 200 us
    assert out["window_s"] == pytest.approx(500e-6)
    assert out["idle_share"] == pytest.approx(1 - 350 / 500)
    assert out["dot_kernel_s"] == pytest.approx(100e-6)
    assert out["top_kernels_ms"]["loop_multiply_fusion"] == pytest.approx(0.3)


def test_phase_split_at_barrier_kernels(trace):
    out = parse_device_trace(trace, ["columns", "commits"])
    assert out["phase_device_s"] == {
        "commits": pytest.approx(200e-6), "columns": pytest.approx(200e-6),
    }


def test_no_trace_returns_none(tmp_path):
    assert parse_device_trace(str(tmp_path)) is None
