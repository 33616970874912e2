"""Reductions from the tracing tree and `jax.profiler` traces to metrics.

`phase_walls` sums the host-clock phase spans of :mod:`stark_tpu.utils.
tracing`; `parse_device_trace` turns the Chrome trace that `jax.profiler`
writes into device-timeline numbers. Used by `bench.py`.
"""

from __future__ import annotations


def phase_walls(top_only: bool = True):
    """{phase_name: seconds} from the tracing tree.

    top_only sums only the root's direct children (the prover's phases);
    a parent phase's elapsed already contains its children, so flattening
    every level would double-count nested spans."""
    from stark_tpu.utils import tracing

    phases: dict = {}

    def walk(node):
        for c in node.children.values():
            phases[c.name] = phases.get(c.name, 0.0) + c.elapsed
            if not top_only:
                walk(c)

    walk(tracing._root)
    return phases


def _is_device_process(name: str) -> bool:
    """Accelerator planes of a `jax.profiler` trace are named
    "/device:GPU:<n>" (one process per card, one thread per stream); the
    host's are "/host:CPU" and the Python threads."""
    return name.startswith("/device:") and ":CPU" not in name


def _union_seconds(spans) -> float:
    """Total length of the union of (start_us, dur_us) intervals."""
    total, end = 0.0, None
    for ts, dur in sorted(spans):
        if end is None or ts >= end:
            total += dur
            end = ts + dur
        elif ts + dur > end:
            total += ts + dur - end
            end = ts + dur
    return total / 1e6


def parse_device_trace(outdir: str, phase_names=None):
    """Reduce the newest Chrome trace under `outdir` to device-timeline
    numbers: the device-busy time (union of the intervals in which any
    kernel runs on a device), the window from the first kernel's start to
    the last one's end, per-kernel totals, matmul kernel time, and -- when
    `phase_names` is given and the trace came from a STARK_TPU_SYNC_PHASES=1
    run -- per-phase device time, segmented at the `stark_phase_barrier`
    kernels the tracing barrier launches."""
    import glob
    import gzip
    import json

    paths = sorted(glob.glob(f"{outdir}/plugins/profile/*/*.trace.json.gz"))
    if not paths:
        return None
    with gzip.open(paths[-1]) as f:
        evs = json.load(f).get("traceEvents", [])
    pid_names = {
        e["pid"]: e.get("args", {}).get("name", "")
        for e in evs
        if e.get("ph") == "M" and e.get("name") == "process_name"
    }
    dev_pids = {p for p, n in pid_names.items() if _is_device_process(n)}
    kernels: dict = {}
    dot_us = 0.0
    spans = []
    barriers = []
    for e in evs:
        if e.get("ph") != "X" or e.get("pid") not in dev_pids:
            continue
        name = e.get("name", "?")
        ts, dur = float(e.get("ts", 0.0)), float(e.get("dur", 0.0))
        module = str(e.get("args", {}).get("hlo_module", ""))
        if "stark_phase_barrier" in name or "stark_phase_barrier" in module:
            barriers.append(ts + dur)
            continue
        k = name.split("(")[0][:60]
        kernels[k] = kernels.get(k, 0.0) + dur
        if "dot" in k or "gemm" in k.lower() or "matmul" in k.lower():
            dot_us += dur
        spans.append((ts, dur))
    if not spans:
        return {"device_busy_s": 0.0, "window_s": 0.0, "idle_share": None,
                "dot_kernel_s": 0.0, "top_kernels_ms": {}}
    busy = _union_seconds(spans)
    start = min(ts for ts, _ in spans)
    window = (max(ts + dur for ts, dur in spans) - start) / 1e6
    out = {
        "device_busy_s": round(busy, 6),
        "window_s": round(window, 6),
        "idle_share": round(1 - busy / window, 4) if window else None,
        "dot_kernel_s": round(dot_us / 1e6, 6),
        "top_kernels_ms": {
            k: round(v / 1e3, 3)
            for k, v in sorted(kernels.items(), key=lambda kv: -kv[1])[:12]
        },
    }
    if phase_names and barriers:
        barriers.sort()
        spans.sort()
        per = [0.0] * (len(barriers) + 1)
        bi = 0
        for ts, dur in spans:
            while bi < len(barriers) and ts >= barriers[bi]:
                bi += 1
            per[bi] += dur
        # one barrier fires at the END of each phase, in order
        dev_phases = {}
        for i, name in enumerate(phase_names[: len(barriers)]):
            dev_phases[name] = dev_phases.get(name, 0.0) + per[i] / 1e6
        if per[len(barriers)]:
            dev_phases["(after_last_barrier)"] = per[len(barriers)] / 1e6
        out["phase_device_s"] = {
            k: round(v, 6)
            for k, v in sorted(dev_phases.items(), key=lambda kv: -kv[1])
        }
    return out
