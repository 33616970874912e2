"""Structured per-phase timing + optional jax.profiler traces.

The reference instruments its hot phases with ad-hoc `Instant`/`println!`
timers (11 sites, e.g. `/root/reference/packages/fri/src/fft.rs:340-354`,
`commitment/src/merkle_proof_in_place.rs:115-187`,
`r1cs-stark/src/run.rs:364-372`). This module is the framework-grade
replacement: nested named phases collected into a report, opt-in via env:

  STARK_TPU_TRACE=1          print a phase report at the end of each top span
  STARK_TPU_PROFILE=<dir>    wrap top-level spans in jax.profiler.trace(dir)
  STARK_TPU_SYNC_PHASES=1    enqueue-and-block a dummy device op at every
                             phase exit. JAX dispatch is async, so without
                             this the report attributes almost all device
                             time to whichever phase blocks first (usually
                             `materialize`). A device runs one process's
                             computations on one compute stream in launch
                             order, so the dummy op completes only after
                             the phase's real work -- an effective
                             per-phase barrier. Diagnostic
                             only: the barriers defeat cross-phase
                             pipelining, so totals are a little worse than
                             production.

Usage::

    from stark_tpu.utils.tracing import phase, report
    with phase("prove"):
        with phase("lde"):
            ...
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass, field


@dataclass
class _Node:
    name: str
    elapsed: float = 0.0
    calls: int = 0
    children: dict = field(default_factory=dict)
    rss_end_kb: int = 0  # VmRSS at last exit (STARK_TPU_RSS=1 runs)
    rss_delta_kb: int = 0  # summed enter->exit VmRSS growth


def _vmrss_kb() -> int:
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1])
    except OSError:
        pass
    return 0


_root = _Node("root")
_stack = [_root]
_exit_log: list = []  # phase names in barrier order (SYNC_PHASES runs)


def enabled() -> bool:
    return os.environ.get("STARK_TPU_TRACE", "") not in ("", "0")


def _profile_dir() -> str | None:
    return os.environ.get("STARK_TPU_PROFILE") or None


@contextlib.contextmanager
def phase(name: str, sync=None):
    """Time a named phase (nested). `sync`: optional value passed to
    jax.block_until_ready before stopping the clock, so device work is
    attributed to the phase that launched it."""
    parent = _stack[-1]
    node = parent.children.get(name)
    if node is None:
        node = parent.children[name] = _Node(name)
    _stack.append(node)
    top = parent is _root
    prof = contextlib.nullcontext()
    if top and _profile_dir() is not None:
        import jax

        prof = jax.profiler.trace(_profile_dir())
    rss0 = _vmrss_kb() if os.environ.get("STARK_TPU_RSS") == "1" else None
    t0 = time.perf_counter()
    try:
        with prof:
            yield node
    finally:
        if sync is not None:
            import jax

            jax.block_until_ready(sync)
        elif os.environ.get("STARK_TPU_SYNC_PHASES", "") not in ("", "0"):
            _device_barrier()
            _exit_log.append(name)  # one barrier per exit, in device order
        node.elapsed += time.perf_counter() - t0
        node.calls += 1
        if rss0 is not None:
            node.rss_end_kb = _vmrss_kb()
            node.rss_delta_kb += node.rss_end_kb - rss0
        _stack.pop()
        if top and enabled():
            print(report(node))


_barrier_fn = None


def _device_barrier():
    """Block until all device work enqueued so far completes (see the
    STARK_TPU_SYNC_PHASES doc above for why this works). The barrier runs
    as a NAMED jit over a device input (so XLA cannot fold it to a
    constant and skip the launch); device-trace parsers use its kernel as
    a phase separator (`profiling.parse_device_trace`)."""
    global _barrier_fn
    import jax

    if _barrier_fn is None:
        import jax.numpy as jnp

        def stark_phase_barrier(x):
            return x + jnp.uint32(1)

        _barrier_fn = (jax.jit(stark_phase_barrier), jax.device_put(
            jnp.zeros((), jnp.uint32)
        ))
    fn, x = _barrier_fn
    jax.block_until_ready(fn(x))


def sync_point(value):
    """Block on device work inside a phase (explicit attribution point)."""
    import jax

    jax.block_until_ready(value)
    return value


def report(node: _Node | None = None, indent: int = 0) -> str:
    """Render the phase tree as an aligned text table."""
    if node is None:
        node = _root
        lines = []
    else:
        rss = (
            f"  rss {node.rss_end_kb / 1024:8.0f} MB ({node.rss_delta_kb / 1024:+.0f})"
            if node.rss_end_kb
            else ""
        )
        lines = [
            f"{'  ' * indent}{node.name:<{max(28 - 2 * indent, 1)}s}"
            f" {node.elapsed * 1e3:10.1f} ms  x{node.calls}{rss}"
        ]
    for child in node.children.values():
        lines.append(report(child, indent + 1))
    return "\n".join(lines)


def exit_log() -> list:
    """Phase names in the order their sync barriers fired (one each)."""
    return list(_exit_log)


def reset():
    global _root, _stack
    _root = _Node("root")
    _stack = [_root]
    _exit_log.clear()
