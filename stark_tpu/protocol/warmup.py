"""Parallel compile warmup: overlap every XLA compile a prove will trigger.

Cold-starting a new circuit size pays one XLA compile per staged jit --
trace stages, the LDE engine, quotient/commit/linear-combination stages,
and ~4 kernels per FRI round at 7+ shrinking shapes -- and a first prove
triggers them strictly one at a time (each stage waits for the previous
stage's result). XLA compilation releases the GIL, so lowering + compiling
all of them from a thread pool overlaps the whole set; the executables land
in the in-process and persistent caches, which the prove then hits.

Usage:
    from stark_tpu.protocol.warmup import warmup_prover
    warmup_prover(spec, steps, precision, original_steps, n_pub)

or set STARK_TPU_WARMUP=1 to have the prover warm itself on first use of a
circuit size (prover stages only; the extra trace work is wasted when the
size is already compiled, so it is opt-in), or `python -m stark_tpu.cli
warmup circuit.r1cs` to precompile for a circuit file.

The reference has no counterpart (rustc compiles ahead of time); this is
the JIT equivalent of shipping prebuilt binaries.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp

from stark_tpu.fields.field import FieldSpec
from stark_tpu.protocol.params import SPOT_CHECK_SECURITY_FACTOR


def _fri_targets(spec: FieldSpec, precision: int, skips: int):
    """FRI round kernels for every shrinking shape the recursion visits
    (mirrors the loop in fri.prove_low_degree_pending)."""
    from stark_tpu.fri import fri
    from stark_tpu.merkle.tree import _gather_flat_j

    L = spec.num_limbs
    S = lambda sh, dt=jnp.uint32: jax.ShapeDtypeStruct(sh, dt)
    root8 = S((8,))
    t = []
    # the production FRI path: the ENTIRE recursion as one fused jit
    # (prove_low_degree_pending with a caller-committed first tree).
    # Without this target a cold first prove pays its full trace+compile
    # serially at the FRI phase.
    n_rounds = fri._n_rounds(precision // 4, fri.MIN_DEG_DIRECT_CHECKING)
    t.append(
        (
            fri._fri_chain_j,
            (
                spec, n_rounds, skips, "blake2s",
                S((L, precision)), S((L, precision)), S((16, precision)),
                # ALL tree layers incl. the (8, 1) root (the chain reads
                # layers[-1][:, 0]); _layer_avals stops above width 1
                _layer_avals(precision) + (S((8, 1)),),
            ),
        )
    )
    n, mdp = precision, precision // 4
    first = True
    while mdp > fri.MIN_DEG_DIRECT_CHECKING:
        quarter = n // 4
        if not first:
            # round 0 reuses the caller's l-tree; later value trees are the
            # previous round's column tree (already compiled at `n`)
            pass
        t.append((fri._commit_j, (spec, S((L, quarter)))))
        t.append((fri._sx_j, (spec, root8)))
        t.append((fri._ys_j, (root8, quarter, skips)))
        t.append((fri._fold_j, (spec, S((L, n)), S((L, n)), S((L, 1, 1)))))
        # branch gathers: value tree (leaf 16 words, width n, 4*40 queries)
        # and column tree (width quarter, 40 queries)
        t.append(
            (_gather_flat_j, (S((16, n)), _layer_avals(n), S((160,), jnp.int32)))
        )
        t.append(
            (_gather_flat_j,
             (S((16, quarter)), _layer_avals(quarter), S((40,), jnp.int32)))
        )
        n, mdp, first = quarter, mdp // 4, False
    return t


def _layer_avals(n: int):
    """Digest-layer avals as _gather_flat_j receives them (all but root)."""
    S = lambda sh: jax.ShapeDtypeStruct(sh, jnp.uint32)
    out = []
    while n > 1:
        out.append(S((8, n)))
        n //= 2
    return tuple(out)


def warmup_targets(
    spec: FieldSpec, steps: int, precision: int, original_steps: int,
    n_pub: int = 1, n_wires: int = 0,
):
    from stark_tpu.merkle.tree import _gather_flat_j
    from stark_tpu.protocol.prove import _stages_cached

    # the prover's exact positional call shape: lru_cache keys on the raw
    # argument tuple, and a mismatched arity would build (and hold) a
    # DUPLICATE stage set with its own multi-GB domain/plan tables
    stages = _stages_cached(
        spec, steps, precision, original_steps, None, "blake2s"
    )
    skips = precision // steps
    S = lambda sh, dt=jnp.uint32: jax.ShapeDtypeStruct(sh, dt)
    n_pos = SPOT_CHECK_SECURITY_FACTOR
    targets = list(stages["warm_targets"](n_pub, n_wires))
    # spot-check branch gathers: m-tree (256-byte leaves -> 64 words,
    # 4 companions per position; big domains use the streamed m-tree's
    # own m_gather_j, already in warm_targets) and l-tree (32-byte
    # leaves -> 16 words)
    if not stages.get("big"):
        targets.append(
            (_gather_flat_j,
             (S((64, precision)), _layer_avals(precision),
              S((4 * n_pos,), jnp.int32)))
        )
    targets.append(
        (_gather_flat_j,
         (S((16, precision)), _layer_avals(precision), S((n_pos,), jnp.int32)))
    )
    targets.extend(_fri_targets(spec, precision, skips))
    return targets


def warmup_prover(
    spec: FieldSpec, steps: int, precision: int, original_steps: int,
    n_pub: int = 1, threads: int | None = None, n_wires: int = 0,
) -> int:
    """Compile every prove-time executable for this circuit size in
    parallel. Returns the number of compiled targets. Idempotent and safe
    to race with a concurrent prove (jit compile caches are internally
    locked)."""
    targets = warmup_targets(
        spec, steps, precision, original_steps, n_pub, n_wires
    )
    if threads is None:
        threads = _default_threads()

    with ThreadPoolExecutor(max_workers=threads) as ex:
        list(ex.map(_compile_one, targets))
    return len(targets)


def _default_threads() -> int:
    """XLA compiles on the host's cores (releasing the GIL), so one thread
    per core; STARK_TPU_WARMUP_THREADS overrides."""
    return int(os.environ.get("STARK_TPU_WARMUP_THREADS", 0)) or min(
        16, os.cpu_count() or 1
    )


def _compile_one(ta):
    """One warmup target: lower + compile (persistent-cache hits skip the
    compile)."""
    fn, args = ta
    fn.lower(*args).compile()


_warmed: set = set()
_WARM_SALT = 2  # bump when kernel structure changes invalidate old markers


def _marker_path(key) -> str:
    """Completion marker in the persistent-cache dir: its presence means a
    warmup for this (size, backend, engine, jax version) finished once on
    this host, so the persistent compile cache holds every executable and
    auto-warmup can skip the (pure-overhead) re-tracing."""
    import hashlib

    from stark_tpu.utils import compile_cache

    cache = compile_cache.cache_dir()
    fingerprint = (
        key,
        jax.__version__,
        jax.default_backend(),
        _WARM_SALT,
        os.environ.get("STARK_TPU_MXU", "0"),
        os.environ.get("STARK_TPU_DEVICE_ARITH", "1"),
    )
    h = hashlib.sha1(repr(fingerprint).encode()).hexdigest()[:16]
    return os.path.join(cache, f"stark_warmed_{h}")


def maybe_warmup(
    spec, steps, precision, original_steps, n_pub, n_wires: int = 0
) -> None:
    """Auto-warmup hook for the prover.

    STARK_TPU_WARMUP modes:
      "auto" (default): on an accelerator backend, if this circuit size has
        no completion marker, compile ALL prover executables from a
        BACKGROUND daemon thread pool while the first prove proceeds --
        the prove's sequential stage compiles dedupe against the pool via
        jit's internal compile locking, so the cold first proof costs
        roughly the parallel-compile total instead of the serial sum.
        Skipped on the CPU backend (tests) and once the marker exists.
      "1": blocking foreground warmup (the old opt-in behavior).
      "0": off.
    """
    mode = os.environ.get("STARK_TPU_WARMUP", "auto")
    if mode == "0":
        return
    key = (spec, steps, precision, original_steps, n_pub, n_wires)
    if key in _warmed:
        return
    _warmed.add(key)

    if mode == "1":
        warmup_prover(
            spec, steps, precision, original_steps, n_pub, n_wires=n_wires
        )
        _write_marker(key)
        return

    if jax.default_backend() == "cpu":
        return
    mp = _marker_path(key)
    if os.path.exists(mp):
        return

    import threading

    def _bg():
        # daemon worker threads (ThreadPoolExecutor's atexit join would
        # keep a one-shot CLI process alive until the warmup finishes)
        import queue

        try:
            targets = warmup_targets(
                spec, steps, precision, original_steps, n_pub, n_wires
            )
            q: queue.Queue = queue.Queue()
            for t in targets:
                q.put(t)

            def worker():
                while True:
                    try:
                        ta = q.get_nowait()
                    except queue.Empty:
                        return
                    try:
                        _compile_one(ta)
                    except Exception:
                        pass

            n_threads = _default_threads()
            ths = [
                threading.Thread(target=worker, daemon=True)
                for _ in range(n_threads)
            ]
            for t in ths:
                t.start()
            for t in ths:
                t.join()
            _write_marker(key)
        except Exception:
            pass  # warmup is best-effort; the prove compiles what it needs

    threading.Thread(target=_bg, daemon=True, name="stark-warmup").start()


def _write_marker(key) -> None:
    try:
        mp = _marker_path(key)
        os.makedirs(os.path.dirname(mp), exist_ok=True)
        with open(mp, "w") as f:
            f.write("ok\n")
    except OSError:
        pass
