"""Command-line interface.

`python -m stark_tpu.cli <r1cs> <wtns> <proof.json>` mirrors the reference's
CLI (`/root/reference/packages/r1cs-stark/src/main.rs:4-11`: prove then
verify). Subcommands `prove`/`verify`/`run` expose the individual file-path
entry points (`run.rs:528-625`).
"""

from __future__ import annotations

import argparse
import os
import sys
import time


def _cache_archive(cmd: str, archive: str) -> int:
    """Pack/unpack the two on-disk caches that make cold start expensive:
    the persistent XLA compile cache (executables; backend-build keyed,
    `utils.compile_cache`) and the CRT NTT plan tables (backend-independent
    host math)."""
    import tarfile

    from stark_tpu.utils import compile_cache

    cache = compile_cache.cache_dir()
    plans = os.path.expanduser(
        os.environ.get("STARK_TPU_PLANS_CACHE", "~/.cache/stark_tpu_plans")
    )
    dirs = ((cache, "jax_stark"), (plans, "stark_tpu_plans"))
    if cmd == "cache-pack":
        n = 0
        # level 1: the payload is mostly already-compressed executables and
        # float tables; level 9 costs minutes of 1-vCPU time for ~5% size
        with tarfile.open(archive, "w:gz", compresslevel=1) as tf:
            for base, arc in dirs:
                if not os.path.isdir(base):
                    continue
                for name in sorted(os.listdir(base)):
                    tf.add(os.path.join(base, name), f"{arc}/{name}")
                    n += 1
        print(f"packed {n} cache entries -> {archive}")
        return 0
    with tarfile.open(archive, "r:gz") as tf:
        for member in tf.getmembers():
            top, _, rest = member.name.partition("/")
            if not rest or rest != os.path.basename(rest):
                continue  # refuse paths that escape the cache dirs
            dest = dict((arc, base) for base, arc in dirs).get(top)
            if dest is None or not member.isfile():
                continue
            os.makedirs(dest, exist_ok=True)
            src = tf.extractfile(member)
            with open(os.path.join(dest, rest), "wb") as out:
                out.write(src.read())
    print(f"restored cache entries from {archive}")
    return 0


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] in ("cache-pack", "cache-unpack") and len(argv) == 2:
        # pure tar work: no jax import, no global jax config mutation
        return _cache_archive(argv[0], argv[1])
    from stark_tpu.utils import compile_cache

    compile_cache.enable()
    from stark_tpu.protocol import runner

    if argv and argv[0] not in (
        "prove", "verify", "run", "warmup", "serve", "cache-pack",
        "cache-unpack",
    ):
        argv = ["run"] + argv  # bare 3-arg form, like `cargo run a b c`

    parser = argparse.ArgumentParser(prog="stark-tpu")
    sub = parser.add_subparsers(dest="cmd", required=True)
    for name in ("prove", "verify", "run"):
        sp = sub.add_parser(name)
        sp.add_argument("r1cs")
        sp.add_argument("wtns")
        sp.add_argument("proof_json")
        sp.add_argument(
            "--digest", choices=("blake2s", "poseidon"), default="blake2s",
            help="tree digest (the reference's H: Digest parameter); "
            "poseidon commits the l/FRI trees (see core.build_proof_stages)",
        )
    wp = sub.add_parser(
        "warmup",
        help="precompile every prover/verifier executable for a circuit "
        "(parallel; fills the persistent cache so the first prove is fast)",
    )
    wp.add_argument("r1cs")
    wp.add_argument("--threads", type=int, default=None)
    sub.add_parser(
        "serve",
        help="long-lived proving worker: line-delimited JSON-RPC on stdio "
        "(warm caches across calls; used by packages/node)",
    )
    cp = sub.add_parser(
        "cache-pack",
        help="tar the persistent XLA compile cache + NTT plan tables into "
        "one archive -- the JIT analogue of shipping prebuilt binaries "
        "(the Rust reference compiles AOT; XLA compiles JIT). Restore with "
        "cache-unpack on a host with the same backend build and checkout "
        "path for a zero-compile cold start.",
    )
    cp.add_argument("archive", help="output .tar.gz path")
    cu = sub.add_parser("cache-unpack")
    cu.add_argument("archive", help=".tar.gz from cache-pack")
    args = parser.parse_args(argv)

    if args.cmd in ("cache-pack", "cache-unpack"):
        return _cache_archive(args.cmd, args.archive)

    if args.cmd == "serve":
        from stark_tpu.serve import serve

        return serve()

    t0 = time.time()
    if args.cmd == "warmup":
        from stark_tpu.protocol.params import derive_params
        from stark_tpu.protocol.warmup import warmup_prover
        from stark_tpu.r1cs.arithmetize import arithmetize
        from stark_tpu.r1cs.reader import read_r1cs

        with open(args.r1cs, "rb") as f:
            r1cs = read_r1cs(f.read())
        spec = runner._spec_for(r1cs)
        h = r1cs.header
        n_pub = 1 + h.n_public_inputs + h.n_public_outputs
        arith = arithmetize(spec, r1cs.constraints, None, h.n_wires, n_pub)
        params = derive_params(spec, arith.original_steps)
        n = warmup_prover(
            spec,
            params.steps,
            params.precision,
            arith.original_steps,
            len(arith.public_first_indices),
            threads=args.threads,
            n_wires=(h.n_wires if runner._device_arith() else 0),
        )
        print(f"warmed {n} executables (steps={params.steps})")
    elif args.cmd == "prove":
        runner.prove_with_file_path(
            args.r1cs, args.wtns, args.proof_json, digest=args.digest
        )
    elif args.cmd == "verify":
        runner.verify_with_file_path(
            args.r1cs, args.wtns, args.proof_json, digest=args.digest
        )
        print("Done proof verification")
    else:
        runner.run_with_file_path(
            args.r1cs, args.wtns, args.proof_json, digest=args.digest
        )
        print("Done proof verification")
    print(f"{args.cmd}: {time.time() - t0:.3f}s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
