"""Multi-host scale-out: `jax.distributed` initialization and host-aware
mesh construction.

The reference's only parallel axis is single-process multicore
(`/root/reference/packages/commitment/src/multicore.rs:22-146`); SURVEY
sections 5.8/7 map the scale-out axis onto `jax.distributed` + a device
mesh whose collectives ride the intra-host links within a host and the
network across hosts. This module is that mapping:

* :func:`initialize` -- one call per process, env-var driven (an explicit
  coordinator for CPU/GPU multi-process jobs).
* :func:`global_mesh_1d` -- the prover's 1-D domain-parallel mesh over
  every device in the job, ordered process-major so each host owns a
  contiguous chunk of the evaluation domain. With that layout the
  four-step NTT's all-to-all is the only stage whose traffic crosses hosts;
  the Merkle fold reduces locally to per-device subroots and only the
  (depth x 32-byte) top levels move between hosts, and the elementwise
  constraint kernels move nothing at all.
* :func:`host_local_mesh` -- the single-host fallback used by the tests
  and the driver dry run.
* :func:`put_global` -- build a globally-sharded array from host-local
  numpy data (each process contributes the shards it owns); this is the
  multi-process replacement for `jax.device_put(x, sharding)`.

The multi-host path is exercised by `scripts/multihost_dryrun.py`, which
spawns N real OS processes with CPU devices, initializes
`jax.distributed` with a local coordinator, and runs the sharded prover
core across them (`tests/test_multihost.py` asserts the roots match the
single-process run).
"""

from __future__ import annotations

import os

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    local_device_ids=None,
) -> None:
    """Initialize `jax.distributed` for this process.

    The explicit arguments (or JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES
    / JAX_PROCESS_ID) select the job shape. Safe to call once per process,
    before any other jax API touches the backend."""
    kwargs = {}
    if coordinator_address or os.environ.get("JAX_COORDINATOR_ADDRESS"):
        kwargs["coordinator_address"] = coordinator_address or os.environ.get(
            "JAX_COORDINATOR_ADDRESS"
        )
    if num_processes is not None or os.environ.get("JAX_NUM_PROCESSES"):
        kwargs["num_processes"] = (
            num_processes
            if num_processes is not None
            else int(os.environ["JAX_NUM_PROCESSES"])
        )
    if process_id is not None or os.environ.get("JAX_PROCESS_ID"):
        kwargs["process_id"] = (
            process_id if process_id is not None else int(os.environ["JAX_PROCESS_ID"])
        )
    if local_device_ids is not None:
        kwargs["local_device_ids"] = local_device_ids
    jax.distributed.initialize(**kwargs)


def global_mesh_1d(axis: str = "d", n_devices: int | None = None) -> Mesh:
    """1-D mesh over every device in the (possibly multi-host) job.

    `jax.devices()` orders devices process-major, so a contiguous
    domain-sharding maps each host to a contiguous slice of the evaluation
    domain -- the layout the module docstring's cross-host traffic analysis
    assumes."""
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (axis,))


def host_local_mesh(n_devices: int, axis: str = "d") -> Mesh:
    """Mesh over this process's first n addressable devices (single-host)."""
    devs = jax.local_devices()[:n_devices]
    assert len(devs) == n_devices, f"need {n_devices} local devices"
    return Mesh(np.array(devs), (axis,))


def put_global(arr: np.ndarray, mesh: Mesh, pspec: P):
    """Host-replicated numpy -> globally sharded device array.

    Works in multi-process jobs where plain `jax.device_put` cannot
    address other hosts' devices: each process places only the shards it
    owns. `arr` must hold the full global value on every process (the
    prover's traces are host-derived and identical everywhere)."""
    sharding = NamedSharding(mesh, pspec)
    return jax.make_array_from_callback(
        arr.shape, sharding, lambda idx: np.ascontiguousarray(arr[idx])
    )


def put_global_tree(tree, mesh: Mesh, pspec: P):
    """`put_global` over a pytree of arrays, one shared PartitionSpec."""
    return jax.tree_util.tree_map(
        lambda a: put_global(np.asarray(a), mesh, pspec), tree
    )
