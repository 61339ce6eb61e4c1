"""Device-mesh construction and lattice shardings.

Replacement for the reference's MPI domain decomposition (SURVEY.md
2.5: 4D process grid `PEs`, halo width Nwing, rank-aware fields;
reference src/mpi/mpimodule.jl:10-38, mpirun.jl:14-25). The
lattice axes are sharded over a jax.sharding.Mesh with axis names
x/y/z/t; all field ops are written shift-based (jnp.roll), so under
jit the XLA SPMD partitioner inserts the halo collective-permutes
(NCCL over NVLink between the GPUs of a host) and turns global sums
into psums — no explicit send/recv anywhere. The Metropolis decision uses one
replicated PRNG key, matching the reference's rank-replicated rand()
(standardHMC.jl:81).

set_PEs/get_PEs mirror the reference's process-grid API
(mpimodule.jl:31-38).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

AXES = ("x", "y", "z", "t")

_PES: Tuple[int, int, int, int] = (1, 1, 1, 1)


def set_PEs(pes) -> None:
    global _PES
    pes = tuple(int(p) for p in pes)
    if len(pes) != 4:
        raise ValueError(f"PEs must have 4 entries, got {pes}")
    _PES = pes


def get_PEs() -> Tuple[int, int, int, int]:
    return _PES


def default_pes(n_devices: int) -> Tuple[int, int, int, int]:
    """Factor n_devices into a 4D grid, loading the t axis first (time
    is usually the longest lattice extent)."""
    pes = [1, 1, 1, 1]
    rem = n_devices
    for axis in (3, 2, 1, 0):
        f = 1
        for cand in range(rem, 0, -1):
            if rem % cand == 0:
                f = cand
                break
        pes[axis] = f
        rem //= f
        if rem == 1:
            break
    if int(np.prod(pes)) != n_devices:
        raise ValueError(f"cannot factor {n_devices} devices into a 4D grid")
    return tuple(pes)


def make_lattice_mesh(pes: Optional[Sequence[int]] = None, devices=None) -> Mesh:
    """Mesh over (up to) four lattice axes."""
    devices = jax.devices() if devices is None else devices
    if pes is None:
        pes = get_PEs() if int(np.prod(get_PEs())) == len(devices) else default_pes(len(devices))
    pes = tuple(int(p) for p in pes)
    if int(np.prod(pes)) != len(devices):
        raise ValueError(f"PEs {pes} does not match {len(devices)} devices")
    arr = np.asarray(devices).reshape(pes)
    return Mesh(arr, AXES)


def link_sharding(mesh: Mesh) -> NamedSharding:
    """U[mu, X, Y, Z, T, a, b] sharded over the lattice axes."""
    return NamedSharding(mesh, P(None, "x", "y", "z", "t", None, None))


def site_sharding(mesh: Mesh, trailing: int = 1) -> NamedSharding:
    """Site field (X, Y, Z, T, ...) with `trailing` local axes."""
    return NamedSharding(mesh, P("x", "y", "z", "t", *([None] * trailing)))


def spinor5_sharding(mesh: Mesh) -> NamedSharding:
    """Domain-wall field (L5, X, Y, Z, T, s, c): L5 stays local."""
    return NamedSharding(mesh, P(None, "x", "y", "z", "t", None, None))


def shard_links(u, mesh: Mesh):
    return jax.device_put(u, link_sharding(mesh))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


# ---------------------------------------------------------------------------
# Multi-host (multi-process) support — the mpirun.jl analog
# (reference src/mpirun.jl:14-25). One python process per host
# drives all of that host's GPUs; jax.distributed stitches the hosts'
# devices into one global device list, the Mesh spans them, and the
# jitted trajectory step runs SPMD with NCCL collectives (NVLink within
# a host, the cluster network across hosts).
# ---------------------------------------------------------------------------


def initialize_multihost(coordinator: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None) -> None:
    """Initialize the jax distributed runtime (idempotent).

    Pass coordinator="host:port", num_processes and process_id
    explicitly (the MPI_COMM_WORLD rank/size analog,
    mpi/mpimodule.jl:4-8). Called with none of them it stays a single
    process."""
    # NB: do not probe jax.process_count() here — it initializes the XLA
    # backend, after which jax.distributed.initialize refuses to run.
    try:
        from jax._src import distributed as _dist

        if getattr(_dist.global_state, "client", None) is not None:
            return  # already initialized
    except (ImportError, AttributeError):  # pragma: no cover - jax layout change
        pass
    kwargs = {}
    if coordinator is not None:
        kwargs["coordinator_address"] = coordinator
    if num_processes is not None:
        kwargs["num_processes"] = int(num_processes)
    if process_id is not None:
        kwargs["process_id"] = int(process_id)
    try:
        jax.distributed.initialize(**kwargs)
    except (ValueError, RuntimeError) as e:
        # single-process run (no explicit coordinator)
        if kwargs:
            raise
        import sys

        print(f"# jax.distributed not initialized ({e}); single process", file=sys.stderr)


def get_myrank() -> int:
    """Process index — the reference's get_myrank (mpimodule.jl:16-22)."""
    return jax.process_index()


def get_nprocs() -> int:
    """Process count — the reference's get_nprocs (mpimodule.jl:24-29)."""
    return jax.process_count()


def is_rank0() -> bool:
    return jax.process_index() == 0


def println_rank0(*vals) -> None:
    """Rank-0-gated print (mpi/simpleprint.jl:1-5)."""
    if is_rank0():
        print(*vals)


def to_host_global(x):
    """Materialize a (possibly cross-process sharded) array on every
    host as one numpy array. Single-process / fully-addressable arrays
    pass straight through to np.asarray; cross-host shardings are
    gathered with a collective (every process must call this)."""
    if getattr(x, "is_fully_addressable", True):
        return np.asarray(x)
    from jax.experimental import multihost_utils

    return np.asarray(multihost_utils.process_allgather(x, tiled=True))
