"""Multi-host scaffolding: jax.distributed initialization + the global part
mesh.

The single-controller-per-host model: each host process initializes the
distributed runtime (coordinator rendezvous), after which jax.devices()
returns the GLOBAL device list and a ("part",) Mesh over it spans hosts.
The partitioned sweep's psum reassembly (sweep.py) then rides the in-host
device links and the network across hosts — the multi-host analogue of the
reference's single-host thread fan-out (run.cpp:622-693), which has no
cross-host story at all (SURVEY §2.3).

Environment contract (mirrors the standard JAX cluster variables):
  DELPHY_TPU_COORDINATOR   host:port of process 0 (required to enable)
  DELPHY_TPU_NUM_PROCESSES total process count
  DELPHY_TPU_PROCESS_ID    this process's rank
With DELPHY_TPU_DISTRIBUTED=1 and these unset, jax.distributed's automatic
cluster detection is used (on clusters that provide one).
"""

from __future__ import annotations

import os


def distributed_requested() -> bool:
    return bool(os.environ.get("DELPHY_TPU_COORDINATOR")
                or os.environ.get("DELPHY_TPU_DISTRIBUTED"))


def initialize_from_env() -> bool:
    """Initialize jax.distributed from the env contract above.  Returns True
    when the distributed runtime was started (idempotent: re-init is a
    no-op).  Must run before any other JAX call touches the backend."""
    if not distributed_requested():
        return False
    import jax

    coord = os.environ.get("DELPHY_TPU_COORDINATOR")
    nproc = os.environ.get("DELPHY_TPU_NUM_PROCESSES")
    pid = os.environ.get("DELPHY_TPU_PROCESS_ID")
    kwargs = {}
    if coord:
        kwargs["coordinator_address"] = coord
    if nproc is not None:
        kwargs["num_processes"] = int(nproc)
    if pid is not None:
        kwargs["process_id"] = int(pid)
    try:
        jax.distributed.initialize(**kwargs)
    except RuntimeError as e:  # already initialized
        if "already" not in str(e):
            raise
    return True


def mesh_spans_processes(mesh) -> bool:
    """True when the mesh's devices belong to more than one JAX process —
    the multi-host regime, where Run must build GLOBAL arrays."""
    return len({d.process_index for d in mesh.devices.flat}) > 1


def replicate_to_mesh(pytree, mesh):
    """device_put every array leaf of `pytree` fully replicated over the
    mesh (non-array leaves pass through).  Every process must supply
    identical values — the replicated-compute contract of the multi-host
    driver (each host runs the same deterministic host program, so no
    broadcast collective is needed)."""
    import jax
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P

    sh = NamedSharding(mesh, P())

    def place(x):
        if isinstance(x, (jax.Array, np.ndarray)):
            return jax.device_put(np.asarray(x), sh)
        return x

    return jax.tree.map(place, pytree)


def shard_parts_to_mesh(pm, mesh):
    """Build the partition maps as GLOBAL arrays sharded over the ("part",)
    axis from PROCESS-LOCAL rows: each process feeds only the part rows its
    addressable devices own (jax.make_array_from_process_local_data), so the
    part axis never ships whole across hosts.  `pm` is the host (numpy)
    PartMaps pytree with a leading P axis on every leaf."""
    import jax
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P

    sh = NamedSharding(mesh, P("part"))

    def place(a):
        a = np.ascontiguousarray(a)
        im = sh.addressable_devices_indices_map(a.shape)
        starts = [(sl[0].start or 0) for sl in im.values()]
        stops = [(sl[0].stop if sl[0].stop is not None else a.shape[0])
                 for sl in im.values()]
        local = a[min(starts):max(stops)]
        return jax.make_array_from_process_local_data(sh, local, a.shape)

    return jax.tree.map(place, pm)


def global_part_mesh(max_devices: int | None = None):
    """A ("part",) Mesh over the GLOBAL device list (all processes).  Device
    order is jax.devices() order, so processes agree on the assignment and
    the partition->device mapping is contiguous per host (part psums stay
    on the in-host links first, the network only at the host boundary)."""
    import numpy as np
    import jax
    from jax.sharding import Mesh

    devs = jax.devices()
    if max_devices is not None:
        devs = devs[:max_devices]
    return Mesh(np.array(devs), axis_names=("part",))
