"""Tree-partition parallelism on the device (mesh) — the device re-design of the
reference's only execution parallelism (core/run.cpp:682-693: per-partition
Subrun::mcmc_sub_iteration farmed onto a thread pool, statistically decoupled
by core/very_scalable_coalescent.cpp).

  partmaps    host-side construction of static partition index maps
  vsc_device  jit kernels for the partition-decoupled (augmented) coalescent
  sweep       per-partition local-move sweeps, vmapped on one chip and
              shard_map'ed over a ("part",) mesh axis across chips
"""

from .partmaps import PartMaps, build_part_maps, auto_num_partitions  # noqa: F401
