"""Measure the sharded path's overhead and scaling.

Drives the PRODUCTION driver (Run.do_mcmc_steps) over the same workload in
three modes and reports local-move throughput:
  vmap      mesh=None (single-device fan-out)
  mesh1     shard_map over a 1-device mesh (pure shard_map overhead)
  meshN     shard_map over all visible devices (scaling)

CPU: run under XLA_FLAGS=--xla_force_host_platform_device_count=8
JAX_PLATFORMS=cpu for the 8-virtual-device measurement (virtual devices
share the host's cores).  GPU: meshN spans all visible cards.
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

import delphy_tpu  # noqa: F401  (applies DELPHY_TPU_FORCE_CPU before any backend use)


def drive(mode, steps, T=757, L=29903, P_parts=8):
    import jax
    from jax.sharding import Mesh
    from delphy_tpu.sim import simulate_dataset
    from delphy_tpu.init_tree import build_initial_tree
    from delphy_tpu.run import Run

    ref, deltas, miss, dates, names, _ = simulate_dataset(
        T, L, mu=1.0e-3 / 365, sample_window_days=700.0,
        missing_fraction=0.02, seed=42)
    tree = build_initial_tree(ref, deltas, miss, dates, names=names,
                              rng=np.random.default_rng(42))
    devs = jax.devices()
    if mode == "vmap":
        mesh = None
    elif mode == "mesh1":
        mesh = Mesh(np.array(devs[:1]), axis_names=("part",))
    else:
        mesh = Mesh(np.array(devs), axis_names=("part",))
    run = Run(tree, seed=1, num_cells=400, device_partitions=P_parts,
              mesh=mesh)
    n = run.local_moves_per_global_move * run.topology_burst_chunks
    run.do_mcmc_steps(n)  # warm/compile
    t0 = time.time()
    base = run.local_moves_attempted
    while run.local_moves_attempted - base < steps:
        run.do_mcmc_steps(n)
    run.check_derived_quantities(5e-2 if os.environ.get("DELPHY_TPU_F32")
                                 else 1e-6)
    dt = time.time() - t0
    return (run.local_moves_attempted - base) / dt


def main():
    import jax
    modes = sys.argv[1].split(",") if len(sys.argv) > 1 else \
        ["vmap", "mesh1", "meshN"]
    steps = int(os.environ.get("MESH_SCALING_STEPS", "2000000"))
    T = int(os.environ.get("MESH_SCALING_T", "757"))
    L = int(os.environ.get("MESH_SCALING_L", "29903"))
    P_parts = int(os.environ.get("MESH_SCALING_P", "8"))
    print(f"platform={jax.default_backend()} devices={len(jax.devices())} "
          f"T={T} L={L} parts={P_parts}", flush=True)
    for mode in modes:
        mps = drive(mode, steps, T=T, L=L, P_parts=P_parts)
        print(f"{mode}: {mps / 1e6:.3f} M moves/s", flush=True)


if __name__ == "__main__":
    main()
