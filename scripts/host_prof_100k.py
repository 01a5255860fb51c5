"""Host-side phase costs at 100k (CPU only; the accelerator stays free).

Times the fixed host work a topology burst + restencil pays at 100k tips:
pack/unpack, stencil generation (best-of-6 + splitter), build_part_maps,
partition_tree, vsc build, native burst moves/s, reassemble, euler.
"""

import os
import pickle
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
os.environ["DELPHY_TPU_FORCE_CPU"] = "1"

import numpy as np  # noqa: E402

t0 = time.time()


def log(m):
    print(f"[{time.time()-t0:7.1f}s] {m}", flush=True)


def main():
    from delphy_tpu.state import pack_state, unpack_state
    from delphy_tpu.parallel.partmaps import build_part_maps, host_mut_nodes, \
        auto_num_partitions
    from delphy_tpu.topo.partition import (
        generate_random_partition_stencil, partition_tree, reassemble)
    from delphy_tpu.topo.vsc import make_vsc_parts
    from delphy_tpu.topo.mixer import HostExpPop
    from delphy_tpu.phylo import rereference_to_root_sequence

    tree = pickle.load(open("/tmp/tree100k_run.pkl", "rb"))
    rng = np.random.default_rng(7)
    N = tree.num_nodes
    log(f"tree: {tree.num_tips} tips, {N} nodes, {tree.num_mutations()} muts")

    # pack / unpack
    def _cap(n):
        return (2 * n + 256 + 127) // 128 * 128

    n_muts = tree.num_mutations() + len(tree.mutations[tree.root])
    mut_cap = _cap(n_muts)
    miss_cap = _cap(sum(len(iv) for iv in tree.miss_intervals))
    fs_cap = _cap(2 * sum(len(fs) for fs in tree.miss_from_states))
    tA = time.time()
    ts = pack_state(tree, mut_cap, miss_cap, fs_cap)
    log(f"pack_state: {time.time()-tA:.2f}s "
        f"(caps: mut {mut_cap}, miss {miss_cap}, fs {fs_cap})")
    tA = time.time()
    tree2 = unpack_state(ts, names=list(tree.name))
    log(f"unpack_state: {time.time()-tA:.2f}s")
    tA = time.time()
    rereference_to_root_sequence(tree2)
    log(f"rereference: {time.time()-tA:.2f}s")
    tA = time.time()
    tin, tout = tree.euler_positions()
    log(f"euler_positions: {time.time()-tA:.2f}s")

    # device-stencil build (what _repartition pays)
    P = auto_num_partitions(tree.num_tips)
    mn = host_mut_nodes(tree, mut_cap)
    tA = time.time()
    pm, cuts = build_part_maps(tree, mn, P, rng, return_cuts=True)
    log(f"build_part_maps (P={P} -> {pm.num_parts} parts, n_cap={pm.n_cap}, "
        f"m_cap={pm.m_cap}): {time.time()-tA:.2f}s")
    tA = time.time()
    stencil = generate_random_partition_stencil(tree, P, rng)
    log(f"one stencil alone: {time.time()-tA:.2f}s")

    # topology-burst partition path (separate stencil, ~500 parts)
    from delphy_tpu.run import Run
    P_topo = max(1, min(2 * (os.cpu_count() or 1), tree.num_tips // 10),
                 min(512, tree.num_tips // 400))
    tA = time.time()
    stencil_t = generate_random_partition_stencil(tree, P_topo, rng)
    parts = partition_tree(tree, stencil_t)
    log(f"topo partition_tree (P={P_topo} -> {len(parts)}): "
        f"{time.time()-tA:.2f}s")
    rngs = [np.random.default_rng(rng.integers(2**63)) for _ in parts]
    pop = HostExpPop(float(np.max(tree.t_max[:tree.num_tips])), 1000.0, 0.0,
                     1.0)
    t_root = float(tree.t[tree.root])
    t_max = float(np.max(tree.t_max[:tree.num_tips]))
    t_step = max((t_max - t_root), 1.0) * 1.35 / 400
    tA = time.time()
    vscs = make_vsc_parts(parts, pop, rngs, t_step)
    log(f"make_vsc_parts: {time.time()-tA:.2f}s")

    # native burst rate at this shape (thread pool)
    from delphy_tpu.topo.parallel import run_bursts_on_parts
    from delphy_tpu.evo import hky_q
    q = np.asarray(hky_q(2.0, np.full(4, 0.25)))
    nu = np.ones(tree.num_sites)
    for n_mv in (200_000, 1_000_000):
        tA = time.time()
        dlg, acc, prop = run_bursts_on_parts(
            tree, parts, n_mv, pop, 1e-3 / 365.0, nu, q, np.full(4, 0.25),
            rng, num_cells=400, parallel=True)
        dt = time.time() - tA
        log(f"native burst {n_mv} moves: {dt:.2f}s = {n_mv/dt:,.0f} moves/s "
            f"(acc {acc}/{prop})")
        # rebuild parts (the burst mutated them + reassembled)
        stencil_t = generate_random_partition_stencil(tree, P_topo, rng)
        parts = partition_tree(tree, stencil_t)
        rngs = [np.random.default_rng(rng.integers(2**63)) for _ in parts]
        vscs = make_vsc_parts(parts, pop, rngs, t_step)

    tA = time.time()
    reassemble(tree, parts)
    log(f"reassemble: {time.time()-tA:.2f}s")


if __name__ == "__main__":
    main()
