"""Native topology kernel at 100k shapes: phase profile + part-count sweep.

CPU-only (FORCE_CPU).  Phase profile (DELPHY_TPU_TOPO_PROF=1) on one part
single-thread, then burst moves/s at several topology part counts.
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
    from delphy_tpu.topo.partition import (
        generate_random_partition_stencil, partition_tree)
    from delphy_tpu.topo.vsc import make_vsc_parts
    from delphy_tpu.topo.mixer import HostExpPop
    from delphy_tpu.topo.parallel import run_bursts_on_parts
    from delphy_tpu.native import run_burst_native
    from delphy_tpu.evo import hky_q

    tree = pickle.load(open("/tmp/tree100k_run.pkl", "rb"))
    rng = np.random.default_rng(7)
    q = np.asarray(hky_q(2.0, np.full(4, 0.25)))
    nu = np.ones(tree.num_sites)
    pi = np.full(4, 0.25)
    mu = 1e-3 / 365.0
    pop = HostExpPop(float(np.max(tree.t_max[:tree.num_tips])), 1000.0, 0.0,
                     1.0)
    t_root = float(tree.t[tree.root])
    t_max = float(np.max(tree.t_max[:tree.num_tips]))
    t_step = max((t_max - t_root), 1.0) * 1.35 / 400
    log(f"tree: {tree.num_tips} tips")

    # phase profile: one mid-size part, single thread, PROF on
    if os.environ.get("SKIP_PROF", "0") != "1":
        os.environ["DELPHY_TPU_TOPO_PROF"] = "1"
        stencil = generate_random_partition_stencil(tree.copy(), 250, rng)
        parts = partition_tree(tree.copy(), stencil)
        sizes = [p.tree.num_nodes for p in parts]
        mid = int(np.argsort(sizes)[len(sizes) // 2])
        p = parts[mid]
        rngs = [np.random.default_rng(1) for _ in parts]
        vscs = make_vsc_parts(parts, pop, rngs, t_step)
        log(f"profiling part {mid}: {p.tree.num_nodes} nodes, "
            f"{p.tree.num_mutations()} muts")
        tA = time.time()
        n_mv = 100_000
        res = run_burst_native(
            p.tree, n_mv, mu, nu, q, pi, pop, seed=123,
            can_change_root=p.includes_root,
            t_max_tip=float(np.max(p.tree.t_max[:p.tree.num_tips])),
            vsc=vscs[mid])
        dt = time.time() - tA
        log(f"single-part burst {n_mv}: {dt:.2f}s = {dt/n_mv*1e6:.1f} us/move"
            f" (res={None if res is None else res[2:]})")
        os.environ.pop("DELPHY_TPU_TOPO_PROF")

    # part-count sweep (4-thread pool)
    for P_topo in [int(x) for x in
                   os.environ.get("PART_COUNTS", "250,512,1024").split(",")]:
        tr = tree.copy()
        stencil = generate_random_partition_stencil(tr, P_topo, rng)
        parts = partition_tree(tr, stencil)
        sizes = np.array([p.tree.num_nodes for p in parts])
        n_mv = 1_000_000
        tA = time.time()
        dlg, acc, prop = run_bursts_on_parts(
            tr, parts, n_mv, pop, mu, nu, q, pi, rng,
            num_cells=400, parallel=True)
        dt = time.time() - tA
        log(f"P={P_topo} -> {len(parts)} parts (mean {sizes.mean():.0f} "
            f"max {sizes.max()} nodes): {n_mv} moves in {dt:.2f}s = "
            f"{n_mv/dt:,.0f} moves/s (acc {acc})")


if __name__ == "__main__":
    main()
