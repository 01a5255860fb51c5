"""Full-cycle 100k profile from the cached tree: sweep + burst breakdown.

Env: PART_CAP (DELPHY_TPU_PART_CAP), CYCLE_MEASURE_S (default 180),
CYCLE_VERBOSE=1 for burst stage timings, TREE_PKL path.
"""

import os
import pickle
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402,F401

import delphy_tpu  # noqa: F401,E402

t0 = time.time()


def log(m):
    print(f"[{time.time()-t0:7.1f}s] {m}", flush=True)


def main():
    from delphy_tpu.run import Run

    pkl = os.environ.get("TREE_PKL", "/tmp/tree100k_run.pkl")
    measure_s = float(os.environ.get("CYCLE_MEASURE_S", "180"))
    if os.environ.get("CYCLE_VERBOSE", "1") == "1":
        os.environ["DELPHY_TPU_BURST_VERBOSE"] = "1"
    tree = pickle.load(open(pkl, "rb"))
    log(f"tree loaded: {tree.num_tips} tips, {tree.num_mutations()} muts")

    run = Run(tree, seed=7, num_cells=400)
    if os.environ.get("CYCLE_CHUNKS", ""):
        run.topology_burst_chunks = int(os.environ["CYCLE_CHUNKS"])
    log(f"Run: P_padded={run.pm.node_map.shape[0]} n_cap={run._n_cap_sticky} "
        f"m_cap={run._m_cap_sticky} lmpgm={run.local_moves_per_global_move} "
        f"chunks={run.topology_burst_chunks}")
    cadence = run.local_moves_per_global_move
    # warm with ONE FULL outer call so every boundary-count variant the
    # measured loop will dispatch (e.g. the overlap driver's 3-boundary
    # steady cycle AND its remainder cycle) is compiled before the window,
    # not inside it
    warm = cadence * run.topology_burst_chunks
    if os.environ.get("CYCLE_WARM_SHORT", "0") == "1":
        warm = cadence * min(2, run.topology_burst_chunks)
    tW = time.time()
    run.do_mcmc_steps(warm)
    _ = run.local_moves_attempted
    log(f"warm done in {time.time()-tW:.1f}s")

    base = run.local_moves_attempted
    tA = time.time()
    sweep_t = 0.0
    cyc = 0
    while time.time() - tA < measure_s:
        tS = time.time()
        run.do_mcmc_steps(cadence * run.topology_burst_chunks)
        _ = run.local_moves_attempted
        sweep_t += time.time() - tS
        cyc += 1
    dt = time.time() - tA
    att = run.local_moves_attempted - base
    log(f"{att} attempted in {dt:.1f}s over {cyc} cycles = "
        f"{att/dt:,.0f} moves/s")
    log(f"topology: {run.topology_accepted}/{run.topology_proposed} accepted")
    log(run.stats_line())
    # f32 log_G drift grows with the window — hold the RELATIVE drift to
    # 5e-7, floored at the small-problem absolute tol
    tol = max(0.05, 5e-7 * abs(float(run.ledger.log_G)))
    run.check_derived_quantities(tol)
    log(f"ledger OK (tol {tol:.3f}); DONE")


if __name__ == "__main__":
    main()
