"""End-to-end moves/s at scale (BASELINE configs #3/#4).

Simulates T x L with structured missingness, runs the native init, then the
production driver for MEASURE_S seconds and reports moves/s + ledger check.

Env knobs:
  SCALE_T          tips (default 100000)
  SCALE_L          sites (default 29903)
  SCALE_MEASURE_S  measurement window seconds (default 300)
  SCALE_TOL        ledger tolerance (default 1e-6; 0.05 under DELPHY_TPU_F32)
Usage (GPU): python scripts/scale_bench.py
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

import delphy_tpu  # noqa: F401

t0 = time.time()


def log(m):
    print(f"[{time.time()-t0:7.1f}s] {m}", flush=True)


def main():
    from delphy_tpu.sim import simulate_dataset
    from delphy_tpu.init_tree import build_initial_tree
    from delphy_tpu.run import Run

    T = int(os.environ.get("SCALE_T", "100000"))
    L = int(os.environ.get("SCALE_L", "29903"))
    measure_s = float(os.environ.get("SCALE_MEASURE_S", "300"))
    tol = float(os.environ.get(
        "SCALE_TOL", "0.05" if os.environ.get("DELPHY_TPU_F32") else "1e-6"))

    ref, deltas, miss, dates, names, _ = simulate_dataset(
        T, L, mu=1.0e-3 / 365, sample_window_days=1200.0,
        missing_fraction=0.02, seed=77)
    log(f"dataset: {sum(len(d) for d in deltas)} deltas")
    tree = build_initial_tree(ref, deltas, miss, dates, names=names,
                              rng=np.random.default_rng(77))
    log(f"init tree: {tree.num_mutations()} muts")
    run = Run(tree, seed=7, num_cells=400)
    log(f"Run: P_padded={run.pm.node_map.shape[0]} n_cap={run._n_cap_sticky} "
        f"m_cap={run._m_cap_sticky} lmpgm={run.local_moves_per_global_move} "
        f"chunks={run.topology_burst_chunks}")
    warm = run.local_moves_per_global_move * min(2, run.topology_burst_chunks)
    run.do_mcmc_steps(warm)
    log("warm done")
    base = run.local_moves_attempted
    tA = time.time()
    while time.time() - tA < measure_s:
        run.do_mcmc_steps(
            run.local_moves_per_global_move * run.topology_burst_chunks)
    dt = time.time() - tA
    att = run.local_moves_attempted - base
    log(f"{att} attempted in {dt:.1f}s = {att/dt:,.0f} moves/s")
    log(run.stats_line())
    run.check_derived_quantities(tol)
    log(f"ledger OK (tol {tol}); DONE")


if __name__ == "__main__":
    main()
