"""Measured comparison: blocking vs overlapped dispatch/burst driver.
SARS-scale by default (757 x 29,903); one process,
same dataset/tree, fresh Run per mode.

Env: OV_T (757), OV_L (29903), OV_SECONDS (45), OV_MODES ("0,1").
Usage (GPU): python scripts/overlap_bench.py
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

import delphy_tpu  # noqa: F401


def main():
    from delphy_tpu.sim import simulate_dataset
    from delphy_tpu.init_tree import build_initial_tree
    from delphy_tpu.run import Run

    T = int(os.environ.get("OV_T", "757"))
    L = int(os.environ.get("OV_L", "29903"))
    seconds = float(os.environ.get("OV_SECONDS", "45"))
    modes = os.environ.get("OV_MODES", "0,1").split(",")

    t0 = time.time()
    ref, deltas, miss, dates, names, _ = simulate_dataset(
        T, L, mu=1.0e-3 / 365, sample_window_days=700.0,
        missing_fraction=0.02, seed=3)
    tree = build_initial_tree(ref, deltas, miss, dates, names=names,
                              rng=np.random.default_rng(3))
    print(f"[ov +{time.time()-t0:.0f}s] tree built ({T}x{L})", flush=True)

    for mode in modes:
        os.environ["DELPHY_TPU_OVERLAP"] = mode
        run = Run(tree, seed=7, num_cells=400)
        n = run.local_moves_per_global_move * run.topology_burst_chunks
        run.do_mcmc_steps(n)   # warm/compile
        print(f"[ov +{time.time()-t0:.0f}s] warm mode={mode} "
              f"(P={run.device_partitions}, overlap={run._overlap_active()})",
              flush=True)
        base = run.local_moves_attempted
        tA = time.time()
        while time.time() - tA < seconds:
            run.do_mcmc_steps(n)
        dt = time.time() - tA
        att = run.local_moves_attempted - base
        run.check_derived_quantities(0.05)
        print(json.dumps({
            "overlap": mode, "T": T, "L": L,
            "moves_per_s": round(att / dt, 1),
            "window_s": round(dt, 1),
            "topo_proposed": int(run.topology_proposed),
            "ledger": "ok"}), flush=True)


if __name__ == "__main__":
    main()
