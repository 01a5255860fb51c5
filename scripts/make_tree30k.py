"""Build + cache a 30k-tip tree (the mid-scale cadence-crossover point)
the same way make_tree100k.py builds the 100k one."""

import os
import pickle
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
os.environ.setdefault("DELPHY_TPU_F32", "1")
os.environ.setdefault("DELPHY_TPU_FORCE_CPU", "1")

import numpy as np  # noqa: E402

t0 = time.time()


def log(m):
    print(f"[{time.time()-t0:7.1f}s] {m}", flush=True)


def main():
    from delphy_tpu.sim import simulate_dataset
    from delphy_tpu.init_tree import build_initial_tree

    T = int(os.environ.get("TREE_T", "30000"))
    L = int(os.environ.get("TREE_L", "29903"))
    out = os.environ.get("TREE_OUT", f"/tmp/tree{T//1000}k_run.pkl")
    ref, deltas, miss, dates, names, _ = simulate_dataset(
        T, L, mu=1.0e-3 / 365, sample_window_days=700.0,
        missing_fraction=0.02, seed=42)
    log(f"dataset simulated ({T}x{L})")
    tree = build_initial_tree(ref, deltas, miss, dates, names=names,
                              rng=np.random.default_rng(42))
    log(f"tree built: {tree.num_mutations()} muts")
    with open(out, "wb") as fh:
        pickle.dump(tree, fh)
    log(f"saved -> {out}")


if __name__ == "__main__":
    main()
