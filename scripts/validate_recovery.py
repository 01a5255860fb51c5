"""Statistical validation: posterior recovery of simulated truth.

Simulates a dataset with known clock rate / root time / kappa, runs the full
sampler, and reports posterior means vs truth (the in-repo stand-in for the
reference's BEAST cross-validation, whitepaper §5)."""

import os
import sys
import time

os.environ.setdefault("DELPHY_TPU_FORCE_CPU", os.environ.get("VAL_CPU", "1"))
sys.path.insert(0, "/root/repo")

import numpy as np

from delphy_tpu.sim import simulate_dataset
from delphy_tpu.init_tree import build_initial_tree
from delphy_tpu.run import Run


def main():
    T = int(os.environ.get("VAL_T", "24"))
    L = int(os.environ.get("VAL_L", "3000"))
    seed = int(os.environ.get("VAL_SEED", "101"))
    mu_true = 1e-2 / 365.0  # 1e-2 subs/site/year (informative regime)
    ref, deltas, miss, dates, names, truth = simulate_dataset(
        T, L, mu=mu_true, kappa=3.0, sample_window_days=400.0,
        coalescent_n0=150.0, missing_fraction=0.05, seed=seed)
    n_deltas = sum(len(d) for d in deltas)
    print(f"dataset: {T} tips x {L} sites, {n_deltas} tip deltas, seed {seed}")
    tree = build_initial_tree(ref, deltas, miss, dates, names=names,
                              rng=np.random.default_rng(seed))
    run = Run(tree, seed=seed, num_cells=256)

    burn_in = int(os.environ.get("VAL_BURN", "40000"))
    n_samples = int(os.environ.get("VAL_SAMPLES", "60"))
    thin = int(os.environ.get("VAL_THIN", "4000"))
    t0 = time.time()
    run.do_mcmc_steps(burn_in)
    mus, kappas, troots, muts = [], [], [], []
    for _ in range(n_samples):
        run.do_mcmc_steps(thin)
        mus.append(float(run.evo.mu))
        kappas.append(float(run.evo.kappa))
        troots.append(float(run.ts.t[run.ts.root]))
        muts.append(int(run.last_stats["num_muts"]))
    run.check_derived_quantities(1e-4)
    dt = time.time() - t0

    mus, kappas, troots = map(np.asarray, (mus, kappas, troots))
    from delphy_tpu.ess import ess
    print(f"samples: {n_samples} (thin {thin}) in {dt:.0f}s; "
          f"topo acc {run.topology_accepted}/{run.topology_proposed}")
    print(f"ESS: mu {ess(mus):.0f}, kappa {ess(kappas):.0f}, "
          f"t_root {ess(troots):.0f} (of {n_samples}); "
          f"ESS/hour(t_root) ~ {ess(troots) / (dt / 3600.0):.0f}")
    print(f"clock rate: true {mu_true * 365:.4f}/yr | "
          f"posterior {mus.mean() * 365:.4f} +- {mus.std() * 365:.4f}")
    print(f"kappa:      true {truth['kappa']:.2f}   | "
          f"posterior {kappas.mean():.2f} +- {kappas.std():.2f}")
    print(f"root time:  true {truth['root_time']:.1f} | "
          f"posterior {troots.mean():.1f} +- {troots.std():.1f}")
    print(f"num_muts:   {np.mean(muts):.0f} +- {np.std(muts):.0f}")

    ok = (abs(mus.mean() - mu_true) < 4 * max(mus.std(), 0.1 * mu_true)
          and abs(troots.mean() - truth["root_time"])
          < 5 * max(troots.std(), 10.0))
    print("RECOVERY:", "OK" if ok else "OFF")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
