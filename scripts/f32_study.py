#!/usr/bin/env python
"""f32-vs-f64 statistical validation.

DELPHY_TPU_F32=1 runs the hot path in single precision; the ledger
is re-derived from scratch at every global boundary, so incremental f32 error
cannot accumulate past one boundary window.  This study quantifies what f32
does to the SAMPLED DISTRIBUTION, which is the quantity that matters:

  * same dataset + seed, one chain per precision (a subprocess each — the
    precision switch is import-time);
  * compare posterior summaries (mean/sd of log-posterior, mu, t_root,
    mutation count) against each other and against the chains' own MC
    standard errors;
  * measure the worst within-window |log_G incremental - recompute| drift
    seen at any boundary, which is the basis for the bench invariant bound
    (cf. reference discipline run.cpp:316-338, tolerance 1e-6 in f64).

Usage: python scripts/f32_study.py [--steps 200000] [--tips 40] [--sites 1200]
Prints one JSON report; exits nonzero if the distributions disagree beyond
tolerance (5 sigma on any summary).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

_CHILD = """
import os, sys, json
import numpy as np
os.environ["DELPHY_TPU_FORCE_CPU"] = "1"
if os.environ.get("F32_STUDY_MODE") == "f32":
    os.environ["DELPHY_TPU_F32"] = "1"
else:
    os.environ.pop("DELPHY_TPU_F32", None)
import jax
jax.config.update("jax_platforms", "cpu")
from delphy_tpu.sim import simulate_dataset
from delphy_tpu.init_tree import build_initial_tree
from delphy_tpu.run import Run

cfg = json.loads(os.environ["F32_STUDY_CFG"])
T, L, steps, seed = cfg["tips"], cfg["sites"], cfg["steps"], cfg["seed"]
ref, deltas, miss, dates, names, _ = simulate_dataset(
    T, L, mu=1e-3, sample_window_days=400.0, missing_fraction=0.01, seed=7)
# Python pipeline with a pinned rng: the f32-vs-f64 comparison must pin the
# STARTING TREE, not the (evolving) production init policy — a different
# init puts these short chains in different metastable regions and the
# statistic then measures init policy, not numerics
tree = build_initial_tree(ref, deltas, miss, dates, names=names,
                          rng=np.random.default_rng(7), native=False)
run = Run(tree, seed=seed, num_cells=200,
          topology_moves_enabled=not os.environ.get("F32_STUDY_NO_TOPO"))
burn = steps // 5
chunk = max(run.local_moves_per_global_move, 2000)
run.do_mcmc_steps(burn)
trace = {"log_post": [], "mu": [], "t_root": [], "muts": []}
drift = 0.0
done = burn
while done < steps:
    run.do_mcmc_steps(chunk)
    done += chunk
    led = run.calc_cur_ledger()
    drift = max(drift, abs(float(run.ledger.log_G) - float(led.log_G)))
    trace["log_post"].append(float(run.ledger.log_posterior))
    trace["mu"].append(float(run.evo.mu) * 365.0)
    trace["t_root"].append(float(run.ts.t[run.ts.root]))
    trace["muts"].append(int(run.last_stats["num_muts"]))
print(json.dumps({"trace": trace, "max_drift": drift,
                  "log_G_mag": abs(float(run.ledger.log_G))}))
"""


def _ess_mean_se(x):
    """Mean and MC standard error with a crude autocorrelation-time factor."""
    import numpy as np
    x = np.asarray(x, dtype=np.float64)
    n = len(x)
    m = x.mean()
    v = x.var(ddof=1) if n > 1 else 0.0
    if v == 0.0 or n < 8:
        return m, max(np.sqrt(v / max(n, 1)), 1e-12)
    xc = x - m
    tau = 1.0
    for k in range(1, min(n // 4, 100)):
        rho = np.dot(xc[:-k], xc[k:]) / ((n - k) * v)
        if rho < 0.05:
            break
        tau += 2.0 * rho
    ess = max(n / tau, 2.0)
    return m, np.sqrt(v / ess)


def run_chain(mode, cfg):
    env = dict(os.environ, F32_STUDY_MODE=mode, F32_STUDY_CFG=json.dumps(cfg))
    env["PYTHONPATH"] = (os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
                         + os.pathsep + env.get("PYTHONPATH", ""))
    out = subprocess.run([sys.executable, "-c", _CHILD], env=env,
                         capture_output=True, text=True, timeout=3600)
    if out.returncode != 0:
        raise RuntimeError(f"{mode} chain failed:\n{out.stderr[-2000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def compare(a, b, cfg):
    report = {"config": cfg, "summaries": {}, "max_sigma": 0.0,
              "f32_max_within_window_drift": a["max_drift"],
              "f64_max_within_window_drift": b["max_drift"],
              "log_G_magnitude": a["log_G_mag"]}
    for k in a["trace"]:
        m1, se1 = _ess_mean_se(a["trace"][k])
        m2, se2 = _ess_mean_se(b["trace"][k])
        sigma = abs(m1 - m2) / max((se1 ** 2 + se2 ** 2) ** 0.5, 1e-12)
        report["summaries"][k] = {
            "f32_mean": m1, "f32_se": se1, "f64_mean": m2, "f64_se": se2,
            "sigma": sigma}
        report["max_sigma"] = max(report["max_sigma"], sigma)
    return report


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=200_000)
    p.add_argument("--tips", type=int, default=40)
    p.add_argument("--sites", type=int, default=1200)
    p.add_argument("--seed", type=int, default=3)
    args = p.parse_args()
    cfg = {"tips": args.tips, "sites": args.sites, "steps": args.steps,
           "seed": args.seed}
    f32 = run_chain("f32", cfg)
    f64 = run_chain("f64", cfg)
    report = compare(f32, f64, cfg)
    print(json.dumps(report, indent=2))
    if report["max_sigma"] > 5.0:
        sys.exit(1)


if __name__ == "__main__":
    main()
