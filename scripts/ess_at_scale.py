"""ESS/hour at scale.

Runs the production driver on a synthetic dataset of T tips for WINDOW
seconds, sampling the posterior trace every SAMPLE_EVERY dispatch, and
reports ESS + ESS/hour for log_posterior, mu and t_root
(initial-positive-sequence estimator, delphy_tpu/ess.py).

Env knobs:
  ESS_T        tips (default 1000)
  ESS_L        sites (default 29903)
  ESS_WINDOW   seconds of sampling (default 1800)
  ESS_CHUNKS   override topology_burst_chunks (0 = engine default) — the
               cadence-comparison lever (amortized vs interleaved bursts)
  ESS_SAMPLE_MOVES  moves between posterior samples (0 = one dispatch cycle,
               lmpgm * chunks).  Topology debt persists across calls
               (run.py), so the SAMPLING cadence no longer moves the BURST
               cadence — set this equal across ESS_CHUNKS settings for an
               apples-to-apples cadence comparison.  CAVEAT for overlapped
               rows: each do_mcmc_steps call is at least one overlap CYCLE,
               so a small ESS_SAMPLE_MOVES forces small cycles and their
               per-cycle fixed costs.  For a throughput-faithful
               overlapped row, set ESS_SAMPLE_MOVES to the driver's natural
               cycle (min(chunks, dispatch cap / lmpgm) boundaries) or
               accept that the row measures the forced shape.
  ESS_BURN_MOVES  local moves to burn before the sampling window (at large
               T the parsimony start drifts for ~1B+ moves; sampling a
               trending trace measures the trend, not mixing)
  ESS_STATE_NPZ  resume the run from a snapshot (io/snapshot.py) instead of
               building from the tree — lets cadence A/B windows start from
               the SAME burned state
  ESS_SAVE_NPZ  save a snapshot after burn (before the window), for reuse
Usage (GPU): python scripts/ess_at_scale.py
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
    from delphy_tpu.ess import ess

    T = int(os.environ.get("ESS_T", "1000"))
    L = int(os.environ.get("ESS_L", "29903"))
    window = float(os.environ.get("ESS_WINDOW", "1800"))
    chunks = int(os.environ.get("ESS_CHUNKS", "0"))

    t0 = time.time()
    state_npz = os.environ.get("ESS_STATE_NPZ", "")
    pkl = os.environ.get("ESS_TREE_PKL", "")
    if state_npz:  # resume a burned state (cadence A/B from the same point)
        from delphy_tpu.io.snapshot import load_run
        run = load_run(state_npz)
        T, L = run.ts.num_tips, run.ts.num_sites
        print(f"[ess +{time.time()-t0:.0f}s] state loaded ({T}x{L})",
              flush=True)
    else:
        if pkl:  # reuse a cached init tree (scripts/make_tree100k.py)
            import pickle
            tree = pickle.load(open(pkl, "rb"))
            T, L = tree.num_tips, tree.num_sites
            print(f"[ess +{time.time()-t0:.0f}s] tree loaded ({T}x{L})",
                  flush=True)
        else:
            ref, deltas, miss, dates, names, _ = simulate_dataset(
                T, L, mu=1.0e-3 / 365, sample_window_days=700.0,
                missing_fraction=0.02, seed=42)
            tree = build_initial_tree(ref, deltas, miss, dates, names=names,
                                      rng=np.random.default_rng(42))
            print(f"[ess +{time.time()-t0:.0f}s] tree built ({T}x{L})",
                  flush=True)
        run = Run(tree, seed=1, num_cells=400)
    if chunks > 0:
        run.topology_burst_chunks = chunks
    n = int(os.environ.get("ESS_SAMPLE_MOVES", "0")) or \
        run.local_moves_per_global_move * run.topology_burst_chunks
    run.do_mcmc_steps(n)  # warm/compile
    print(f"[ess +{time.time()-t0:.0f}s] warm "
          f"(chunks={run.topology_burst_chunks}, P={run.device_partitions})",
          flush=True)
    burn = int(os.environ.get("ESS_BURN_MOVES", "0"))
    if burn > 0:
        run.do_mcmc_steps(burn)
        print(f"[ess +{time.time()-t0:.0f}s] burn {burn} done "
              f"(log_post {run.log_posterior:.1f})", flush=True)
    save_npz = os.environ.get("ESS_SAVE_NPZ", "")
    if save_npz:
        from delphy_tpu.io.snapshot import save_run
        save_run(run, save_npz)
        print(f"[ess +{time.time()-t0:.0f}s] snapshot -> {save_npz}",
              flush=True)

    lp, mus, troots = [], [], []
    t_start = time.time()
    base = run.local_moves_attempted
    import jax
    while time.time() - t_start < window:
        run.do_mcmc_steps(n)
        lp.append(run.log_posterior)
        mus.append(float(jax.device_get(run.evo.mu)))
        troots.append(float(jax.device_get(run.ts.t[run.ts.root])))
    dt = time.time() - t_start
    moves = run.local_moves_attempted - base
    # f32 drift scales with the window; hold RELATIVE drift to 5e-7,
    # floored at the small-problem absolute tol
    run.check_derived_quantities(
        max(5e-2, 5e-7 * abs(float(run.ledger.log_G))))
    hours = dt / 3600.0
    out = {
        "T": T, "L": L, "window_s": round(dt, 1),
        "samples": len(lp),
        "moves": int(moves),
        "moves_per_s": round(moves / dt, 1),
        "topology_burst_chunks": run.topology_burst_chunks,
        "topology_proposed": int(run.topology_proposed),
        "ess_log_post": round(ess(np.array(lp)), 1),
        "ess_mu": round(ess(np.array(mus)), 1),
        "ess_t_root": round(ess(np.array(troots)), 1),
        "ess_per_hour_log_post": round(ess(np.array(lp)) / hours, 1),
        "ess_per_hour_mu": round(ess(np.array(mus)) / hours, 1),
        "ess_per_hour_t_root": round(ess(np.array(troots)) / hours, 1),
    }
    from delphy_tpu.ess import mcse
    out["sd_log_post"] = round(float(np.std(lp, ddof=1)), 3)
    out["mcse_log_post"] = round(mcse(np.array(lp)), 3)
    out["mcse_mu_rel"] = round(mcse(np.array(mus))
                               / max(abs(np.mean(mus)), 1e-300), 4)
    out["mcse_t_root"] = round(mcse(np.array(troots)), 2)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
