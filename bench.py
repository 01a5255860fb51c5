#!/usr/bin/env python
"""Benchmark: MCMC local-move throughput on an Ebola-scale synthetic dataset.

Runs on one GPU (fails without one) at the default precision (f64), as a
user's CLI run does.  Prints the device (platform, kind, count) and the
card's name and power limit on stderr, then ONE JSON line
{"metric", "value", "unit", "vs_baseline", "device"} on stdout.
Baseline: reference delphy sustains ~0.5 M steps/s on the Ebola dataset
(81 seqs x 18,959 sites) on an AWS c5a.2xlarge (delphywp.pdf §5; BASELINE.md).

Usage: python bench.py   (BENCH_SECONDS sets the timed window, default 20)
"""

import json
import os
import subprocess
import sys
import time


def main():
    import numpy as np
    import jax
    from delphy_tpu.io.maple import read_maple
    from delphy_tpu.init_tree import build_initial_tree
    from delphy_tpu.run import Run

    if jax.default_backend() != "gpu":
        sys.exit(f"bench.py: no GPU (default backend "
                 f"{jax.default_backend()!r}); refusing to measure")
    devs = jax.devices()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    device = {"platform": devs[0].platform, "kind": devs[0].device_kind,
              "count": len(devs)}

    def note(msg):
        print(f"[bench +{time.time() - t_start:.1f}s] {msg}",
              file=sys.stderr, flush=True)

    t_start = time.time()
    note(f"device {device}; card {card.strip()}")
    # FROZEN Ebola-scale dataset (81 tips x 18,959 sites, Gire-2014-like
    # structured missingness; scripts/make_frozen_benchmark.py) parsed
    # through the production MAPLE input path — the same bytes every run.
    mf = read_maple(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                 "data", "ebola2014_like_81x18959.maple"))
    tips = mf.tips
    note(f"frozen dataset parsed ({len(tips)} tips x {len(mf.ref_seq)} sites)")
    tree = build_initial_tree(mf.ref_seq, [t.deltas for t in tips],
                              [t.miss_intervals for t in tips],
                              [(t.t_min, t.t_max) for t in tips],
                              names=[t.name for t in tips],
                              rng=np.random.default_rng(42))
    note("tree built")
    run = Run(tree, seed=1, num_cells=400)
    note(f"Run constructed (P={run.device_partitions})")

    target_seconds = float(os.environ.get("BENCH_SECONDS", "20"))
    # a whole multi-boundary dispatch per iteration (one host sync each)
    n = run.local_moves_per_global_move * run.topology_burst_chunks
    run.do_mcmc_steps(10)  # compile + warm the single-boundary path
    note("1-boundary warmup done")
    run.do_mcmc_steps(n)   # compile + warm the multi-boundary path
    note("multi-boundary warmup done")
    t0 = time.time()
    base = run.local_moves_attempted
    while time.time() - t0 < target_seconds:
        run.do_mcmc_steps(n)
        note("dispatch done")
    # drain in-flight dispatches INSIDE the timed window for exact accounting
    total = run.local_moves_attempted - base
    dt = time.time() - t0
    moves_per_s = total / dt

    # the ledger is re-derived in full at every global boundary; at f64 the
    # incremental value must match a recompute to the reference's 1e-6, and
    # DELPHY_TPU_F32=1 runs get the window-scaled f32 drift bound
    run.check_derived_quantities(
        0.05 if os.environ.get("DELPHY_TPU_F32") else 1e-6)

    baseline = 0.5e6  # reference Ebola steps/s on 8-vCPU c5a.2xlarge
    print(json.dumps({
        "metric": "mcmc_local_moves_per_second_ebola_scale",
        "value": round(moves_per_s, 1),
        "unit": "moves/s",
        "vs_baseline": round(moves_per_s / baseline, 4),
        "device": device,
    }), flush=True)


if __name__ == "__main__":
    main()
