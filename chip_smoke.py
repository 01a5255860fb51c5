#!/usr/bin/env python
"""Bring-up check of the MCMC main path on one GPU, in one process.

Phases (each prints one line of facts; any failure exits non-zero):
  1. device     the default backend is a GPU; card name and power limit
  2. cli        `delphy_tpu.cli.main` on the frozen Ebola set (81 x 18,959):
                rc 0, finite .log posteriors, .trees read back
  3. run        Run on Ebola for >= 4 boundaries; ledger recompute at 1e-6,
                tree integrity, both native C++ kernels loaded
  4. gpu_vs_cpu one partitioned boundary from the same state and key on the
                GPU and on the CPU backend: equal counts, times to 1e-6 days,
                log_G to 1e-9 relative
  5. scale      partitioned run at 10,000 x 29,903 (BASELINE.json config 3),
                >= 2 dispatches with host bursts; ledger at 1e-6
  6. determinism two identical Ebola runs; reports whether the log-posterior
                trajectories are bit-identical (reports, does not fail)

`--devices 4` runs only the mesh phase: the scale run sharded over a
("part",) mesh of four cards against the same run on card 0.

The last line of stdout is one JSON object:
  {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}

Usage:  python chip_smoke.py [--devices 4]
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
EBOLA = os.path.join(HERE, "data", "ebola2014_like_81x18959.maple")
# the partitioned scale run (phases 5 and 7): BASELINE.json config 3
SCALE_TIPS, SCALE_SITES = 10_000, 29_903

# GPU vs CPU tolerances (phase 4): threefry draws the same bits on both
# backends, so only transcendental rounding and summation order differ —
# ~1e-13 relative on a |log_G| ~ 1e4..1e5, ~1e-10 days on node times.
TOL_LOG_G_REL = 1e-9
TOL_TIME_DAYS = 1e-6
# ledger recompute tolerance at f64 (the reference's, run.cpp:316-338)
TOL_LEDGER = 1e-6


class SmokeError(RuntimeError):
    pass


def check_device(min_devices: int = 1):
    """The default backend must be a GPU with >= min_devices devices."""
    import jax
    backend = jax.default_backend()
    devs = jax.devices()
    if backend != "gpu":
        raise SmokeError(f"no GPU: default backend is {backend!r}")
    if len(devs) < min_devices:
        raise SmokeError(f"need {min_devices} GPUs, found {len(devs)}")
    return devs


def card_info() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip()


def say(phase: str, **facts):
    print(f"phase {phase}: " + " ".join(f"{k}={v}" for k, v in facts.items()),
          flush=True)


def ebola_tree(seed: int = 42):
    from delphy_tpu.io.maple import read_maple
    from delphy_tpu.init_tree import build_initial_tree
    mf = read_maple(EBOLA)
    tips = mf.tips
    tree = build_initial_tree(mf.ref_seq, [t.deltas for t in tips],
                              [t.miss_intervals for t in tips],
                              [(t.t_min, t.t_max) for t in tips],
                              names=[t.name for t in tips],
                              rng=np.random.default_rng(seed))
    return mf, tree


def scale_tree():
    """scripts/scale_bench.py's outbreak: simulated, native init."""
    from delphy_tpu.sim import simulate_dataset
    from delphy_tpu.init_tree import build_initial_tree
    ref, deltas, miss, dates, names, _ = simulate_dataset(
        SCALE_TIPS, SCALE_SITES, mu=1.0e-3 / 365, sample_window_days=1200.0,
        missing_fraction=0.02, seed=77)
    return build_initial_tree(ref, deltas, miss, dates, names=names,
                              rng=np.random.default_rng(77))


class Counters:
    """Counts dispatched boundaries and topology bursts of every Run."""

    def __init__(self):
        import delphy_tpu.run as runmod
        self.mod = runmod
        self.boundaries = 0
        self.dispatches = 0
        self.bursts = 0
        self.log_G_first_burst = None   # ledger after the first dispatch
        self._step = runmod.parts_multi_super_step
        self._burst = runmod.Run._topology_burst

    def __enter__(self):
        def step(*a, **kw):
            # run.py passes n_boundaries positionally, 12th
            self.dispatches += 1
            self.boundaries += a[11]
            return self._step(*a, **kw)

        def burst(run, n):
            self.bursts += 1
            if self.log_G_first_burst is None:
                self.log_G_first_burst = float(run.ledger.log_G)
            return self._burst(run, n)
        self.mod.parts_multi_super_step = step
        self.mod.Run._topology_burst = burst
        return self

    def __exit__(self, *exc):
        self.mod.parts_multi_super_step = self._step
        self.mod.Run._topology_burst = self._burst


def phase_cli():
    from delphy_tpu import cli
    from delphy_tpu.io.maple import read_maple
    from delphy_tpu.io.newick import read_beast_trees
    mf = read_maple(EBOLA)
    lm = 50 * (2 * len(mf.tips) - 1)        # local moves per global boundary
    steps = 4 * lm
    with tempfile.TemporaryDirectory() as td:
        log_f, trees_f = os.path.join(td, "e.log"), os.path.join(td, "e.trees")
        t0 = time.time()
        with Counters() as c:
            rc = cli.main(["--v0-in-maple", EBOLA, "--v0-steps", str(steps),
                           "--v0-seed", "5", "--v0-log-every", str(2 * lm),
                           "--v0-tree-every", str(2 * lm),
                           "--v0-out-log-file", log_f,
                           "--v0-out-trees-file", trees_f])
        wall = time.time() - t0
        if rc != 0:
            raise SmokeError(f"cli rc={rc}")
        with open(log_f) as f:
            rows = [ln.rstrip("\n").split("\t") for ln in f if ln.strip()]
        head, body = rows[0], rows[1:]
        post = [float(r[head.index("posterior")]) for r in body]
        if len(body) < 2 or not all(math.isfinite(p) for p in post):
            raise SmokeError(f"cli .log: {len(body)} rows, posteriors {post}")
        trees = read_beast_trees(trees_f, mf.ref_seq)
        if len(trees) < 2 or any(t.num_tips != len(mf.tips)
                                 for _, t in trees):
            raise SmokeError(f"cli .trees: {len(trees)} trees read back")
    if c.boundaries < 2 or c.bursts < 1:
        raise SmokeError(f"cli ran {c.boundaries} boundaries, "
                         f"{c.bursts} bursts")
    say("2 cli", rc=rc, steps=steps, boundaries=c.boundaries,
        dispatches=c.dispatches, bursts=c.bursts, log_rows=len(body),
        trees=len(trees), last_posterior=post[-1], wall_s=round(wall, 3))


def phase_run(tree):
    from delphy_tpu.native import native_available
    from delphy_tpu.native.init_loader import native_init_available
    from delphy_tpu.run import Run
    if not native_available():
        raise SmokeError("native topology kernel did not load (g++?)")
    if not native_init_available():
        raise SmokeError("native init kernel did not load (g++?)")
    run = Run(tree, seed=1, num_cells=400)
    lm = run.local_moves_per_global_move
    t0 = time.time()
    with Counters() as c:
        run.do_mcmc_steps(4 * lm)
        first = run.local_moves_attempted
        compile_s = time.time() - t0
        times, moves = [], []
        for _ in range(3):
            a0, t1 = run.local_moves_attempted, time.time()
            run.do_mcmc_steps(4 * lm)
            moves.append(run.local_moves_attempted - a0)
            times.append(time.time() - t1)
    run.check_derived_quantities(TOL_LEDGER)
    run.tree().check_integrity()
    if c.boundaries < 4:
        raise SmokeError(f"run: only {c.boundaries} boundaries")
    steady = sum(times) / len(times)
    say("3 run", P=run.device_partitions, n_cap=run._n_cap_sticky,
        boundaries=c.boundaries, dispatches=c.dispatches, bursts=c.bursts,
        first_dispatch_s=round(compile_s, 3), first_moves=first,
        steady_s_per_dispatch=round(steady, 4),
        moves_per_s=round(sum(moves) / sum(times), 1),
        ledger_tol=TOL_LEDGER, native="topo+init")
    return run


def phase_gpu_vs_cpu(run):
    import jax
    from delphy_tpu.parallel.sweep import parts_multi_super_step
    cpu = jax.devices("cpu")[0]
    state = (run.ts, run.evo, run.pop, run.key, run.tin, run.tout, run.pm)
    n_blocks = 64
    static = (run.t_max_tip, run.hyp, run.num_cells, 1, run._sweep_k_max,
              run._sweep_reform_batch)

    def one(dev):
        args = jax.device_put(state, dev)
        with jax.default_device(dev):
            t0 = time.time()
            out = parts_multi_super_step(*args, n_blocks, *static)
            out = jax.device_get(out[:6])
            return out, time.time() - t0

    (ts_g, evo_g, pop_g, _, led_g, st_g), s_g = one(jax.devices()[0])
    (ts_c, evo_c, pop_c, _, led_c, st_c), s_c = one(cpu)
    t0_h = np.asarray(jax.device_get(run.ts.t))
    m0_h = np.asarray(jax.device_get(run.ts.mut_t))
    live = np.asarray(jax.device_get(run.ts.mut_node)) >= 0
    att_g = int(st_g["local_moves_attempted"])
    att_c = int(st_c["local_moves_attempted"])
    moved_g = (int(np.sum(ts_g.t != t0_h)),
               int(np.sum((ts_g.mut_t != m0_h) & live)))
    moved_c = (int(np.sum(ts_c.t != t0_h)),
               int(np.sum((ts_c.mut_t != m0_h) & live)))
    dt = float(np.max(np.abs(ts_g.t - ts_c.t)))
    dm = float(np.max(np.abs(np.where(live, ts_g.mut_t - ts_c.mut_t, 0.0))))
    lg_g, lg_c = float(led_g.log_G), float(led_c.log_G)
    rel = abs(lg_g - lg_c) / max(abs(lg_c), 1e-300)
    par = max(abs(float(a) - float(b)) / max(abs(float(b)), 1e-300)
              for a, b in ((evo_g.mu, evo_c.mu), (evo_g.kappa, evo_c.kappa),
                           (pop_g.n0, pop_c.n0)))
    say("4 gpu_vs_cpu", blocks=n_blocks, attempted=f"{att_g}/{att_c}",
        moved_nodes=f"{moved_g[0]}/{moved_c[0]}",
        moved_muts=f"{moved_g[1]}/{moved_c[1]}",
        max_dt_days=dt, max_dmut_days=dm, log_G_rel=rel, params_rel=par,
        gpu_s=round(s_g, 3), cpu_s=round(s_c, 3),
        tol=f"t<{TOL_TIME_DAYS},log_G<{TOL_LOG_G_REL}")
    if att_g != att_c or moved_g != moved_c:
        raise SmokeError(f"gpu/cpu counts differ: attempted {att_g}/{att_c}, "
                         f"moved {moved_g}/{moved_c} (an MH decision flipped)")
    if dt > TOL_TIME_DAYS or dm > TOL_TIME_DAYS:
        raise SmokeError(f"gpu/cpu times differ: {dt}, {dm} days")
    if rel > TOL_LOG_G_REL or par > TOL_LOG_G_REL:
        raise SmokeError(f"gpu/cpu log_G rel {rel}, params rel {par}")


def scale_run(tree, mesh=None):
    """Partitioned run: two dispatches (each followed by a host burst).
    Returns (run, facts); facts['log_G_first'] is the ledger right after
    the first dispatch, before its burst."""
    from delphy_tpu.run import Run
    t0 = time.time()
    run = Run(tree, seed=7, num_cells=400, mesh=mesh)
    init_s = time.time() - t0
    K = run.topology_burst_chunks
    lm = run.local_moves_per_global_move
    with Counters() as c:
        t1 = time.time()
        run.do_mcmc_steps(K * lm)
        a1 = run.local_moves_attempted
        first_s = time.time() - t1
        t2 = time.time()
        run.do_mcmc_steps(K * lm)
        a2 = run.local_moves_attempted - a1
        second_s = time.time() - t2
    run.check_derived_quantities(TOL_LEDGER)
    run.tree().check_integrity()
    if run.device_partitions <= 1 or c.dispatches < 2 or c.bursts < 1:
        raise SmokeError(f"scale: P={run.device_partitions} "
                         f"dispatches={c.dispatches} bursts={c.bursts}")
    return run, dict(P=run.device_partitions, n_cap=run._n_cap_sticky,
                     m_cap=run._m_cap_sticky, lm=lm, dispatches=c.dispatches,
                     boundaries=c.boundaries, bursts=c.bursts,
                     run_init_s=round(init_s, 3),
                     first_dispatch_s=round(first_s, 3),
                     second_dispatch_s=round(second_s, 3),
                     moves_per_s=round(a2 / second_s, 1),
                     log_G_first=c.log_G_first_burst)


def phase_scale():
    t0 = time.time()
    tree = scale_tree()
    data_s = time.time() - t0
    _, facts = scale_run(tree)
    say("5 scale", tips=SCALE_TIPS, sites=SCALE_SITES,
        data_init_s=round(data_s, 3), host_cores=os.cpu_count(),
        ledger_tol=TOL_LEDGER, **facts)


def phase_determinism(tree):
    from delphy_tpu.run import Run

    def trajectory():
        run = Run(tree, seed=3, num_cells=400)
        out = []
        for _ in range(4):
            run.do_mcmc_steps(run.local_moves_per_global_move)
            out.append(run.log_posterior)
        return out
    a, b = trajectory(), trajectory()
    first_diff = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                      None)
    say("6 determinism", bit_identical=a == b, first_diff=first_diff,
        max_abs_diff=max(abs(x - y) for x, y in zip(a, b)), samples=len(a))


def phase_mesh(n: int):
    import jax
    from jax.sharding import Mesh
    tree = scale_tree()
    mesh = Mesh(np.array(jax.devices()[:n]), ("part",))
    _, fm = scale_run(tree, mesh=mesh)
    _, f1 = scale_run(tree)
    rel = abs(fm["log_G_first"] - f1["log_G_first"]) / abs(f1["log_G_first"])
    say("7 mesh", devices=n, tips=SCALE_TIPS, log_G_rel=rel,
        mesh_moves_per_s=fm["moves_per_s"], one_moves_per_s=f1["moves_per_s"],
        mesh_first_s=fm["first_dispatch_s"], one_first_s=f1["first_dispatch_s"],
        P=fm["P"], n_cap=fm["n_cap"])
    if rel > TOL_LOG_G_REL:
        raise SmokeError(f"mesh vs single-card log_G rel {rel}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--devices", type=int, default=1,
                    help="> 1: run only the mesh phase over this many cards")
    args = ap.parse_args(argv)

    import delphy_tpu  # noqa: F401  (x64, compile cache)
    import jax
    devs = check_device(args.devices)
    say("1 device", platform=devs[0].platform,
        kinds=",".join(d.device_kind.replace(" ", "_") for d in devs),
        count=len(devs), x64=jax.config.x64_enabled,
        cache=jax.config.jax_compilation_cache_dir)
    print(card_info(), flush=True)

    if args.devices > 1:
        phase_mesh(args.devices)
    else:
        phase_cli()
        _, tree = ebola_tree()
        run = phase_run(tree)
        phase_gpu_vs_cpu(run)
        phase_scale()
        phase_determinism(tree)
    print(card_info(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)


if __name__ == "__main__":
    try:
        main()
    except SmokeError as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr, flush=True)
        sys.exit(1)
