"""Device profile of the partitioned local-move sweep (parallel/sweep.py
sweep_deltas) at f64, from one boundary's context, with n_blocks traced as
in production.

Shapes: the frozen Ebola set (81 x 18,959) and a 10k x 29,903 simulated
outbreak (BASELINE.json config 3).  For each: wall seconds per call, device
busy seconds and span from a jax.profiler trace, device microseconds per
attempted local move, and device events (kernels, device->host copies) per
block.  Needs a GPU; traces go under --out.

Usage: python scripts/sweep_prof.py [--out DIR]
"""

import argparse
import glob
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402


def device_busy(trace_dir):
    """(busy_ns, span_ns, n_events, n_memcpy) over the device stream lines
    of the newest trace; busy is the union of the event intervals."""
    import jax
    path = sorted(glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                            recursive=True))[-1]
    pd = jax.profiler.ProfileData.from_file(path)
    iv = []
    n_copy = 0
    for plane in pd.planes:
        if not plane.name.startswith("/device:"):
            continue
        for line in plane.lines:
            if "Stream" not in line.name:
                continue
            for e in line.events:
                iv.append((e.start_ns, e.start_ns + e.duration_ns))
                n_copy += "memcpy" in e.name.lower()
    if not iv:
        raise RuntimeError(f"no device events in {path}")
    iv.sort()
    busy, end = 0.0, -1.0
    for s, e in iv:
        if s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy, end - iv[0][0], len(iv), n_copy


TIPS, SITES = 10_000, 29_903     # BASELINE.json config 3
N_BLOCKS = 64


def boundary_context(run):
    """Global moves + per-part context up to the sweep (as _boundary_body)."""
    import jax
    import jax.numpy as jnp
    from delphy_tpu.mcmc.kernel import run_global_moves
    from delphy_tpu.parallel import vsc_device as vsc
    from delphy_tpu.parallel.sweep import build_part_ctx, SweepShared
    ts, evo, pop_params, grid, caches, ledger, key, stats = jax.jit(
        run_global_moves, static_argnames=("hyp", "num_cells"))(
        run.ts, run.evo, run.pop, run.key, run.tin, run.tout,
        run.t_max_tip, run.hyp, run.num_cells)
    pm = run.pm
    nm = jnp.maximum(pm.node_map, 0)
    t_p = ts.t[nm]
    k_p = jax.vmap(vsc.calc_k_bar_signed, in_axes=(0, 0, None, None, None))(
        t_p, pm.sign, grid.t_lo, grid.t_step, run.num_cells)
    active = vsc.active_cells(pm.part_t_lo, pm.part_t_hi, grid.t_lo,
                              grid.t_step, run.num_cells)
    key, k_fields, k_sweep, k_salt = jax.random.split(key, 4)
    fields = vsc.sample_fields(k_fields, k_p, active, grid.popsize_bar,
                               grid.t_step)
    ctx = build_part_ctx(pm, ts, caches, evo, fields.b, salt=jnp.int32(7))
    mut_t_p = ts.mut_t[jnp.maximum(pm.mut_map, 0)]
    keys = jax.vmap(jax.random.fold_in, in_axes=(None, 0))(k_sweep,
                                                          pm.part_id)
    sh = SweepShared(A=fields.A, popsize_bar=grid.popsize_bar,
                     t_lo=grid.t_lo, t_step=grid.t_step,
                     t_max_tip=jnp.asarray(run.t_max_tip, t_p.dtype))
    return pop_params, pm, ctx, sh, k_p, t_p, mut_t_p, keys


def profile(name, run, nb, out_dir):
    import jax
    import jax.numpy as jnp
    from delphy_tpu.parallel.sweep import sweep_deltas

    pop_params, pm, ctx, sh, k_p, t_p, mut_t_p, keys = boundary_context(run)
    k_max, rb = run._sweep_k_max, run._sweep_reform_batch

    @jax.jit
    def sweep(n_blocks, ctx, k_p, t_p, mut_t_p, keys, sh, pop_params, pm):
        return sweep_deltas(pm, ctx, k_p, t_p, mut_t_p, keys, sh, pop_params,
                            n_blocks, k_max, rb)

    args = (jnp.int32(nb), ctx, k_p, t_p, mut_t_p, keys, sh, pop_params, pm)
    tc = time.time()
    out = jax.block_until_ready(sweep(*args))
    compile_s = time.time() - tc
    reps = 3
    tw = time.time()
    for _ in range(reps):
        out = jax.block_until_ready(sweep(*args))
    wall = (time.time() - tw) / reps
    moves = int(out[4])
    tdir = os.path.join(out_dir, f"trace_{name}")
    with jax.profiler.trace(tdir):
        jax.block_until_ready(sweep(*args))
    busy_ns, span_ns, n_ev, n_copy = device_busy(tdir)
    row = dict(P=int(pm.node_map.shape[0]), n_cap=int(t_p.shape[1]),
               m_cap=int(mut_t_p.shape[1]), blocks=nb,
               compile_s=compile_s, wall_s=wall, moves=moves,
               device_busy_s=busy_ns * 1e-9, device_span_s=span_ns * 1e-9,
               us_per_move_device=busy_ns * 1e-3 / max(moves, 1),
               us_per_move_wall=wall * 1e6 / max(moves, 1),
               events_per_block=n_ev / nb, d2h_copies_per_block=n_copy / nb)
    print(f"[{name}] {json.dumps(row)}", flush=True)
    return row


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="chiprun_out/sweep_prof")
    args = ap.parse_args()
    import jax
    if jax.default_backend() != "gpu":
        sys.exit("sweep_prof.py: needs a GPU")
    from delphy_tpu.io.maple import read_maple
    from delphy_tpu.init_tree import build_initial_tree
    from delphy_tpu.run import Run
    from delphy_tpu.sim import simulate_dataset

    d = jax.devices()[0]
    print(f"device: {d.platform} {d.device_kind} x{len(jax.devices())}",
          flush=True)
    os.makedirs(args.out, exist_ok=True)
    res = {}
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    mf = read_maple(os.path.join(root, "data",
                                 "ebola2014_like_81x18959.maple"))
    tips = mf.tips
    tree = build_initial_tree(mf.ref_seq, [t.deltas for t in tips],
                              [t.miss_intervals for t in tips],
                              [(t.t_min, t.t_max) for t in tips],
                              names=[t.name for t in tips],
                              rng=np.random.default_rng(42))
    run = Run(tree, seed=1, num_cells=400, topology_moves_enabled=False)
    res["ebola"] = profile("ebola", run, N_BLOCKS, args.out)

    ref, deltas, miss, dates, names, _ = simulate_dataset(
        TIPS, SITES, mu=1.0e-3 / 365, sample_window_days=1200.0,
        missing_fraction=0.02, seed=77)
    tree = build_initial_tree(ref, deltas, miss, dates, names=names,
                              rng=np.random.default_rng(77))
    run = Run(tree, seed=7, num_cells=400, topology_moves_enabled=False)
    res[f"{TIPS}"] = profile(f"{TIPS}", run, N_BLOCKS, args.out)
    print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
