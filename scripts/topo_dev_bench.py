"""Measure the jitted missation-aware SPR1 sweep at production part shapes.

Production regime: parts of ~50-600 nodes, parsimony trees (few mutations
per branch), structured missingness.  Reports per-move wall time for the
scanned sweep, single-lane and vmapped over P lanes (the per-part fan-out
production would use).  Run on CPU (sanity) or the GPU
(python scripts/topo_dev_bench.py).
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

import delphy_tpu  # noqa: F401

import jax
import jax.numpy as jnp

from delphy_tpu.sim import simulate_dataset
from delphy_tpu.phylo import build_greedy_tree, rereference_to_root_sequence
from delphy_tpu.evo import make_evo_params
from delphy_tpu.ops import spr_miss as sm


def main():
    T = int(os.environ.get("TOPO_BENCH_T", "54"))
    L = int(os.environ.get("TOPO_BENCH_L", "29903"))
    P_LANES = int(os.environ.get("TOPO_BENCH_LANES", "8"))
    N_MOVES = int(os.environ.get("TOPO_BENCH_MOVES", "64"))
    MU = 1.0e-3 / 365
    f64 = not os.environ.get("DELPHY_TPU_F32")

    ref, deltas, miss, dates, names, _ = simulate_dataset(
        T, L, mu=MU, sample_window_days=700.0, missing_fraction=0.02,
        seed=3)
    tree = build_greedy_tree(ref, deltas, miss, dates, names=names,
                             rng=np.random.default_rng(3))
    rereference_to_root_sequence(tree)
    evo = make_evo_params(L, mu=MU, kappa=2.0)
    p = sm.pack_tree_miss(tree)
    q3 = np.asarray(evo.q_tab, dtype=np.float64).reshape(-1, 4, 4)
    qa_np = np.stack([-np.diag(q3[i]) for i in range(q3.shape[0])])
    part_np = np.asarray(evo.part)
    ref_np = np.asarray(tree.ref_seq)
    ft = jnp.float64 if f64 else jnp.float32
    lambda_ref = float(np.sum(MU * np.asarray(evo.nu)
                              * qa_np[part_np, ref_np]))
    ref_cum = np.concatenate([[0.0], np.cumsum(
        MU * np.asarray(evo.nu) * qa_np[part_np, ref_np])])
    c = dict(mu=jnp.asarray(MU, ft), nu=jnp.asarray(evo.nu, ft),
             qatab=jnp.asarray(qa_np.reshape(-1), ft),
             qtab=jnp.asarray(q3.reshape(-1), ft),
             part=jnp.asarray(part_np),
             ref_cum_Q=jnp.asarray(ref_cum, ft),
             ref_seq=jnp.asarray(ref_np.astype(np.int32)),
             lambda_ref=jnp.asarray(lambda_ref, ft))
    if not f64:
        p = jax.tree.map(
            lambda a: a.astype(jnp.float32)
            if hasattr(a, "dtype") and a.dtype == jnp.float64 else a, p)
    t_max_tip = float(np.max(np.asarray(tree.t_max)[:tree.num_tips]))
    WRB = 2 * p["rs"].shape[1] + 8
    WH_ = 2 * p["msite"].shape[1]
    print(f"N={tree.num_nodes} W={p['msite'].shape[1]} "
          f"WR={p['rs'].shape[1]} WRB={WRB} WH={WH_} L={L} "
          f"backend={jax.default_backend()}", flush=True)

    key = jax.random.PRNGKey(0)
    t0 = time.time()
    out = sm.spr1_sweep_miss(key, p, L, N_MOVES, c,
                             jnp.asarray(t_max_tip, ft), WRB=WRB, WH_=WH_)
    jax.block_until_ready(out[1])
    print(f"single-lane compile+run: {time.time()-t0:.1f}s", flush=True)
    t0 = time.time()
    reps = 3
    for _ in range(reps):
        out = sm.spr1_sweep_miss(key, out[0], L, N_MOVES, c,
                                 jnp.asarray(t_max_tip, ft), WRB=WRB,
                                 WH_=WH_)
        jax.block_until_ready(out[1])
    per_move = (time.time() - t0) / (reps * N_MOVES)
    print(f"single-lane: {per_move*1e6:.1f} us/move "
          f"(acc {int(out[1])}/{N_MOVES} perf {int(out[3])})", flush=True)

    # vmapped lanes (independent copies — production fans out real parts)
    pv = jax.tree.map(lambda a: jnp.stack([a] * P_LANES)
                      if hasattr(a, "ndim") else a, p)
    keys = jax.random.split(jax.random.PRNGKey(1), P_LANES)
    vsweep = jax.jit(jax.vmap(
        lambda k_, p_: sm.spr1_sweep_miss(k_, p_, L, N_MOVES, c,
                                          jnp.asarray(t_max_tip, ft),
                                          WRB=WRB, WH_=WH_)))
    t0 = time.time()
    outv = vsweep(keys, pv)
    jax.block_until_ready(outv[1])
    print(f"vmap x{P_LANES} compile+run: {time.time()-t0:.1f}s", flush=True)
    t0 = time.time()
    for _ in range(reps):
        outv = vsweep(keys, outv[0])
        jax.block_until_ready(outv[1])
    per_move_v = (time.time() - t0) / (reps * N_MOVES * P_LANES)
    print(f"vmap x{P_LANES}: {per_move_v*1e6:.1f} us/move amortized "
          f"(acc {np.asarray(outv[1]).sum()}/{N_MOVES*P_LANES})", flush=True)


if __name__ == "__main__":
    main()
