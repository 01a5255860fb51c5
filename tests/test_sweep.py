"""Tests for the partitioned local-move sweep (parallel/sweep.py).

The sweep must keep the incremental ledger exact: the carried per-part
lineage staircase k_p equals a recompute from the new times, the summed dG
equals the global log_G recompute delta, and the augmented-coalescent dC
decomposes into partial-quad plus inner-node point terms."""

import numpy as np

import jax
import jax.numpy as jnp

from delphy_tpu.sim import simulate_dataset
from delphy_tpu.init_tree import build_initial_tree
from delphy_tpu.run import Run
from delphy_tpu.mcmc.kernel import run_global_moves
from delphy_tpu.ops import likelihood as lk
from delphy_tpu.mcmc import global_moves as gm
from delphy_tpu.parallel import vsc_device as vsc
from delphy_tpu.parallel.sweep import (build_part_ctx, SweepShared,
                                       scatter_deltas, part_sweep,
                                       sweep_deltas)


def _boundary_context(run):
    """Replicate _boundary_body's context construction up to the sweep."""
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
    key, k_fields, k_sweep = jax.random.split(key, 3)
    fields = vsc.sample_fields(k_fields, k_p, active, grid.popsize_bar,
                               grid.t_step)
    ctx = build_part_ctx(pm, ts, caches, evo, fields.b)
    mm = jnp.maximum(pm.mut_map, 0)
    mut_t_p = ts.mut_t[mm]
    sh = SweepShared(A=fields.A, popsize_bar=grid.popsize_bar,
                     t_lo=grid.t_lo, t_step=grid.t_step,
                     t_max_tip=jnp.asarray(run.t_max_tip, t_p.dtype))
    return ts, evo, pop_params, grid, caches, ledger, ctx, sh, k_p, t_p, \
        mut_t_p, k_sweep, pm


def _make_run(seed=23, P=4):
    ref, deltas, miss, dates, names, _ = simulate_dataset(
        20, 300, mu=1e-3, sample_window_days=300.0, missing_fraction=0.02,
        seed=seed)
    tree = build_initial_tree(ref, deltas, miss, dates, names=names,
                              rng=np.random.default_rng(seed))
    return Run(tree, seed=seed, num_cells=200, device_partitions=P,
               topology_moves_enabled=False)


def test_chain_ledger_and_kbar_exact():
    run = _make_run()
    (ts, evo, pop_params, grid, caches, ledger, ctx, sh, k_p, t_p, mut_t_p,
     k_sweep, pm) = _boundary_context(run)
    NB = 16
    k_max, rb = run._sweep_k_max, run._sweep_reform_batch
    keys = jax.vmap(jax.random.fold_in, in_axes=(None, 0))(k_sweep,
                                                          pm.part_id)
    args = (ctx, k_p, t_p, mut_t_p, keys, sh, pop_params, NB, k_max, rb)
    t_new, mut_new, kp_new, dG, dC, cnt = jax.jit(jax.vmap(
        part_sweep, in_axes=(0, 0, 0, 0, 0, None, None, None, None, None)),
        static_argnums=(8, 9))(*args)
    # sweep_deltas is the same sweep, returned as deltas and sums
    dt_p, dmut_p, dG_s, dC_s, cnt_s = jax.jit(
        sweep_deltas, static_argnums=(9, 10))(
        pm, ctx, k_p, t_p, mut_t_p, keys, sh, pop_params, NB, k_max, rb)
    np.testing.assert_array_equal(np.asarray(dt_p),
                                  np.asarray(t_new - t_p))
    np.testing.assert_array_equal(np.asarray(dmut_p),
                                  np.asarray(mut_new - mut_t_p))
    assert int(cnt_s) == int(jnp.sum(cnt))
    assert float(dG_s) == float(jnp.sum(dG))
    assert float(dC_s) == float(jnp.sum(dC))

    P, n_cap = t_p.shape
    assert int(jnp.sum(cnt)) > 50
    assert not np.allclose(np.asarray(t_new), np.asarray(t_p))
    assert np.all(np.isfinite(np.asarray(t_new)))

    # 1. carried k_p equals a fresh recompute from the new times
    kp_re = jax.vmap(vsc.calc_k_bar_signed, in_axes=(0, 0, None, None, None))(
        t_new, pm.sign, grid.t_lo, grid.t_step, run.num_cells)
    np.testing.assert_allclose(np.asarray(kp_new), np.asarray(kp_re),
                               atol=1e-8)

    # 2. sum dG equals the global log_G recompute delta
    dt, dmut = scatter_deltas(pm, ts.num_nodes, ts.mut_t.shape[0],
                              dt_p, dmut_p)
    ts2 = ts._replace(t=ts.t + dt, mut_t=ts.mut_t + dmut)
    caches2 = gm.compute_caches(ts2, evo)
    log_G_re = float(lk.calc_log_G(ts2, evo, caches2.lambda_i,
                                   caches2.root_freq))
    log_G_inc = float(ledger.log_G) + float(jnp.sum(dG))
    assert abs(log_G_inc - log_G_re) < 1e-6

    # 3. dC decomposes: partial-quad delta + inner-node -logN point terms
    b = ctx.b
    dquad = 0.0
    for p in range(P):
        dquad += float(vsc.partial_quad(kp_new[p], b[p], sh.A,
                                        sh.popsize_bar, sh.t_step)
                       - vsc.partial_quad(k_p[p], b[p], sh.A,
                                          sh.popsize_bar, sh.t_step))
    from delphy_tpu import pop as popm
    is_inner = np.asarray(ctx.children[:, :, 0] >= 0) & (
        np.arange(n_cap)[None, :] < np.asarray(ctx.n_nodes)[:, None])
    lN_old = np.asarray(jnp.log(popm.pop_at_time(pop_params, t_p)))
    lN_new = np.asarray(jnp.log(popm.pop_at_time(pop_params, t_new)))
    dpoint = -np.sum(np.where(is_inner, lN_new - lN_old, 0.0))
    assert abs(float(jnp.sum(dC)) - (dquad + dpoint)) < 1e-6

    # 4. mutation times stay within their branches
    for p in range(P):
        mn = np.asarray(ctx.mut_node_loc[p])
        mv = np.asarray(ctx.mut_valid[p])
        par = np.asarray(ctx.parent[p])
        tn = np.asarray(t_new[p])
        mt = np.asarray(mut_new[p])
        root = int(ctx.part_root[p])
        for j in np.nonzero(mv)[0]:
            n = mn[j]
            if n == root or par[n] < 0:
                continue
            assert tn[par[n]] < mt[j] <= tn[n] + 1e-9, (p, j, n)
