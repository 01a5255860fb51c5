"""The jitted MCMC super-step: one global-move boundary + a sweep of local moves.

Mirrors the cadence of Run::do_mcmc_steps (core/run.cpp:622-657): each call to
`super_step` performs a full derived-quantity recompute, the global parameter
moves, and `n_local_moves` sequential local moves, all inside one XLA program.
The host syncs once per super-step (default cadence: 50 local moves per node
per global move, run.cpp:669-671)."""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..state import TreeState
from ..evo import EvoParams
from .. import pop as popm
from ..ops import likelihood as lk
from ..ops import coalescent as coal
from . import moves
from .moves import Ledger, Caches
from . import global_moves as gm
from .global_moves import PriorConfig


def run_global_moves(ts: TreeState, evo: EvoParams, pop_params, key,
                     tin, tout, t_max_tip, hyp: PriorConfig, num_cells: int,
                     param_moves: bool = True):
    """Global moves + grid rebuild + ledger recompute (run.cpp:695-779).

    param_moves=False skips every parameter move but keeps the per-boundary
    grid rebuild + caches + full ledger recompute — the "locals-only"
    boundary used by the overlapped topology driver (run.py), where global
    parameter moves must not run concurrently with a host topology burst
    (the burst's MH reads the params the global moves would write)."""
    cnt, nucum = lk.calc_ref_state_prefix(ts, evo)
    root_freq = lk.calc_root_state_frequencies(ts, evo, cnt)
    num_muts = lk.calc_num_muts(ts)
    M_ab = lk.calc_num_muts_ab(ts)
    Ttwiddle_a = lk.calc_Ttwiddle_a(ts, evo, tin, tout, nucum)

    key, k_mu, k_hky, k_alpha, k_pop = jax.random.split(key, 5)

    if not param_moves:
        pass
    elif hyp.mpox_enabled:
        # 1 & 2. Gibbs sampling of mu & mu_star under the 2-partition APOBEC
        # model (run.cpp:720-724, 823-952)
        M_beta_ab = lk.calc_num_muts_beta_ab(ts, evo)
        nu_prefix_pa = lk.calc_ref_state_prefix_beta(ts, evo)
        Ttwiddle_beta_a = lk.calc_Ttwiddle_beta_a(ts, evo, tin, tout,
                                                  nu_prefix_pa)
        evo = gm.mpox_hack_moves(k_mu, evo, M_beta_ab, num_muts,
                                 Ttwiddle_beta_a, hyp)
    else:
        # 1. Gibbs sampling of mu (run.cpp:704-709)
        if hyp.mu_move_enabled and not hyp.mu_fixed:
            evo = gm.mu_gibbs_move(k_mu, evo, Ttwiddle_a, num_muts, hyp)

        # 2. 10x pseudo-Gibbs HKY frequency + kappa moves (run.cpp:714-719)
        if hyp.hky_moves_enabled:
            evo = hky_moves(k_hky, evo, Ttwiddle_a, M_ab, root_freq, hyp)

    # 3. alpha moves + Gibbs of all nu_l (run.cpp:729-732)
    if param_moves and hyp.alpha_move_enabled:
        Ttwiddle_l = lk.calc_Ttwiddle_l(ts, evo, tin, tout)
        M_l = lk.calc_num_muts_l(ts)
        evo = gm.alpha_and_nu_moves(k_alpha, evo, Ttwiddle_l, M_l, hyp)

    # 4-pre. Rebuild the coalescent grid around the current tree span
    # (replaces the reference's t_step retarget + deque growth,
    # run.cpp:734-747 + scalable_coalescent.cpp:48-86)
    t_root = ts.t[ts.root]
    span = jnp.maximum(t_max_tip - t_root, 1.0)
    t_lo = t_root - 0.35 * span - 1.0
    t_step = (t_max_tip - t_lo) / num_cells
    is_tip = ts.is_tip
    grid = coal.make_grid(pop_params, ts.t, is_tip, t_lo, t_step, num_cells)

    # 4. Pseudo-Gibbs sampling of population parameters (run.cpp:749-778)
    if not param_moves:
        pass
    elif isinstance(pop_params, popm.ExpPopParams) and (
            hyp.pop_size_move_enabled or hyp.pop_growth_rate_move_enabled):
        pop_params = gm.exp_pop_moves(k_pop, pop_params, grid, ts.t, is_tip, hyp)
        grid = grid._replace(
            popsize_bar=coal.calc_popsize_bars(pop_params, grid.t_lo, grid.t_step,
                                               num_cells))
    elif isinstance(pop_params, popm.SkygridPopParams):
        k_tau, k_zero, k_hmc = jax.random.split(k_pop, 3)
        if hyp.skygrid_tau_move_enabled:
            pop_params = gm.skygrid_tau_move(k_tau, pop_params, hyp)
        n_inner = ts.num_nodes - ts.num_tips
        pop_params = gm.skygrid_zero_mode_gibbs_move(k_zero, pop_params, grid,
                                                     n_inner, hyp)
        # zero-mode shifts all gammas; refresh popsize_bars before the HMC's
        # B-term baseline and the sweep
        grid = grid._replace(
            popsize_bar=coal.calc_popsize_bars(pop_params, grid.t_lo, grid.t_step,
                                               num_cells))
        pop_params = gm.skygrid_hmc_move(k_hmc, pop_params, grid, ts.t, is_tip, hyp)
        grid = grid._replace(
            popsize_bar=coal.calc_popsize_bars(pop_params, grid.t_lo, grid.t_step,
                                               num_cells))

    # Final ledger: full recompute under the accepted parameters
    caches = gm.compute_caches(ts, evo)
    log_G = lk.calc_log_G(ts, evo, caches.lambda_i, caches.root_freq)
    log_coal = coal.calc_log_prior(grid, pop_params, ts.t, is_tip)
    log_other = gm.calc_log_other_priors(evo, pop_params, hyp)
    ledger = Ledger(log_G=log_G, log_coal=log_coal, log_other=log_other)

    stats = {
        "num_muts": num_muts,
        "M_ab": M_ab,
        "Ttwiddle_a": Ttwiddle_a,
    }
    return ts, evo, pop_params, grid, caches, ledger, key, stats


def hky_moves(key, evo: EvoParams, Ttwiddle_a, M_ab, root_freq,
              hyp: PriorConfig, n_rounds: int = 10):
    """n_rounds x (HKY frequency move, kappa move), each round on its own
    3-way split of the key (run.cpp:714-719)."""
    def body(i, carry):
        evo, key = carry
        key, kf, kk = jax.random.split(key, 3)
        evo = gm.hky_frequencies_move(kf, evo, Ttwiddle_a, M_ab, root_freq)
        evo = gm.hky_kappa_move(kk, evo, Ttwiddle_a, M_ab, hyp)
        return (evo, key)
    evo, _ = jax.lax.fori_loop(0, n_rounds, body, (evo, key))
    return evo


REFORM_BATCH = 48
SEQ_DISP_PER_BLOCK = 2


def run_local_sweep(ts: TreeState, caches: Caches, grid, ledger, evo, pop_params,
                    key, n_moves, t_max_tip):
    """Local moves, restructured for a data-parallel device.

    Per block:
      - SEQ_DISP_PER_BLOCK sequential single-node displacements (cover the
        root and wide-window nodes the coloring can't batch);
      - one cell-block-colored batched displacement of up to k_max nodes
        (exactly factorized accepts; moves.batched_node_displace);
      - one batched branch reform of REFORM_BATCH branches.

    This is the reference's move set (subrun.cpp:98-121) with the
    thread-level concurrency of its partition scheme replaced by exact
    SIMD-width concurrency.  Returns the actual number of attempted
    move-equivalents (a traced scalar) for honest throughput accounting."""
    B = REFORM_BATCH
    C = grid.num_cells
    k_max = max(8, C // 2)

    def disp_body(j, carry):
        ts, grid, ledger, key = carry
        key, k_sel, k_node, k_prop, k_acc = jax.random.split(key, 5)
        r = jax.random.uniform(k_sel, (), jnp.float64, 0.0, 1.0)
        keys = (k_node, k_prop, k_acc)
        c4 = (ts, caches, grid, ledger)
        c4 = jax.lax.cond(
            r < 0.5,
            lambda c: moves.inner_node_displace(c, keys, pop_params, t_max_tip),
            lambda c: moves.tip_displace(c, keys, pop_params, t_max_tip),
            c4)
        ts, _, grid, ledger = c4
        return (ts, grid, ledger, key)

    def block_body(i, carry):
        ts, grid, ledger, key, count = carry
        ts, grid, ledger, key = jax.lax.fori_loop(
            0, SEQ_DISP_PER_BLOCK, disp_body, (ts, grid, ledger, key))
        key, k_disp, k_reform = jax.random.split(key, 3)
        ts, grid, ledger, n_att = moves.batched_node_displace(
            ts, caches, grid, ledger, pop_params, k_disp, t_max_tip, k_max)
        ts, ledger = moves.batched_branch_reform(ts, ledger, evo, k_reform, B)
        count = count + SEQ_DISP_PER_BLOCK + n_att + B
        return (ts, grid, ledger, key, count)

    nominal = SEQ_DISP_PER_BLOCK + k_max // 2 + B
    n_blocks = (n_moves + nominal - 1) // nominal
    # derive the counter's initial value from sharded data so its
    # varying-axes annotation matches the loop body under shard_map
    count0 = (ts.root * 0).astype(jnp.int64)
    ts, grid, ledger, key, count = jax.lax.fori_loop(
        0, n_blocks, block_body,
        (ts, grid, ledger, key, count0))
    return ts, grid, ledger, key, count


@partial(jax.jit, static_argnames=("hyp", "num_cells"))
def super_step(ts: TreeState, evo: EvoParams, pop_params, key,
               tin, tout, n_local_moves, t_max_tip,
               hyp: PriorConfig, num_cells: int):
    """One global boundary + n_local_moves local moves."""
    ts, evo, pop_params, grid, caches, ledger, key, stats = run_global_moves(
        ts, evo, pop_params, key, tin, tout, t_max_tip, hyp, num_cells)
    ts, grid, ledger, key, count = run_local_sweep(
        ts, caches, grid, ledger, evo, pop_params, key, n_local_moves, t_max_tip)
    stats = dict(stats, local_moves_attempted=count)
    return ts, evo, pop_params, key, ledger, stats


@partial(jax.jit, static_argnames=("hyp", "num_cells", "n_boundaries"))
def multi_super_step(ts: TreeState, evo: EvoParams, pop_params, key,
                     tin, tout, n_local_moves, t_max_tip,
                     hyp: PriorConfig, num_cells: int, n_boundaries: int):
    """n_boundaries super-steps in ONE XLA dispatch (lax.scan over the body).

    Scanning K boundaries amortizes the per-dispatch host<->device latency
    K-fold.  The key threading is
    identical to K sequential `super_step` calls, so the trajectory is
    bit-identical to the single-dispatch path."""
    def body(carry, _):
        ts, evo, pop_params, key = carry
        ts, evo, pop_params, grid, caches, ledger, key, stats = run_global_moves(
            ts, evo, pop_params, key, tin, tout, t_max_tip, hyp, num_cells)
        ts, grid, ledger, key, count = run_local_sweep(
            ts, caches, grid, ledger, evo, pop_params, key, n_local_moves,
            t_max_tip)
        return (ts, evo, pop_params, key), (ledger, stats, count)

    (ts, evo, pop_params, key), (ledgers, stats_seq, counts) = jax.lax.scan(
        body, (ts, evo, pop_params, key), None, length=n_boundaries)
    ledger = jax.tree.map(lambda x: x[-1], ledgers)
    stats = jax.tree.map(lambda x: x[-1], stats_seq)
    stats = dict(stats, local_moves_attempted=counts.sum())
    return ts, evo, pop_params, key, ledger, stats
