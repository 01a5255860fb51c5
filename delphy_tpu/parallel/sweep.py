"""Per-partition local-move sweeps: vmapped on one chip, shard_map across chips.

This is the device re-design of the reference's parallel local-move phase
(core/run.cpp:682-693: per-partition Subrun::mcmc_sub_iteration loops on a
thread pool).  Each part runs the reference's local move mix
(subrun.cpp:98-121) on its own index VIEW of the global flat arrays:

  - one sequential single-node displacement per block (covers the run root
    and wide-window nodes the cell coloring can't batch);
  - one cell-block-colored batched displacement (disjoint coalescent cells +
    no tree adjacency => exact composition, see mcmc/moves.py);
  - one batched branch reform over distinct branches.

Moves in different parts compose exactly because (a) the EMAT log_G is
branch-additive and every global branch belongs to exactly one part, and
(b) the augmented coalescent prior (vsc_device) factorizes per part given the
frozen Gaussian fields.  Reassembly is a scatter-add of (t, mut_t) deltas at
part-owned indices — a pure sum of disjoint-support contributions, which on a
("part",) device mesh is one psum (the reference's Run::reassemble memcpy
loop, run.cpp:195-275, turned into a collective).
"""

from __future__ import annotations

import os
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..state import TreeState
from ..evo import EvoParams
from ..mcmc.moves import Caches, bounded_exp_sample, _mh_accept
from ..mcmc.kernel import run_global_moves
from . import vsc_device as vsc


class PartCtx(NamedTuple):
    """Per-part sweep context: static maps + per-boundary gathered caches.
    All arrays are part-local; stacked versions carry a leading P axis."""
    parent: jnp.ndarray        # i32[n_cap]
    children: jnp.ndarray      # i32[n_cap, 2]
    part_root: jnp.ndarray     # i32 scalar
    is_run_root: jnp.ndarray   # bool scalar
    n_leaves: jnp.ndarray      # i32 scalar
    n_nodes: jnp.ndarray       # i32 scalar
    t_min: jnp.ndarray         # f64[n_cap]
    t_max: jnp.ndarray         # f64[n_cap]
    mut_node_loc: jnp.ndarray  # i32[m_cap]
    mut_valid: jnp.ndarray     # bool[m_cap]
    mut_site: jnp.ndarray      # i32[m_cap]
    mut_single: jnp.ndarray    # bool[m_cap] only occurrence of (node, site)
    lam: jnp.ndarray           # f64[n_cap] lambda_i at part nodes
    dlam_miss: jnp.ndarray     # f64[n_cap]
    slope: jnp.ndarray         # f64[m_cap] mu*nu*(qa[from]-qa[to]) per slot
    b: jnp.ndarray             # f64[C] frozen vsc linear coefficients


class SweepShared(NamedTuple):
    """Replicated (part-independent) sweep inputs."""
    A: jnp.ndarray             # f64[C]
    popsize_bar: jnp.ndarray   # f64[C]
    t_lo: jnp.ndarray          # f64 scalar (grid)
    t_step: jnp.ndarray        # f64 scalar
    t_max_tip: jnp.ndarray     # f64 scalar


def _pool_minmax_times(mut_node_loc, mut_valid, mut_t, n_cap: int):
    """Per-local-node max/min mutation time on each node's own branch."""
    nl = jnp.maximum(mut_node_loc, 0)
    own_max = jnp.full(n_cap, -jnp.inf, mut_t.dtype).at[nl].max(
        jnp.where(mut_valid, mut_t, -jnp.inf))
    own_min = jnp.full(n_cap, jnp.inf, mut_t.dtype).at[nl].min(
        jnp.where(mut_valid, mut_t, jnp.inf))
    return own_max, own_min


def _single_displace(ctx: PartCtx, sh: SweepShared, pop_params, carry, keys):
    """One sequential node-time displacement (inner-node or tip, 50/50), the
    part analogue of subrun.cpp:148-285.  Handles the run root (Gaussian with
    capped scale, subrun.cpp:188-201); part roots of non-root parts are
    frozen (subrun.cpp:153)."""
    t, mut_t, k_p, dG, dC, cnt = carry
    k_sel, kn1, kn2, k_prop, k_acc = keys
    n_cap = t.shape[0]

    inner = jax.random.uniform(k_sel, (), t.dtype) < 0.5
    n_inner = ctx.n_nodes - ctx.n_leaves
    node_i = ctx.n_leaves + jax.random.randint(kn1, (), 0, jnp.maximum(n_inner, 1))
    node_t = jax.random.randint(kn2, (), 0, jnp.maximum(ctx.n_leaves, 1))
    node = jnp.where(inner, node_i, node_t)
    is_root_move = inner & (node == ctx.part_root)
    valid = jnp.where(inner,
                      (~is_root_move) | ctx.is_run_root,
                      ctx.t_min[node] < ctx.t_max[node])

    own_mask = (ctx.mut_node_loc == node) & ctx.mut_valid
    own_max = jnp.max(jnp.where(own_mask, mut_t, -jnp.inf))

    safe_par = jnp.maximum(ctx.parent[node], 0)
    grid_lo = sh.t_lo + sh.t_step  # keep root proposals on-grid
    t_par = jnp.where(is_root_move, grid_lo, t[safe_par])
    t_lo_bound = jnp.maximum(t_par, own_max)
    t_lo_bound = jnp.where(inner, t_lo_bound,
                           jnp.maximum(t_lo_bound, ctx.t_min[node]))

    c0 = ctx.children[node, 0]
    c1 = ctx.children[node, 1]

    def child_bound(c):
        cs = jnp.maximum(c, 0)
        cmask = (ctx.mut_node_loc == cs) & ctx.mut_valid & (c >= 0)
        mut_min = jnp.min(jnp.where(cmask, mut_t, jnp.inf))
        return jnp.where(c >= 0, jnp.minimum(t[cs], mut_min), jnp.inf)

    t_hi = jnp.where(inner, jnp.minimum(child_bound(c0), child_bound(c1)),
                     ctx.t_max[node])

    lam = ctx.lam[node]
    lam_b0 = jnp.where(c0 >= 0, lam + ctx.dlam_miss[jnp.maximum(c0, 0)], 0.0)
    lam_b1 = jnp.where(c1 >= 0, lam + ctx.dlam_miss[jnp.maximum(c1, 0)], 0.0)
    d = jnp.where(inner,
                  jnp.where(is_root_move, 0.0, -lam) + lam_b0 + lam_b1,
                  -lam)

    old_t = t[node]
    tree_span = jnp.maximum(sh.t_max_tip - t_hi, 0.0)
    delta_scale = jnp.minimum(0.5 / jnp.maximum(lam, 1e-300), tree_span)
    root_t = old_t + delta_scale * jax.random.normal(k_prop, (), t.dtype)

    a = jnp.where(t_lo_bound > -jnp.inf, t_lo_bound, old_t - 1.0)
    bnd = jnp.where(t_hi < jnp.inf, t_hi, old_t + 1.0)
    bexp_t = bounded_exp_sample(k_prop, d, jnp.minimum(a, bnd), bnd)
    new_t = jnp.where(is_root_move, root_t, bexp_t)
    in_bounds = valid & (new_t > t_lo_bound) & (new_t < t_hi) & (t_lo_bound < t_hi)

    delta_log_G = d * (new_t - old_t)
    log_alpha = jnp.where(is_root_move, 0.0, delta_log_G)
    dcoal, k_new = vsc.displace_delta(
        k_p, ctx.b, sh.A, sh.popsize_bar, sh.t_lo, sh.t_step, pop_params,
        old_t, new_t, ~inner)
    log_mh = delta_log_G + dcoal - log_alpha
    accept = in_bounds & _mh_accept(k_acc, log_mh)

    t = t.at[node].set(jnp.where(accept, new_t, old_t))
    k_p = jnp.where(accept, k_new, k_p)
    dG = dG + jnp.where(accept, delta_log_G, 0.0)
    dC = dC + jnp.where(accept, dcoal, 0.0)
    return (t, mut_t, k_p, dG, dC, cnt + (ctx.n_nodes > 1).astype(cnt.dtype))


def _batched_displace(ctx: PartCtx, sh: SweepShared, pop_params, carry, keys,
                      k_max: int, cells_per_block: int = 16):
    """Cell-block-colored batched displacement within one part (the part
    analogue of mcmc/moves.batched_node_displace, with the vsc delta).

    Every movable node whose current time lies on the grid is a candidate:
    its proposal window is CLIPPED to the offset-colored cell block containing
    its current time.  The clipped window's bounds do not depend on the node's
    own time (block edges + neighbor/mutation bounds only), and the reverse
    proposal is clipped to the SAME block, so the restricted bounded-exp
    normalizers cancel and the Hastings ratio — hence the delta-coal-only
    acceptance below — is unchanged.  Exactness of batching: one winner per
    block, accepted paths stay inside their own block (disjoint coalescent
    cells), and no parent-child pairs are selected, so the log-posterior
    terms are disjoint and the batch composes exactly."""
    t, mut_t, k_p, dG, dC, cnt = carry
    k_off, k_pri, k_prop, k_acc = keys
    n_cap = t.shape[0]
    C = k_p.shape[0]
    n_blocks = C // cells_per_block + 1

    own_max, child_min = _pool_minmax_times(ctx.mut_node_loc, ctx.mut_valid,
                                            mut_t, n_cap)
    nodes = jnp.arange(n_cap)
    valid_node = nodes < ctx.n_nodes
    safe_par = jnp.maximum(ctx.parent, 0)
    t_par = t[safe_par]

    c0 = ctx.children[:, 0]
    c1 = ctx.children[:, 1]

    def child_bound(c):
        cs = jnp.maximum(c, 0)
        b = jnp.minimum(t[cs], child_min[cs])
        return jnp.where(c >= 0, b, jnp.inf)

    is_leaf = c0 < 0
    t_hi_inner = jnp.minimum(child_bound(c0), child_bound(c1))
    t_lo = jnp.maximum(t_par, own_max)
    t_lo = jnp.where(is_leaf, jnp.maximum(t_lo, ctx.t_min), t_lo)
    t_hi = jnp.where(is_leaf, ctx.t_max, t_hi_inner)

    movable = valid_node & (nodes != ctx.part_root) & (t_lo < t_hi)

    offset = jax.random.randint(k_off, (), 0, cells_per_block)
    cell_now = jnp.floor((t - sh.t_lo) / sh.t_step).astype(jnp.int32)
    in_grid = (cell_now >= 0) & (cell_now < C)
    blk = jnp.clip((cell_now + offset) // cells_per_block, 0, n_blocks - 1)
    blk_t_lo = sh.t_lo + (blk * cells_per_block - offset) * sh.t_step
    blk_t_hi = blk_t_lo + cells_per_block * sh.t_step
    win_lo = jnp.maximum(t_lo, blk_t_lo)
    win_hi = jnp.minimum(t_hi, blk_t_hi)
    fits = movable & in_grid & (win_lo < win_hi)

    pri = jax.random.uniform(k_pri, (n_cap,), t.dtype, 0.0, 1.0)
    pri = jnp.where(fits, pri, -1.0)
    best = jnp.full(n_blocks, -1.0, t.dtype).at[blk].max(pri)
    selected = fits & (pri >= 0.0) & (pri == best[blk])
    selected = selected & ~(selected[safe_par] & (ctx.parent >= 0))

    idx = jnp.nonzero(selected, size=k_max, fill_value=-1)[0]
    slot_ok = idx >= 0
    si = jnp.maximum(idx, 0)

    lam = ctx.lam[si]
    sc0, sc1 = c0[si], c1[si]
    lam_b0 = jnp.where(sc0 >= 0, lam + ctx.dlam_miss[jnp.maximum(sc0, 0)], 0.0)
    lam_b1 = jnp.where(sc1 >= 0, lam + ctx.dlam_miss[jnp.maximum(sc1, 0)], 0.0)
    d = -lam + lam_b0 + lam_b1

    a = win_lo[si]
    b = win_hi[si]
    old_t = t[si]
    u = jax.random.uniform(k_prop, (k_max,), t.dtype, 1e-300, 1.0)
    ltr = d * (b - a)
    safe_d = jnp.where(d == 0.0, 1.0, d)
    # threshold 80: expm1 overflows f32 at ~88.7; asymptotic error ~e^-80
    ltr_c = jnp.clip(ltr, -80.0, 80.0)
    mid = a + jnp.log1p(u * jnp.expm1(ltr_c)) / safe_d
    hi_br = b + jnp.log(u) / safe_d
    lo_br = a + jnp.log(u) / safe_d
    new_t = jnp.where(d == 0.0, a + u * (b - a),
                      jnp.where((d > 0.0) & (ltr > 80.0), hi_br,
                                jnp.where((d < 0.0) & (ltr < -80.0), lo_br, mid)))
    new_t = jnp.clip(new_t, a, b)
    in_bounds = slot_ok & (new_t > a) & (new_t < b)

    node_is_tip = is_leaf[si]
    delta_coal, dk = vsc.displace_delta_batch(
        k_p, ctx.b, sh.A, sh.popsize_bar, sh.t_lo, sh.t_step, pop_params,
        old_t, new_t, node_is_tip)

    delta_log_G = d * (new_t - old_t)
    lu = jnp.log(jax.random.uniform(k_acc, (k_max,), t.dtype, 1e-300, 1.0))
    accept = in_bounds & ((delta_coal >= 0.0) | (lu < delta_coal))

    t = t.at[si].set(jnp.where(accept, new_t, old_t))
    k_p = k_p + jnp.sum(jnp.where(accept[:, None], dk, 0.0), axis=0)
    dG = dG + jnp.sum(jnp.where(accept, delta_log_G, 0.0))
    dC = dC + jnp.sum(jnp.where(accept, delta_coal, 0.0))
    cnt = cnt + jnp.sum(slot_ok.astype(cnt.dtype))
    return (t, mut_t, k_p, dG, dC, cnt)


def _batched_reform(ctx: PartCtx, carry, keys):
    """Branch-mutation-time resampling on ALL of this part's branches at once
    (semantics: subrun.cpp:287-320, randomize_branch_mutation_times).
    Distinct branches touch disjoint log_G terms, so batch-accepting is exact.

    Sort-free: mutation times are redrawn i.i.d. Uniform(t_P, t_X] at slots
    that are the ONLY occurrence of their (branch, site) pair (ctx.mut_single,
    classified once per boundary — the pool is static within a sweep, so the
    proposal kernel is state-independent and detailed balance holds).  The
    rare >=2-same-site-per-branch slots (the reference's joint-redraw+sort
    case) keep their times here; the host topology path still refreshes them."""
    t, mut_t, k_p, dG, dC, cnt = carry
    k_t, k_acc = keys
    n_cap = t.shape[0]
    m_cap = mut_t.shape[0]

    in_batch = (jnp.arange(n_cap) < ctx.n_nodes)
    in_batch = in_batch.at[ctx.part_root].set(False)

    nl = jnp.maximum(ctx.mut_node_loc, 0)
    mut_in = in_batch[nl] & ctx.mut_valid & ctx.mut_single
    t_P = t[jnp.maximum(ctx.parent[nl], 0)]
    t_X = t[nl]
    u = jax.random.uniform(k_t, (m_cap,), t.dtype, 1e-16, 1.0)
    new_mut_t = jnp.where(mut_in, t_P + u * (t_X - t_P), mut_t)

    per_slot = jnp.where(mut_in, -ctx.slope * (new_mut_t - mut_t), 0.0)
    delta_per_node = jnp.zeros(n_cap, t.dtype).at[nl].add(per_slot)

    lu = jnp.log(jax.random.uniform(k_acc, (n_cap,), t.dtype, 1e-300, 1.0))
    accept_node = in_batch & ((delta_per_node >= 0.0) | (lu < delta_per_node))
    accept_slot = accept_node[nl] & mut_in

    mut_t = jnp.where(accept_slot, new_mut_t, mut_t)
    dG = dG + jnp.sum(jnp.where(accept_node, delta_per_node, 0.0))
    cnt = cnt + jnp.sum(in_batch.astype(cnt.dtype))
    return (t, mut_t, k_p, dG, dC, cnt)


_DISPLACE_ROUNDS = int(os.environ.get("DELPHY_TPU_DISPLACE_ROUNDS", "1"))
# debug knobs for move-kernel bisection studies (scripts/f32_study.py)
_NO_SINGLE = bool(int(os.environ.get("DELPHY_TPU_NO_SINGLE", "0")))
_NO_REFORM = bool(int(os.environ.get("DELPHY_TPU_NO_REFORM", "0")))


def part_sweep(ctx: PartCtx, k_p, t_p, mut_t, key, sh: SweepShared,
               pop_params, n_blocks, k_max: int, reform_batch: int):
    """One part's whole local sweep: n_blocks blocks of
    (single displace, R x batched displace, batched reform).  Each batched
    round draws an independent color offset, so repeating it composes exactly
    (it is the same kernel applied R times)."""
    count0 = (ctx.part_root * 0).astype(jnp.int64)
    zero = t_p[0] * 0.0

    def block_body(i, carry):
        t, mut_t, k_p, dG, dC, key, cnt = carry
        key, k1, k2, k3, k4, k5, k10, k11 = jax.random.split(key, 8)
        c = (t, mut_t, k_p, dG, dC, cnt)
        if not _NO_SINGLE:
            c = _single_displace(ctx, sh, pop_params, c, (k1, k2, k3, k4, k5))
        for r in range(_DISPLACE_ROUNDS):
            key, k6, k7, k8, k9 = jax.random.split(key, 5)
            c = _batched_displace(ctx, sh, pop_params, c, (k6, k7, k8, k9),
                                  k_max)
        if not _NO_REFORM:
            c = _batched_reform(ctx, c, (k10, k11))
        t, mut_t, k_p, dG, dC, cnt = c
        return (t, mut_t, k_p, dG, dC, key, cnt)

    t_p, mut_t, k_p, dG, dC, key, cnt = jax.lax.fori_loop(
        0, n_blocks, block_body, (t_p, mut_t, k_p, zero, zero, key, count0))
    return t_p, mut_t, k_p, dG, dC, cnt


# ---------------------------------------------------------------------------
# Gathering part views + reassembly
# ---------------------------------------------------------------------------

def build_part_ctx(pm, ts: TreeState, caches: Caches, evo: EvoParams, b,
                   salt=None):
    """Gather the per-part sweep context from the global arrays (one gather
    per boundary; all maps static).  pm is the device pytree of PartMaps.

    salt (i32 scalar, drawn fresh each boundary) perturbs the single-slot
    hash so collision-locked slots VARY per boundary: a truly-single slot
    is falsely locked ~1-2% of boundaries instead of permanently, so every
    mutation time is eventually refreshed by the batched reform (ergodicity;
    the reference redraws all branch times jointly, phylo_tree.cpp:579-645).
    The salt is state-independent randomness, so the sweep remains a valid
    mixture of MCMC kernels."""
    nm = jnp.maximum(pm.node_map, 0)
    mm = jnp.maximum(pm.mut_map, 0)
    site = ts.mut_site[mm]
    frm = ts.mut_from[mm]
    to = ts.mut_to[mm]
    mpart = evo.part[jnp.maximum(site, 0)]
    qa = evo.qa_tab
    slope = evo.mu * evo.nu[jnp.maximum(site, 0)] * (
        qa[mpart, jnp.maximum(frm, 0)] - qa[mpart, jnp.maximum(to, 0)])
    valid = pm.mut_map >= 0
    # slots that are the only occurrence of their (branch, site) pair in the
    # part, via a hashed-key histogram (static within a sweep — the pool only
    # changes at topology bursts).  A hash collision can only LOCK a slot
    # (count inflated), never falsely mark a multi-pair single; 32x buckets
    # keep the spurious-lock rate ~1-2%.
    L = ts.num_sites
    B = 32 * pm.mut_map.shape[-1] + 1
    key64 = (pm.mut_node_local.astype(jnp.int64) * (L + 1)
             + jnp.maximum(site, 0).astype(jnp.int64))
    if salt is not None:
        # Murmur3-style avalanche of key^salt: equal keys stay equal under
        # any salt (true multis are always detected), while which DISTINCT
        # keys collide is effectively independent across salts — an additive
        # or multiplicative salt would NOT achieve this ((k1-k2)*c mod m is
        # salt-invariant).  uint32 wraparound is the hash's working modulus.
        # The part id enters the key too: the histogram is shared across the
        # part axis, and uniqueness is a PER-PART property (the same local
        # node index in two parts is two different global nodes).
        key_u = (key64.astype(jnp.uint32)
                 + pm.part_id[:, None].astype(jnp.uint32)
                 * jnp.uint32(0x9E3779B9))
        x = key_u ^ salt.astype(jnp.uint32)
        x = x * jnp.uint32(0x85EBCA6B)
        x = x ^ (x >> jnp.uint32(13))
        x = x * jnp.uint32(0xC2B2AE35)
        x = x ^ (x >> jnp.uint32(16))
        bucket = (x % jnp.uint32(B - 1)).astype(jnp.int32)
    else:
        bucket = (key64 % (B - 1)).astype(jnp.int32)
    counts = jnp.zeros(B, jnp.int32).at[
        jnp.where(valid, bucket, B - 1)].add(1)
    single = valid & (counts[bucket] == 1)
    return PartCtx(
        parent=pm.parent, children=pm.children, part_root=pm.part_root,
        is_run_root=pm.is_run_root, n_leaves=pm.n_leaves, n_nodes=pm.n_nodes,
        t_min=pm.t_min, t_max=pm.t_max,
        mut_node_loc=pm.mut_node_local, mut_valid=valid,
        mut_site=site, mut_single=single,
        lam=caches.lambda_i[nm], dlam_miss=caches.dlam_miss[nm],
        slope=slope, b=b)


def sweep_deltas(pm, ctx: PartCtx, k_p, t_p, mut_t_p, keys, sh: SweepShared,
                 pop_params, n_blocks, k_max: int, reform_batch: int):
    """vmapped per-part sweeps.  Returns part-local deltas
    (dt_p[P, n_cap], dmut_p[P, m_cap], dG, dC, count); scatter_deltas turns
    them into global-delta arrays — each part's deltas have disjoint support
    (owned nodes / owned pool slots), so summing them (and, across mesh
    shards, psum-ing them) reassembles exactly."""
    outs = jax.vmap(
        part_sweep, in_axes=(0, 0, 0, 0, 0, None, None, None, None, None)
    )(ctx, k_p, t_p, mut_t_p, keys, sh, pop_params, n_blocks, k_max,
      reform_batch)
    t_new, mut_new, k_new, dG_p, dC_p, cnt_p = outs
    return (t_new - t_p, mut_new - mut_t_p,
            jnp.sum(dG_p), jnp.sum(dC_p), jnp.sum(cnt_p))


def scatter_deltas(pm, num_nodes: int, num_mut_slots: int, dt_p, dmut_p):
    """Scatter part-local deltas into global-size arrays via the owned-index
    maps (non-owned/padded entries route to a trash slot)."""
    dt = jnp.zeros(num_nodes + 1, dt_p.dtype).at[
        pm.owned_idx.reshape(-1)].add(dt_p.reshape(-1))[:num_nodes]
    dmut = jnp.zeros(num_mut_slots + 1, dmut_p.dtype).at[
        pm.mut_scatter.reshape(-1)].add(dmut_p.reshape(-1))[:num_mut_slots]
    return dt, dmut


# ---------------------------------------------------------------------------
# The partitioned super-step (global boundary + partitioned sweep)
# ---------------------------------------------------------------------------

def _boundary_body(ts: TreeState, evo, pop_params, key, tin, tout, pm,
                   n_blocks, t_max_tip, hyp, num_cells: int,
                   k_max: int, reform_batch: int, mesh=None,
                   param_moves: bool = True, part_sel=None):
    """One boundary: global moves (replicated) + partitioned local sweep.
    With mesh=None the parts fan out via vmap on one device; with a mesh they
    shard over its ("part",) axis under shard_map with psum reassembly.

    part_sel (i32[P_sel], optional): sweep only these part rows — the device
    half of the overlapped topology driver (run.py), where the host bursts
    the complement concurrently.  The vsc fields are still sampled over ALL
    parts (the augmentation conditions on the full boundary state; the
    unselected parts' k_bar contributions stay frozen at their dispatch
    values, exactly like the reference's frozen cut-point conditioning,
    run.cpp:682-693), and only the sweep fan-out is gathered down — so the
    device does P_sel/P of the work instead of masking rows in place."""
    ts, evo, pop_params, grid, caches, ledger, key, stats = run_global_moves(
        ts, evo, pop_params, key, tin, tout, t_max_tip, hyp, num_cells,
        param_moves=param_moves)

    # per-part lineage staircases + auxiliary-field resample (a Gibbs update
    # of the decoupling fields, very_scalable_coalescent.cpp:198-219)
    nm = jnp.maximum(pm.node_map, 0)
    t_p = ts.t[nm]
    k_p = jax.vmap(vsc.calc_k_bar_signed, in_axes=(0, 0, None, None, None))(
        t_p, pm.sign, grid.t_lo, grid.t_step, num_cells)
    active = vsc.active_cells(pm.part_t_lo, pm.part_t_hi, grid.t_lo,
                              grid.t_step, num_cells)
    key, k_fields, k_sweep, k_salt = jax.random.split(key, 4)
    fields = vsc.sample_fields(k_fields, k_p, active, grid.popsize_bar,
                               grid.t_step)

    salt = jax.random.randint(k_salt, (), 0, jnp.iinfo(jnp.int32).max)
    ctx = build_part_ctx(pm, ts, caches, evo, fields.b, salt=salt)
    mm = jnp.maximum(pm.mut_map, 0)
    mut_t_p = ts.mut_t[mm]
    keys = jax.vmap(jax.random.fold_in, in_axes=(None, 0))(k_sweep, pm.part_id)
    if part_sel is not None:
        # gather the sweep fan-out down to the selected parts (leading-axis
        # rows); fields/k_bar above were computed over the FULL part stack
        sel = part_sel
        ctx = jax.tree.map(lambda a: a[sel], ctx)
        k_p = k_p[sel]
        t_p = t_p[sel]
        mut_t_p = mut_t_p[sel]
        keys = keys[sel]
        pm = jax.tree.map(lambda a: a[sel], pm)
    sh = SweepShared(A=fields.A, popsize_bar=grid.popsize_bar,
                     t_lo=grid.t_lo, t_step=grid.t_step,
                     t_max_tip=jnp.asarray(t_max_tip, t_p.dtype))

    N = ts.num_nodes
    M = ts.mut_t.shape[0]

    def sweep_shard(ctx_s, k_p_s, t_p_s, mut_t_p_s, keys_s, pm_s):
        """All sweep work for one shard of the part axis (the whole stack
        when mesh is None)."""
        dt_p, dmut_p, dG, dC, cnt = sweep_deltas(
            pm_s, ctx_s, k_p_s, t_p_s, mut_t_p_s, keys_s, sh, pop_params,
            n_blocks, k_max, reform_batch)
        dt, dmut = scatter_deltas(pm_s, N, M, dt_p, dmut_p)
        return dt, dmut, dG, dC, cnt

    if mesh is None:
        dt, dmut, dG, dC, cnt = sweep_shard(ctx, k_p, t_p, mut_t_p, keys, pm)
    else:
        from jax.sharding import PartitionSpec as P
        from jax import shard_map

        def body(ctx_s, k_p_s, t_p_s, mut_t_p_s, keys_s, pm_s):
            dt, dmut, dG, dC, cnt = sweep_shard(
                ctx_s, k_p_s, t_p_s, mut_t_p_s, keys_s, pm_s)
            # reassembly collective: disjoint-support deltas summed over parts
            # (the reference's Run::reassemble memcpy loop, run.cpp:195-275,
            # as one psum over the mesh)
            dt = jax.lax.psum(dt, "part")
            dmut = jax.lax.psum(dmut, "part")
            dG = jax.lax.psum(dG, "part")
            dC = jax.lax.psum(dC, "part")
            cnt = jax.lax.psum(cnt, "part")
            return dt, dmut, dG, dC, cnt

        spec_p = jax.tree.map(lambda _: P("part"), (ctx, k_p, t_p, mut_t_p,
                                                    keys, pm))
        dt, dmut, dG, dC, cnt = shard_map(
            body, mesh=mesh,
            in_specs=spec_p,
            out_specs=(P(), P(), P(), P(), P()),
        )(ctx, k_p, t_p, mut_t_p, keys, pm)

    ts = ts._replace(t=ts.t + dt, mut_t=ts.mut_t + dmut)
    # within-sweep coal deltas are under the AUGMENTED prior; the ledger's
    # log_coal is refreshed from the plain prior at the next boundary (same
    # discipline as the reference's reassemble + check, run.cpp:302-357)
    ledger = ledger._replace(log_G=ledger.log_G + dG,
                             log_coal=ledger.log_coal + dC)
    stats = dict(stats, local_moves_attempted=cnt)
    return ts, evo, pop_params, key, ledger, stats


@partial(jax.jit, static_argnames=("hyp", "num_cells", "n_boundaries",
                                   "k_max", "reform_batch", "mesh",
                                   "param_moves"))
def parts_multi_super_step(ts: TreeState, evo, pop_params, key, tin, tout,
                           pm, n_blocks, t_max_tip, hyp, num_cells: int,
                           n_boundaries: int, k_max: int, reform_batch: int,
                           mesh=None, param_moves: bool = True,
                           part_sel=None):
    """n_boundaries partitioned super-steps in ONE dispatch.

    mesh=None fans the parts out via vmap on one device; with a
    jax.sharding.Mesh (axis "part") the same sweep runs under shard_map with
    psum reassembly — the production multi-chip driver (the reference's
    thread fan-out + reassemble, run.cpp:622-693, over device collectives
    instead of a thread pool).  Trajectories are bit-identical across the two modes."""
    if mesh is not None and part_sel is not None:
        # overlapped mesh sweeps: the fan-out gather happens on GLOBAL
        # arrays before shard_map (GSPMD inserts the reshard), so the only
        # structural requirement is that the selection width divides over
        # the mesh.  Multi-PROCESS meshes stay excluded in the driver
        # (run.py _overlap_active): the merge path packs host state without
        # the replicate_to_mesh step and bursts are process-0-gated.
        assert part_sel.shape[0] % mesh.size == 0, \
            f"part_sel width {part_sel.shape[0]} must divide mesh {mesh.size}"
    def body(carry, _):
        ts, evo, pop_params, key = carry
        ts, evo, pop_params, key, ledger, stats = _boundary_body(
            ts, evo, pop_params, key, tin, tout, pm, n_blocks, t_max_tip,
            hyp, num_cells, k_max, reform_batch, mesh=mesh,
            param_moves=param_moves, part_sel=part_sel)
        return (ts, evo, pop_params, key), (ledger, stats)

    (ts, evo, pop_params, key), (ledgers, stats_seq) = jax.lax.scan(
        body, (ts, evo, pop_params, key), None, length=n_boundaries)
    ledger = jax.tree.map(lambda x: x[-1], ledgers)
    stats = jax.tree.map(lambda x: x[-1], stats_seq)
    stats = dict(stats,
                 local_moves_attempted=stats_seq["local_moves_attempted"].sum())
    # fused host bundle computed INSIDE the dispatch: a topology burst then
    # pulls two ready buffers instead of either ~30 leaf fetches or
    # enqueuing a fresh concat program
    from ..state import fuse_for_host
    fused = fuse_for_host((ts, evo, pop_params))
    if mesh is not None:
        # pin every output fully replicated: the host driver (and, on a
        # multi-PROCESS mesh, every controller) reads these eagerly, which
        # requires fully-addressable-or-replicated arrays; GSPMD left alone
        # may shard large outputs.  No-op numerically.
        from jax.sharding import NamedSharding, PartitionSpec as _P
        rep = NamedSharding(mesh, _P())
        (ts, evo, pop_params, key, ledger, stats, fused) = jax.tree.map(
            lambda x: jax.lax.with_sharding_constraint(x, rep),
            (ts, evo, pop_params, key, ledger, stats, fused))
    return ts, evo, pop_params, key, ledger, stats, fused


def make_mesh_multi_super_step(mesh, hyp, num_cells: int, n_boundaries: int,
                               k_max: int, reform_batch: int):
    """Jitted multi-chip variant over a ("part",) mesh — thin wrapper around
    parts_multi_super_step(mesh=...) (requires P % mesh.size == 0)."""
    def step(ts, evo, pop_params, key, tin, tout, pm, n_blocks, t_max_tip):
        ts, evo, pop_params, key, ledger, stats, _ = parts_multi_super_step(
            ts, evo, pop_params, key, tin, tout, pm, n_blocks, t_max_tip,
            hyp, num_cells, n_boundaries, k_max, reform_batch, mesh=mesh)
        return ts, evo, pop_params, key, ledger, stats

    return step
