"""Local MCMC moves, fully vectorized per move.

Each move body is O(pool + grid-cells) of vectorized device work with no
data-dependent shapes, so a sweep compiles to a single fori_loop kernel.
Move semantics mirror core/subrun.cpp:

  inner-node displace  (subrun.cpp:148-232)  weight 7.5
  tip displace         (subrun.cpp:234-285)  weight 7.5
  branch reform        (subrun.cpp:287-320)  weight 15.0

Node-time proposals sample exactly from p(t) ~ exp(d_logG_dt * t) on
[t_min, t_max] via the bounded exponential inverse CDF (distributions.h:38-68),
making the genetic-likelihood part of the MH ratio cancel; only the coalescent
prior delta remains.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..state import TreeState
from ..evo import EvoParams
from ..ops import coalescent as coal


class Ledger(NamedTuple):
    log_G: jnp.ndarray
    log_coal: jnp.ndarray
    log_other: jnp.ndarray

    @property
    def log_posterior(self):
        return self.log_G + self.log_coal + self.log_other


class Caches(NamedTuple):
    """Derived quantities that stay constant through a local sweep (no
    topology moves yet — mutation sets and missations are fixed, only times
    move, so lambda_i is invariant; cf. subrun.h:42-65)."""
    lambda_i: jnp.ndarray    # f64[N]
    dlam_miss: jnp.ndarray   # f64[N]: delta-lambda across each node's own missations
    ref_cum_Q: jnp.ndarray   # f64[L+1]
    root_freq: jnp.ndarray   # f64[4]


def bounded_exp_sample(key, lam, a, b):
    """Sample x ~ exp(lam*x) on [a,b] (reference distributions.h:38-68).

    All branches are computed with guarded inputs and combined with where, so
    the function is safe under jit for any finite a<b and any lam.
    """
    u = jax.random.uniform(key, (), dtype=jnp.float64, minval=1e-300, maxval=1.0)
    ltr = lam * (b - a)
    safe_lam = jnp.where(lam == 0.0, 1.0, lam)
    # stable middle branch: clamp exponent to avoid overflow (selected away).
    # Threshold 80 keeps expm1 finite in f32 (overflows at ~88.7); switching
    # to the asymptotic branch at 80 introduces error ~e^-80, negligible.
    ltr_c = jnp.clip(ltr, -80.0, 80.0)
    mid = a + jnp.log1p(u * jnp.expm1(ltr_c)) / safe_lam
    hi = b + jnp.log(u) / safe_lam   # lam > 0, ltr >> 1
    lo = a + jnp.log(u) / safe_lam   # lam < 0, ltr << -1
    x = jnp.where(lam == 0.0, a + u * (b - a),
                  jnp.where((lam > 0.0) & (ltr > 80.0), hi,
                            jnp.where((lam < 0.0) & (ltr < -80.0), lo, mid)))
    return jnp.clip(x, a, b)


def _own_mut_time_max(ts: TreeState, node):
    """max mutation time on the branch ending at `node` (-inf if none);
    root deltas are excluded via the node != root condition at call sites."""
    mask = ts.mut_node == node
    return jnp.max(jnp.where(mask, ts.mut_t, -jnp.inf))


def _child_bound(ts: TreeState, child):
    """min(t_child, min mutation time on child's branch); +inf for child == -1."""
    valid = child >= 0
    c = jnp.maximum(child, 0)
    mask = (ts.mut_node == c) & valid
    mut_min = jnp.min(jnp.where(mask, ts.mut_t, jnp.inf))
    return jnp.where(valid, jnp.minimum(ts.t[c], mut_min), jnp.inf)


def _mh_accept(key, log_mh):
    u = jax.random.uniform(key, (), dtype=jnp.float64, minval=1e-300, maxval=1.0)
    return (log_mh >= 0.0) | (jnp.log(u) < log_mh)


def inner_node_displace(carry, keys, pop_params, t_max_tip):
    """Displace one random inner node in time (subrun.cpp:148-232)."""
    ts, caches, grid, ledger = carry
    k_node, k_prop, k_acc = keys
    T = ts.num_tips
    N = ts.num_nodes

    node = T + jax.random.randint(k_node, (), 0, N - T)
    is_root = node == ts.root

    safe_par = jnp.maximum(ts.parent[node], 0)
    grid_lo = grid.t_lo + grid.t_step  # keep proposals on-grid (cf. ensure_space)
    t_par = jnp.where(is_root, grid_lo, ts.t[safe_par])
    own_max = jnp.where(is_root, -jnp.inf, _own_mut_time_max(ts, node))
    t_min = jnp.maximum(t_par, own_max)

    c0 = ts.children[node, 0]
    c1 = ts.children[node, 1]
    t_max = jnp.minimum(_child_bound(ts, c0), _child_bound(ts, c1))

    lam = caches.lambda_i[node]
    lam_below_0 = lam + caches.dlam_miss[jnp.maximum(c0, 0)]
    lam_below_1 = lam + caches.dlam_miss[jnp.maximum(c1, 0)]
    d_logG_dt = jnp.where(is_root, 0.0, -lam) + lam_below_0 + lam_below_1

    old_t = ts.t[node]

    # root: Gaussian proposal with capped scale (subrun.cpp:188-201)
    tree_span = jnp.maximum(t_max_tip - t_max, 0.0)
    safe_lam = jnp.maximum(lam, 1e-300)
    delta_scale = jnp.minimum(0.5 / safe_lam, tree_span)
    root_t = old_t + delta_scale * jax.random.normal(k_prop, (), dtype=jnp.float64)

    # non-root: exact bounded-exponential proposal
    a = jnp.where(t_min > -jnp.inf, t_min, old_t - 1.0)  # always finite for non-root
    b = jnp.where(t_max < jnp.inf, t_max, old_t + 1.0)
    bexp_t = bounded_exp_sample(k_prop, d_logG_dt, jnp.minimum(a, b), b)

    new_t = jnp.where(is_root, root_t, bexp_t)
    in_bounds = (new_t > t_min) & (new_t < t_max) & (t_min < t_max)

    dt = new_t - old_t
    delta_log_G = d_logG_dt * dt
    log_alpha = jnp.where(is_root, 0.0, delta_log_G)

    delta_coal, new_k = coal.displace_delta(grid, pop_params, old_t, new_t,
                                            jnp.bool_(False))
    log_mh = delta_log_G + delta_coal - log_alpha
    accept = in_bounds & _mh_accept(k_acc, log_mh)

    ts = ts._replace(t=ts.t.at[node].set(jnp.where(accept, new_t, old_t)))
    grid = grid._replace(k_bar=jnp.where(accept, new_k, grid.k_bar))
    ledger = ledger._replace(
        log_G=ledger.log_G + jnp.where(accept, delta_log_G, 0.0),
        log_coal=ledger.log_coal + jnp.where(accept, delta_coal, 0.0))
    return (ts, caches, grid, ledger)


def tip_displace(carry, keys, pop_params, t_max_tip):
    """Displace one random tip within its date-uncertainty bounds
    (subrun.cpp:234-285)."""
    ts, caches, grid, ledger = carry
    k_node, k_prop, k_acc = keys
    T = ts.num_tips

    node = jax.random.randint(k_node, (), 0, T)
    has_unc = ts.t_min[node] < ts.t_max[node]

    t_min = jnp.maximum(ts.t_min[node],
                        jnp.maximum(ts.t[jnp.maximum(ts.parent[node], 0)],
                                    _own_mut_time_max(ts, node)))
    t_max = ts.t_max[node]

    d_logG_dt = -caches.lambda_i[node]
    old_t = ts.t[node]
    new_t = bounded_exp_sample(k_prop, d_logG_dt, jnp.minimum(t_min, t_max), t_max)
    in_bounds = has_unc & (new_t > t_min) & (new_t < t_max) & (t_min < t_max)

    delta_log_G = d_logG_dt * (new_t - old_t)
    delta_coal, new_k = coal.displace_delta(grid, pop_params, old_t, new_t,
                                            jnp.bool_(True))
    log_mh = delta_coal  # delta_log_G cancels against the proposal density
    accept = in_bounds & _mh_accept(k_acc, log_mh)

    ts = ts._replace(t=ts.t.at[node].set(jnp.where(accept, new_t, old_t)))
    grid = grid._replace(k_bar=jnp.where(accept, new_k, grid.k_bar))
    ledger = ledger._replace(
        log_G=ledger.log_G + jnp.where(accept, delta_log_G, 0.0),
        log_coal=ledger.log_coal + jnp.where(accept, delta_coal, 0.0))
    return (ts, caches, grid, ledger)


def _segment_minmax_mut_times(ts: TreeState):
    """Per-node max/min mutation time on each node's own branch (pool-wide
    scatter reductions; root deltas excluded by their sentinel times being
    masked out through the valid mask)."""
    N = ts.num_nodes
    node_safe = jnp.maximum(ts.mut_node, 0)
    valid = (ts.mut_node >= 0) & (ts.mut_node != ts.root)
    own_max = jnp.full(N, -jnp.inf).at[node_safe].max(
        jnp.where(valid, ts.mut_t, -jnp.inf))
    own_min = jnp.full(N, jnp.inf).at[node_safe].min(
        jnp.where(valid, ts.mut_t, jnp.inf))
    return own_max, own_min


def batched_node_displace(ts: TreeState, caches: Caches, grid, ledger: Ledger,
                          pop_params, key, t_max_tip, k_max: int,
                          cells_per_block: int = 4):
    """Displace up to k_max nodes (inner AND tips) in one vectorized pass.

    Exactness by coloring: the coalescent grid's cells are partitioned into
    blocks of `cells_per_block` cells at a random offset; a node is a batch
    candidate only if its whole proposal window [t_min, t_max] lies inside one
    block.  One winner per block (random priority), and parent-child pairs are
    dropped.  Selected nodes then touch disjoint log-posterior terms — their
    branch terms are disjoint (no tree adjacency), their k_bar deltas touch
    disjoint cells, and their -log N(t) point terms are per-node — so the
    batch of bounded-exponential MH moves (subrun.cpp:148-285 semantics per
    node) composes exactly like sequential moves.  Wide-window nodes and the
    root are covered by the interleaved sequential displacements.

    This replaces the reference's thread-per-partition concurrency
    (run.cpp:682-693) with SIMD-width concurrency on one chip.
    """
    N = ts.num_nodes
    C = grid.num_cells
    n_blocks = C // cells_per_block
    (k_off, k_pri, k_prop, k_acc) = jax.random.split(key, 4)

    own_max, child_min = _segment_minmax_mut_times(ts)

    nodes = jnp.arange(N)
    is_tip = ts.is_tip
    safe_par = jnp.maximum(ts.parent, 0)
    t_par = ts.t[safe_par]

    # per-node child bound: min over children of (t_child, earliest child mut)
    c0 = ts.children[:, 0]
    c1 = ts.children[:, 1]

    def child_bound(c):
        cs = jnp.maximum(c, 0)
        b = jnp.minimum(ts.t[cs], child_min[cs])
        return jnp.where(c >= 0, b, jnp.inf)

    t_hi_inner = jnp.minimum(child_bound(c0), child_bound(c1))
    t_lo = jnp.maximum(t_par, own_max)
    t_lo = jnp.where(is_tip, jnp.maximum(t_lo, ts.t_min), t_lo)
    t_hi = jnp.where(is_tip, ts.t_max, t_hi_inner)

    movable = (nodes != ts.root) & (t_lo < t_hi)

    # block coloring at a random cell offset
    offset = jax.random.randint(k_off, (), 0, cells_per_block)
    rel_lo = (t_lo - grid.t_lo) / grid.t_step
    rel_hi = (t_hi - grid.t_lo) / grid.t_step
    cell_lo = jnp.floor(rel_lo).astype(jnp.int32) + offset
    cell_hi = jnp.floor(rel_hi).astype(jnp.int32) + offset
    blk_lo = jnp.where(cell_lo >= 0, cell_lo // cells_per_block, -1)
    blk_hi = jnp.where(cell_hi >= 0, cell_hi // cells_per_block, -1)
    in_grid = (cell_lo >= 0) & (cell_hi < C)
    fits = movable & in_grid & (blk_lo == blk_hi)

    pri = jax.random.uniform(k_pri, (N,), jnp.float64, 0.0, 1.0)
    pri = jnp.where(fits, pri, -1.0)
    blk = jnp.clip(blk_lo, 0, n_blocks - 1)
    best = jnp.full(n_blocks, -1.0).at[blk].max(pri)
    selected = fits & (pri >= 0.0) & (pri == best[blk])
    # drop children whose parent is selected (tree adjacency conflict)
    selected = selected & ~(selected[safe_par] & (ts.parent >= 0))

    idx = jnp.nonzero(selected, size=k_max, fill_value=-1)[0]
    slot_ok = idx >= 0
    si = jnp.maximum(idx, 0)

    # d logG/dt per node (subrun.cpp:171-182 / 248-252)
    lam = caches.lambda_i[si]
    sc0, sc1 = c0[si], c1[si]
    lam_b0 = jnp.where(sc0 >= 0, lam + caches.dlam_miss[jnp.maximum(sc0, 0)], 0.0)
    lam_b1 = jnp.where(sc1 >= 0, lam + caches.dlam_miss[jnp.maximum(sc1, 0)], 0.0)
    d = -lam + lam_b0 + lam_b1

    a = t_lo[si]
    b = t_hi[si]
    old_t = ts.t[si]
    u = jax.random.uniform(k_prop, (k_max,), jnp.float64, 1e-300, 1.0)
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

    # per-slot coalescent delta over the full cell axis (disjoint supports)
    node_is_tip = is_tip[si]
    sign = jnp.where(node_is_tip, 1.0, -1.0)
    lbs = grid.cell_lbounds()[None, :]
    frac_old = jnp.clip((old_t[:, None] - lbs) / grid.t_step, 0.0, 1.0)
    frac_new = jnp.clip((new_t[:, None] - lbs) / grid.t_step, 0.0, 1.0)
    dk = sign[:, None] * (frac_new - frac_old)          # [k_max, C]
    kb = grid.k_bar[None, :]
    delta_quad = -jnp.sum(grid.t_step * ((kb + dk) * (kb + dk - 1.0)
                                         - kb * (kb - 1.0))
                          / (2.0 * grid.popsize_bar[None, :]), axis=1)
    from .. import pop as popm
    logN_new = jnp.log(popm.pop_at_time(pop_params, new_t))
    logN_old = jnp.log(popm.pop_at_time(pop_params, old_t))
    delta_coal = delta_quad + jnp.where(node_is_tip, 0.0, -(logN_new - logN_old))

    delta_log_G = d * (new_t - old_t)
    # bounded-exp proposal density cancels delta_log_G; MH on coal delta only
    lu = jnp.log(jax.random.uniform(k_acc, (k_max,), jnp.float64, 1e-300, 1.0))
    accept = in_bounds & ((delta_coal >= 0.0) | (lu < delta_coal))

    t_new_vec = ts.t.at[si].set(jnp.where(accept, new_t, old_t))
    ts = ts._replace(t=t_new_vec)
    k_bar = grid.k_bar + jnp.sum(jnp.where(accept[:, None], dk, 0.0), axis=0)
    grid = grid._replace(k_bar=k_bar)
    ledger = ledger._replace(
        log_G=ledger.log_G + jnp.sum(jnp.where(accept, delta_log_G, 0.0)),
        log_coal=ledger.log_coal + jnp.sum(jnp.where(accept, delta_coal, 0.0)))
    n_attempted = jnp.sum(slot_ok.astype(jnp.int64))
    return ts, grid, ledger, n_attempted


def batched_branch_reform(ts: TreeState, ledger: Ledger, evo: EvoParams, key,
                          batch_size: int):
    """Resample mutation times on `batch_size` DISTINCT random branches in one
    vectorized pass.

    Exactness: the EMAT log-likelihood is additive over branches and a
    branch-reform touches only its own branch's mutation times (lambda_i and
    the coalescent prior are unaffected, subrun.cpp:287-320), so reforms on
    distinct branches are independent MH kernels — batch-accepting each
    independently equals composing them sequentially.  This is where the
    device wins over the reference's one-at-a-time loop."""
    N = ts.num_nodes
    M = ts.mut_t.shape[0]
    L = ts.num_sites
    k_sel, k_t, k_acc = jax.random.split(key, 3)

    perm = jax.random.permutation(k_sel, N)
    chosen = perm[:batch_size]
    in_batch = jnp.zeros(N, bool).at[chosen].set(True).at[ts.root].set(False)

    node_safe = jnp.maximum(ts.mut_node, 0)
    mut_in = in_batch[node_safe] & (ts.mut_node >= 0)
    t_P = ts.t[jnp.maximum(ts.parent[node_safe], 0)]
    t_X = ts.t[node_safe]
    u = jax.random.uniform(k_t, (M,), jnp.float64, 1e-16, 1.0)
    raw = t_P + u * (t_X - t_P)

    # per-(branch, site) order preservation via double lexsort
    group = jnp.where(mut_in,
                      node_safe.astype(jnp.float64) * L + ts.mut_site,
                      jnp.inf)
    perm_old = jnp.lexsort((ts.mut_t, group))
    perm_new = jnp.lexsort((raw, group))
    matched = jnp.zeros(M, jnp.float64).at[perm_old].set(raw[perm_new])
    new_mut_t = jnp.where(mut_in, matched, ts.mut_t)

    qa_tab = evo.qa_tab
    site = jnp.maximum(ts.mut_site, 0)
    mpart = evo.part[site]
    slope = evo.mu * evo.nu[site] * (qa_tab[mpart, jnp.maximum(ts.mut_from, 0)] -
                                     qa_tab[mpart, jnp.maximum(ts.mut_to, 0)])
    per_slot = jnp.where(mut_in, -slope * (new_mut_t - ts.mut_t), 0.0)
    delta_per_node = jnp.zeros(N, jnp.float64).at[node_safe].add(per_slot)

    lu = jnp.log(jax.random.uniform(k_acc, (N,), jnp.float64, 1e-300, 1.0))
    accept_node = in_batch & ((delta_per_node >= 0.0) | (lu < delta_per_node))
    accept_slot = accept_node[node_safe] & mut_in

    ts = ts._replace(mut_t=jnp.where(accept_slot, new_mut_t, ts.mut_t))
    ledger = ledger._replace(
        log_G=ledger.log_G + jnp.sum(jnp.where(accept_node, delta_per_node, 0.0)))
    return ts, ledger


def branch_reform(carry, keys, evo: EvoParams, pop_params, t_max_tip):
    """Resample all mutation times on one random branch ~ U(t_P, t_X]
    (subrun.cpp:287-320; proposal randomize_branch_mutation_times,
    phylo_tree.cpp:579-645).

    Per-site time ordering on multiply-mutated sites is preserved with a
    double-lexsort: slots grouped by (site) keep their old relative order and
    receive the sorted new times of their group.
    """
    ts, caches, grid, ledger = carry
    k_node, k_prop, k_acc = keys
    N = ts.num_nodes

    X = jax.random.randint(k_node, (), 0, N)
    valid = X != ts.root
    P = jnp.maximum(ts.parent[X], 0)
    t_P, t_X = ts.t[P], ts.t[X]

    mask = (ts.mut_node == X) & valid
    M = ts.mut_t.shape[0]
    u = jax.random.uniform(k_prop, (M,), dtype=jnp.float64, minval=1e-16, maxval=1.0)
    raw = t_P + u * (t_X - t_P)  # in (t_P, t_X]

    # per-site order preservation: group masked slots by site
    group = jnp.where(mask, ts.mut_site.astype(jnp.float64), jnp.inf)
    perm_old = jnp.lexsort((ts.mut_t, group))
    perm_new = jnp.lexsort((raw, group))
    matched = jnp.zeros(M, jnp.float64).at[perm_old].set(raw[perm_new])
    new_mut_t = jnp.where(mask, matched, ts.mut_t)

    qa_tab = evo.qa_tab
    site = jnp.maximum(ts.mut_site, 0)
    mpart = evo.part[site]
    slope = evo.mu * evo.nu[site] * (qa_tab[mpart, jnp.maximum(ts.mut_from, 0)] -
                                     qa_tab[mpart, jnp.maximum(ts.mut_to, 0)])
    delta_log_G = jnp.sum(jnp.where(mask, -slope * (new_mut_t - ts.mut_t), 0.0))

    accept = valid & _mh_accept(k_acc, delta_log_G)
    ts = ts._replace(mut_t=jnp.where(accept, new_mut_t, ts.mut_t))
    ledger = ledger._replace(log_G=ledger.log_G + jnp.where(accept, delta_log_G, 0.0))
    return (ts, caches, grid, ledger)
