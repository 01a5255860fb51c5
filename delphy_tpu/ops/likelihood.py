"""EMAT likelihood kernels: vectorized segment sums over flat pools.

Reproduces the math of core/phylo_tree_calc.{h,cpp} with an array re-design:

  - per-branch quantities become segment-sums (scatter-adds) over the mutation
    / missation pools keyed by branch index;
  - quantities accumulated down root-to-node paths (lambda_i, missing-site
    counts) become pointer-jumping path sums (log-depth gathers) instead of
    pre-order traversals (cf. calc_lambda_i, phylo_tree_calc.cpp:420-436);
  - quantities accumulated over subtrees (T_below, used by Ttwiddle_*) become
    Euler-tour prefix sums (cf. the Euler-tour traversal with running state of
    calc_Ttwiddle_a, phylo_tree_calc.cpp:224-286).

All functions are pure and jit-friendly; none depends on mutation-pool slot
order (the EMAT branch log-likelihood is order-independent over a branch's
mutation set, see calc_branch_log_G, phylo_tree_calc.h:185-206).
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp

from ..state import TreeState
from ..evo import EvoParams


def _num_doubling_iters(n: int) -> int:
    return max(1, math.ceil(math.log2(max(n, 2))))


def path_sums(parent: jnp.ndarray, delta: jnp.ndarray) -> jnp.ndarray:
    """result[i] = sum of delta over the path root..i (inclusive of both ends).

    Pointer-jumping: O(N log N) work, log-depth gathers — the device replacement
    for the reference's pre-order traversal accumulation.
    """
    n = parent.shape[0]
    acc = delta
    p = parent
    for _ in range(_num_doubling_iters(n)):
        safe_p = jnp.maximum(p, 0)
        acc = acc + jnp.where(p >= 0, acc[safe_p], 0.0)
        p = jnp.where(p >= 0, p[safe_p], -1)
    return acc


def path_sums_int(parent: jnp.ndarray, delta: jnp.ndarray) -> jnp.ndarray:
    n = parent.shape[0]
    acc = delta
    p = parent
    for _ in range(_num_doubling_iters(n)):
        safe_p = jnp.maximum(p, 0)
        acc = acc + jnp.where(p >= 0, acc[safe_p], 0)
        p = jnp.where(p >= 0, p[safe_p], -1)
    return acc


# ---------------------------------------------------------------------------
# Per-site / reference-sequence caches
# ---------------------------------------------------------------------------

def calc_ref_cum_Q(ts: TreeState, evo: EvoParams) -> jnp.ndarray:
    """cum_Q[k] = sum_{l<k} mu * nu_l * q_a(ref_l); length L+1
    (reference calc_cum_Q_l_for_sequence, phylo_tree_calc.cpp:379-388)."""
    site_Q = evo.mu * evo.nu * evo.qa_tab[evo.part, ts.ref_seq]
    return jnp.concatenate([jnp.zeros((1,), jnp.float64), jnp.cumsum(site_Q)])


def calc_ref_state_prefix(ts: TreeState, evo: EvoParams):
    """Prefix counts and nu-weighted prefix sums of ref states.

    cnt[a, k]   = #{l < k : ref_l == a}                  (i64[4, L+1])
    nucum[a, k] = sum_{l < k, ref_l == a} nu_l           (f64[4, L+1])
    Used to evaluate missation-interval contributions in O(1) per interval.
    """
    onehot = jax.nn.one_hot(ts.ref_seq, 4, dtype=jnp.float64).T  # [4, L]
    zeros = jnp.zeros((4, 1), jnp.float64)
    cnt = jnp.concatenate([zeros, jnp.cumsum(onehot, axis=1)], axis=1)
    nucum = jnp.concatenate([zeros, jnp.cumsum(onehot * evo.nu[None, :], axis=1)], axis=1)
    return cnt, nucum


# ---------------------------------------------------------------------------
# lambda_i
# ---------------------------------------------------------------------------

def calc_branch_delta_lambda(ts: TreeState, evo: EvoParams, ref_cum_Q: jnp.ndarray):
    """(dlam_total[n], dlam_miss[n]): change of the sequence mutation intensity
    lambda across each branch — mutations part + missations part
    (reference calc_delta_lambda_across_branch, phylo_tree_calc.h:140-155)."""
    N = ts.num_nodes
    qa_tab = evo.qa_tab

    mut_valid = ts.mut_node >= 0
    mpart = evo.part[jnp.maximum(ts.mut_site, 0)]
    contrib = evo.mu * evo.nu[ts.mut_site] * (
        qa_tab[mpart, jnp.maximum(ts.mut_to, 0)]
        - qa_tab[mpart, jnp.maximum(ts.mut_from, 0)])
    dlam_mut = jnp.zeros(N, jnp.float64).at[jnp.maximum(ts.mut_node, 0)].add(
        jnp.where(mut_valid, contrib, 0.0))

    miss_valid = ts.miss_node >= 0
    iv_contrib = -(ref_cum_Q[jnp.maximum(ts.miss_end, 0)] - ref_cum_Q[jnp.maximum(ts.miss_start, 0)])
    dlam_miss = jnp.zeros(N, jnp.float64).at[jnp.maximum(ts.miss_node, 0)].add(
        jnp.where(miss_valid, iv_contrib, 0.0))

    fs_valid = ts.fs_node >= 0
    fsite = jnp.maximum(ts.fs_site, 0)
    ref_at = ts.ref_seq[fsite]
    fpart = evo.part[fsite]
    fs_contrib = -evo.mu * evo.nu[fsite] * (
        qa_tab[fpart, jnp.maximum(ts.fs_from, 0)] - qa_tab[fpart, ref_at])
    dlam_miss = dlam_miss.at[jnp.maximum(ts.fs_node, 0)].add(jnp.where(fs_valid, fs_contrib, 0.0))

    return dlam_mut + dlam_miss, dlam_miss


def calc_lambda_i(ts: TreeState, evo: EvoParams, ref_cum_Q: jnp.ndarray):
    """lambda_i[n] = mutation intensity of the sequence just above node n
    (reference calc_lambda_i, phylo_tree_calc.cpp:420-436).

    Returns (lambda_i, dlam_miss) — the latter is reused by node-displace moves
    to get the intensity just *below* a node on each child branch."""
    lam_ref = ref_cum_Q[-1]
    dlam, dlam_miss = calc_branch_delta_lambda(ts, evo, ref_cum_Q)
    return lam_ref + path_sums(ts.parent, dlam), dlam_miss


# ---------------------------------------------------------------------------
# Root prior and state frequencies
# ---------------------------------------------------------------------------

def calc_root_state_frequencies(ts: TreeState, evo: EvoParams, cnt_prefix: jnp.ndarray):
    """State counts of the root sequence over non-missing-at-root sites
    (reference calc_log_root_prior bookkeeping, phylo_tree_calc.cpp:467-489)."""
    freq = cnt_prefix[:, -1]  # ref-sequence counts, f64[4]

    is_root_mut = ts.mut_node == ts.root
    d = jnp.zeros(4, jnp.float64)
    d = d.at[jnp.maximum(ts.mut_from, 0)].add(jnp.where(is_root_mut, -1.0, 0.0))
    d = d.at[jnp.maximum(ts.mut_to, 0)].add(jnp.where(is_root_mut, 1.0, 0.0))

    is_root_iv = ts.miss_node == ts.root
    iv_counts = (cnt_prefix[:, jnp.maximum(ts.miss_end, 0)] -
                 cnt_prefix[:, jnp.maximum(ts.miss_start, 0)])  # [4, K]
    d = d - jnp.sum(jnp.where(is_root_iv[None, :], iv_counts, 0.0), axis=1)

    is_root_fs = ts.fs_node == ts.root
    ref_at = ts.ref_seq[jnp.maximum(ts.fs_site, 0)]
    d = d.at[ref_at].add(jnp.where(is_root_fs, 1.0, 0.0))
    d = d.at[jnp.maximum(ts.fs_from, 0)].add(jnp.where(is_root_fs, -1.0, 0.0))

    return freq + d


def calc_log_root_prior(root_freq: jnp.ndarray, evo: EvoParams):
    log_pi = jnp.where(evo.pi > 0.0, jnp.log(jnp.where(evo.pi > 0.0, evo.pi, 1.0)), -jnp.inf)
    terms = jnp.where(root_freq != 0.0, root_freq * log_pi, 0.0)
    return jnp.sum(terms)


# ---------------------------------------------------------------------------
# log_G
# ---------------------------------------------------------------------------

def calc_log_G(ts: TreeState, evo: EvoParams, lambda_i: jnp.ndarray, root_freq: jnp.ndarray):
    """Full augmented genetic log-likelihood: root prior + sum of branch terms
    (reference calc_log_G_below_root + calc_branch_log_G,
    phylo_tree_calc.cpp:506-558, phylo_tree_calc.h:185-206)."""
    n = jnp.arange(ts.num_nodes)
    not_root = n != ts.root
    safe_parent = jnp.maximum(ts.parent, 0)
    branch_terms = jnp.where(not_root, -lambda_i * (ts.t - ts.t[safe_parent]), 0.0)

    real = (ts.mut_node >= 0) & (ts.mut_node != ts.root)
    site = jnp.maximum(ts.mut_site, 0)
    mpart = evo.part[site]
    munu = evo.mu * evo.nu[site]
    rate_ab = evo.q_tab[mpart, jnp.maximum(ts.mut_from, 0), jnp.maximum(ts.mut_to, 0)]
    t_P = ts.t[safe_parent[jnp.maximum(ts.mut_node, 0)]]
    qa_tab = evo.qa_tab
    slope = munu * (qa_tab[mpart, jnp.maximum(ts.mut_from, 0)]
                    - qa_tab[mpart, jnp.maximum(ts.mut_to, 0)])
    per_mut = jnp.log(jnp.where(real, munu * rate_ab, 1.0)) - slope * (ts.mut_t - t_P)
    mut_terms = jnp.where(real, per_mut, 0.0)

    return calc_log_root_prior(root_freq, evo) + jnp.sum(branch_terms) + jnp.sum(mut_terms)


# ---------------------------------------------------------------------------
# Mutation counters
# ---------------------------------------------------------------------------

def calc_num_muts(ts: TreeState):
    real = (ts.mut_node >= 0) & (ts.mut_node != ts.root)
    return jnp.sum(real.astype(jnp.int64))


def calc_num_muts_ab(ts: TreeState):
    real = (ts.mut_node >= 0) & (ts.mut_node != ts.root)
    idx = jnp.maximum(ts.mut_from, 0) * 4 + jnp.maximum(ts.mut_to, 0)
    flat = jnp.zeros(16, jnp.int64).at[idx].add(jnp.where(real, 1, 0))
    return flat.reshape(4, 4)


def calc_num_muts_beta_ab(ts: TreeState, evo: EvoParams):
    """Per-(partition, a, b) mutation counts (reference calc_num_muts_beta_ab,
    phylo_tree_calc.cpp; used by the mpox hack's mu/rho Gibbs moves)."""
    P = evo.q_tab.shape[0]
    real = (ts.mut_node >= 0) & (ts.mut_node != ts.root)
    mpart = evo.part[jnp.maximum(ts.mut_site, 0)]
    idx = (mpart.astype(jnp.int32) * 16
           + jnp.maximum(ts.mut_from, 0) * 4 + jnp.maximum(ts.mut_to, 0))
    flat = jnp.zeros(P * 16, jnp.int64).at[idx].add(jnp.where(real, 1, 0))
    return flat.reshape(P, 4, 4)


def calc_num_muts_l(ts: TreeState):
    real = (ts.mut_node >= 0) & (ts.mut_node != ts.root)
    return jnp.zeros(ts.num_sites, jnp.int64).at[jnp.maximum(ts.mut_site, 0)].add(
        jnp.where(real, 1, 0))


# ---------------------------------------------------------------------------
# Subtree sums (Euler tour) and Ttwiddle quantities
# ---------------------------------------------------------------------------

def calc_T_below(ts: TreeState, tin: jnp.ndarray, tout: jnp.ndarray):
    """Total branch length strictly below each node via Euler-tour prefix sums
    (replaces the post-order accumulation in phylo_tree_calc.cpp:130-141)."""
    N = ts.num_nodes
    safe_parent = jnp.maximum(ts.parent, 0)
    blen = jnp.where(jnp.arange(N) != ts.root, ts.t - ts.t[safe_parent], 0.0)
    vals = jnp.zeros(N, jnp.float64).at[tin].set(blen)
    pref = jnp.cumsum(vals)
    return pref[jnp.maximum(tout - 1, 0)] - pref[tin]


def _mut_T_below(ts: TreeState, T_below: jnp.ndarray):
    """T_below_mut per pool slot: subtree length below each mutation's position
    (phylo_tree_calc.cpp:153-157)."""
    node = jnp.maximum(ts.mut_node, 0)
    is_root = ts.mut_node == ts.root
    return T_below[node] + jnp.where(is_root, 0.0, ts.t[node] - ts.mut_t)


def _miss_T_below(ts: TreeState, T_below: jnp.ndarray, node_arr: jnp.ndarray):
    node = jnp.maximum(node_arr, 0)
    is_root = node_arr == ts.root
    safe_parent = jnp.maximum(ts.parent[node], 0)
    return T_below[node] + jnp.where(is_root, 0.0, ts.t[node] - ts.t[safe_parent])


def calc_Ttwiddle_a(ts: TreeState, evo: EvoParams, tin, tout, nu_prefix: jnp.ndarray):
    """Ttwiddle_a[a] = sum_l nu_l T^(l)_a  (reference calc_Ttwiddle_a /
    calc_Ttwiddle_beta_a with one partition, phylo_tree_calc.cpp:224-369).

    Start from "no mutations" (every site spends the whole tree length in its
    ref state), then correct per mutation / missation — the exact accounting of
    calc_T_l_a (cpp:130-174), with the per-node loops turned into pool-wide
    segment sums.  nu_prefix is calc_ref_state_prefix()[1].
    """
    T_below = calc_T_below(ts, tin, tout)
    T_total = T_below[ts.root]
    tw = nu_prefix[:, -1] * T_total  # [4]

    mvalid = ts.mut_node >= 0
    Tb_mut = _mut_T_below(ts, T_below)
    w = jnp.where(mvalid, evo.nu[jnp.maximum(ts.mut_site, 0)] * Tb_mut, 0.0)
    tw = tw.at[jnp.maximum(ts.mut_from, 0)].add(-w)
    tw = tw.at[jnp.maximum(ts.mut_to, 0)].add(w)

    ivalid = ts.miss_node >= 0
    Tb_iv = _miss_T_below(ts, T_below, ts.miss_node)
    nu_in_iv = (nu_prefix[:, jnp.maximum(ts.miss_end, 0)] -
                nu_prefix[:, jnp.maximum(ts.miss_start, 0)])  # [4, K]
    tw = tw - jnp.sum(jnp.where(ivalid[None, :], nu_in_iv * Tb_iv[None, :], 0.0), axis=1)

    fvalid = ts.fs_node >= 0
    Tb_fs = _miss_T_below(ts, T_below, ts.fs_node)
    site = jnp.maximum(ts.fs_site, 0)
    wf = jnp.where(fvalid, evo.nu[site] * Tb_fs, 0.0)
    tw = tw.at[ts.ref_seq[site]].add(wf)       # undo ref assumption
    tw = tw.at[jnp.maximum(ts.fs_from, 0)].add(-wf)  # apply true from-state
    return tw


def calc_Ttwiddle_l(ts: TreeState, evo: EvoParams, tin, tout):
    """Ttwiddle^(l) = sum_a q_a T^(l)_a per site (reference calc_Ttwiddle_l,
    phylo_tree_calc.cpp:176-222).  Missation intervals are applied with a
    difference-array trick: scatter +/-T_below_miss at interval ends, prefix-sum
    over sites, multiply by q_a(ref_l)."""
    L = ts.num_sites
    qa_tab = evo.qa_tab
    qa_ref = qa_tab[evo.part, ts.ref_seq]  # [L]
    T_below = calc_T_below(ts, tin, tout)
    T_total = T_below[ts.root]
    tl = qa_ref * T_total

    mvalid = ts.mut_node >= 0
    Tb_mut = _mut_T_below(ts, T_below)
    site = jnp.maximum(ts.mut_site, 0)
    mpart = evo.part[site]
    corr = jnp.where(mvalid,
                     (qa_tab[mpart, jnp.maximum(ts.mut_to, 0)]
                      - qa_tab[mpart, jnp.maximum(ts.mut_from, 0)]) * Tb_mut,
                     0.0)
    tl = tl.at[site].add(corr)

    ivalid = ts.miss_node >= 0
    Tb_iv = _miss_T_below(ts, T_below, ts.miss_node)
    diff = jnp.zeros(L + 1, jnp.float64)
    diff = diff.at[jnp.maximum(ts.miss_start, 0)].add(jnp.where(ivalid, Tb_iv, 0.0))
    diff = diff.at[jnp.maximum(ts.miss_end, 0)].add(jnp.where(ivalid, -Tb_iv, 0.0))
    W = jnp.cumsum(diff)[:L]   # W_l = total T_below_miss covering site l
    tl = tl - qa_ref * W

    fvalid = ts.fs_node >= 0
    Tb_fs = _miss_T_below(ts, T_below, ts.fs_node)
    fsite = jnp.maximum(ts.fs_site, 0)
    fpart = evo.part[fsite]
    wf = jnp.where(fvalid, Tb_fs, 0.0)
    tl = tl.at[fsite].add(wf * qa_tab[fpart, ts.ref_seq[fsite]])  # undo ref assumption
    tl = tl.at[fsite].add(-wf * qa_tab[fpart, jnp.maximum(ts.fs_from, 0)])
    return tl


def calc_ref_state_prefix_beta(ts: TreeState, evo: EvoParams):
    """nu-weighted prefix sums of ref states resolved per partition:
    nucum_pa[p, a, k] = sum_{l < k, part_l == p, ref_l == a} nu_l."""
    P = evo.q_tab.shape[0]
    comb = evo.part.astype(jnp.int32) * 4 + ts.ref_seq.astype(jnp.int32)
    onehot = jax.nn.one_hot(comb, P * 4, dtype=jnp.float64).T  # [P*4, L]
    zeros = jnp.zeros((P * 4, 1), jnp.float64)
    nucum = jnp.concatenate(
        [zeros, jnp.cumsum(onehot * evo.nu[None, :], axis=1)], axis=1)
    return nucum.reshape(P, 4, -1)


def calc_Ttwiddle_beta_a(ts: TreeState, evo: EvoParams, tin, tout,
                         nu_prefix_pa: jnp.ndarray):
    """Ttwiddle^beta_a[p, a] = sum_{l in p} nu_l T^(l)_a (reference
    calc_Ttwiddle_beta_a, phylo_tree_calc.cpp:224-369).  The P = 1 reduction
    equals calc_Ttwiddle_a; nu_prefix_pa is calc_ref_state_prefix_beta()."""
    P = evo.q_tab.shape[0]
    T_below = calc_T_below(ts, tin, tout)
    T_total = T_below[ts.root]
    tw = (nu_prefix_pa[:, :, -1] * T_total).reshape(-1)  # [P*4]

    mvalid = ts.mut_node >= 0
    Tb_mut = _mut_T_below(ts, T_below)
    site = jnp.maximum(ts.mut_site, 0)
    mpart = evo.part[site].astype(jnp.int32)
    w = jnp.where(mvalid, evo.nu[site] * Tb_mut, 0.0)
    tw = tw.at[mpart * 4 + jnp.maximum(ts.mut_from, 0)].add(-w)
    tw = tw.at[mpart * 4 + jnp.maximum(ts.mut_to, 0)].add(w)

    ivalid = ts.miss_node >= 0
    Tb_iv = _miss_T_below(ts, T_below, ts.miss_node)
    flat_prefix = nu_prefix_pa.reshape(P * 4, -1)
    nu_in_iv = (flat_prefix[:, jnp.maximum(ts.miss_end, 0)] -
                flat_prefix[:, jnp.maximum(ts.miss_start, 0)])  # [P*4, K]
    tw = tw - jnp.sum(jnp.where(ivalid[None, :], nu_in_iv * Tb_iv[None, :], 0.0),
                      axis=1)

    fvalid = ts.fs_node >= 0
    Tb_fs = _miss_T_below(ts, T_below, ts.fs_node)
    fsite = jnp.maximum(ts.fs_site, 0)
    fpart = evo.part[fsite].astype(jnp.int32)
    wf = jnp.where(fvalid, evo.nu[fsite] * Tb_fs, 0.0)
    tw = tw.at[fpart * 4 + ts.ref_seq[fsite]].add(wf)
    tw = tw.at[fpart * 4 + jnp.maximum(ts.fs_from, 0)].add(-wf)
    return tw.reshape(P, 4)


def calc_num_sites_missing(ts: TreeState, cnt_prefix: jnp.ndarray):
    """Missing-site count at every node = path sum of per-branch missation sizes
    (reference calc_num_sites_missing_at_every_node, phylo_tree_calc.cpp:67-76)."""
    N = ts.num_nodes
    ivalid = ts.miss_node >= 0
    sizes = jnp.where(ivalid, ts.miss_end - ts.miss_start, 0)
    per_node = jnp.zeros(N, jnp.int64).at[jnp.maximum(ts.miss_node, 0)].add(sizes)
    return path_sums_int(ts.parent, per_node)
