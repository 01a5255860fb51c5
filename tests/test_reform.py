"""Ergodicity of mutation-time reform across ALL slot classes.

The device sweep resamples single-(branch,site) slots; two complements close
the remaining holes (reference joint branch redraw, phylo_tree.cpp:579-645):

  1. multi-same-site chains get a host joint redraw-and-sort at each
     topology burst (topo/reform.py) — delta log_G pinned to the oracle;
  2. the single-slot hash classifier is salted per boundary, so a slot
     falsely locked by a hash collision is only locked for that boundary.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from delphy_tpu.phylo import FlatTree, Mutation, NO_NODE
from delphy_tpu.topo.reform import resample_multi_site_chains
from tests.oracles import branch_log_G
from tests.test_likelihood import make_micro_tree


def _total_branch_log_G(tree, mu, nu, q):
    return sum(branch_log_G(tree, x, mu, nu, q)
               for x in range(tree.num_nodes) if x != tree.root)


def test_chain_reform_delta_matches_oracle():
    mu = 0.013
    nu = np.array([1.0, 0.5, 2.0, 1.0, 0.7, 1.3])
    q = np.array([[-3.0, 1.0, 1.0, 1.0],
                  [1.0, -3.0, 1.0, 1.0],
                  [1.0, 1.0, -3.0, 1.0],
                  [1.5, 0.5, 1.0, -3.0]])
    part = np.zeros(6, dtype=np.int32)
    qa_tab = -np.diagonal(q)[None]
    accepted = 0
    for seed in range(12):
        tree = make_micro_tree()
        before = _total_branch_log_G(tree, mu, nu, q)
        old_times = [m.t for m in tree.mutations[3]]
        rng = np.random.default_rng(seed)
        delta = resample_multi_site_chains(tree, rng, mu, nu, part, qa_tab)
        after = _total_branch_log_G(tree, mu, nu, q)
        assert after - before == pytest.approx(delta, abs=1e-9)
        tree.check_integrity()
        new_times = [m.t for m in tree.mutations[3]]
        if new_times != old_times:
            accepted += 1
            # chain stays time-sorted with the same state sequence
            ms = [m for m in tree.mutations[3] if m.site == 1]
            assert ms[0].t <= ms[1].t
            assert (ms[0].from_, ms[0].to, ms[1].from_, ms[1].to) == (1, 3, 3, 0)
            t_p, t_x = tree.t[tree.parent[3]], tree.t[3]
            assert all(t_p < m.t < t_x for m in ms)
    assert accepted >= 3  # the redraw is not a no-op


def test_chain_reform_skips_single_slots():
    """Branches without same-site chains are untouched (they belong to the
    device reform)."""
    mu, nu = 0.013, np.ones(6)
    part = np.zeros(6, dtype=np.int32)
    qa_tab = np.full((1, 4), 3.0)
    tree = make_micro_tree()
    tree.mutations[3] = [Mutation(site=1, from_=1, to=3, t=-8.0)]  # no chain
    times = {x: [m.t for m in tree.mutations[x]] for x in range(5)}
    delta = resample_multi_site_chains(tree, np.random.default_rng(0),
                                       mu, nu, part, qa_tab)
    assert delta == 0.0
    for x in range(5):
        assert [m.t for m in tree.mutations[x]] == times[x]


def test_salted_hash_unlocks_collision_locked_singles():
    """Every truly-single slot must be classified single under MOST salts
    (so its time is refreshed over boundaries), and no multi-same-site slot
    may ever be classified single."""
    from tests.test_sweep import _make_run
    from delphy_tpu.parallel.sweep import build_part_ctx
    from delphy_tpu.mcmc import global_moves as gm

    run = _make_run(seed=31, P=2)
    ts, evo = run.ts, run.evo
    caches = gm.compute_caches(ts, evo)
    pm = run.pm
    b0 = jnp.zeros(run.num_cells, ts.t.dtype)

    # ground truth: exact (part-local node, site) uniqueness
    nm = np.asarray(pm.mut_node_local)
    site = np.asarray(ts.mut_site)[np.maximum(np.asarray(pm.mut_map), 0)]
    valid = np.asarray(pm.mut_map) >= 0
    P, m_cap = nm.shape
    truth_single = np.zeros_like(valid)
    for p in range(P):
        keys = {}
        for j in range(m_cap):
            if valid[p, j]:
                keys.setdefault((nm[p, j], site[p, j]), []).append(j)
        for slots in keys.values():
            if len(slots) == 1:
                truth_single[p, slots[0]] = True

    singles_seen = np.zeros_like(valid)
    n_salts = 24
    for s in range(n_salts):
        salt = jnp.asarray(1 + 7919 * s, jnp.int32)
        ctx = build_part_ctx(pm, ts, caches, evo, b0, salt=salt)
        ms = np.asarray(ctx.mut_single)
        # soundness: never mark a true multi as single
        assert not np.any(ms & valid & ~truth_single)
        singles_seen |= ms
    # ergodicity: every truly-single slot unlocked under at least one salt
    assert np.array_equal(singles_seen & truth_single, truth_single), \
        "some truly-single slot was locked under every salt"
