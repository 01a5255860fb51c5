"""End-to-end MCMC with topology moves enabled (the full move mix)."""

import numpy as np

from delphy_tpu.sim import simulate_dataset
from delphy_tpu.phylo import build_random_tree
from delphy_tpu.run import Run
from delphy_tpu.mcmc.global_moves import PriorConfig


def make_run(seed=21, T=12, L=150, lmpgm=400):
    ref, deltas, miss, dates, names, truth = simulate_dataset(
        T, L, mu=3e-3, missing_fraction=0.1, seed=seed)
    tree = build_random_tree(ref, deltas, miss, dates, names=names,
                             rng=np.random.default_rng(seed))
    return Run(tree, seed=seed, hyp=PriorConfig(), num_cells=128,
               local_moves_per_global_move=lmpgm,
               topology_moves_enabled=True), truth


def test_full_mix_ledger_and_integrity():
    run, _ = make_run()
    # topology debt persists across calls (run.py); pin the burst cadence
    # tight so this short window actually exercises bursts
    run.topology_burst_chunks = 1
    parents0 = np.asarray(run.ts.parent).copy()
    for _ in range(5):
        run.do_mcmc_steps(400)
        run.check_derived_quantities(tol=1e-6)
    assert run.topology_proposed > 0
    assert run.topology_accepted > 0
    tree = run.tree()
    tree.check_integrity()
    assert not np.array_equal(np.asarray(run.ts.parent), parents0), \
        "topology never changed"


def test_full_mix_tip_data_preserved():
    run, _ = make_run(seed=23)
    before = run.tree()
    seqs = [before.sequence_at(i) for i in range(before.num_tips)]
    missing = [before.missing_sites_at(i) for i in range(before.num_tips)]
    run.do_mcmc_steps(2000)
    after = run.tree()
    after.check_integrity()
    for i in range(after.num_tips):
        assert after.missing_sites_at(i) == missing[i]
        got = after.sequence_at(i)
        for l in range(after.num_sites):
            if l not in missing[i]:
                assert got[l] == seqs[i][l]


def test_full_mix_determinism():
    run_a, _ = make_run(seed=29)
    run_b, _ = make_run(seed=29)
    run_a.do_mcmc_steps(800)
    run_b.do_mcmc_steps(800)
    assert run_a.log_posterior == run_b.log_posterior
    np.testing.assert_array_equal(np.asarray(run_a.ts.parent),
                                  np.asarray(run_b.ts.parent))

def test_partitioned_burst_log_coal_fresh():
    """After a partitioned topology burst, ledger.log_coal must track the
    tree (refreshed from the post-burst grid), not go stale for the rest of
    the boundary window."""
    ref, deltas, miss, dates, names, _ = simulate_dataset(
        100, 300, mu=2e-3, missing_fraction=0.05, seed=31)
    tree = build_random_tree(ref, deltas, miss, dates, names=names,
                             rng=np.random.default_rng(31))
    run = Run(tree, seed=31, hyp=PriorConfig(), num_cells=128,
              local_moves_per_global_move=500,
              topology_moves_enabled=True, topology_partitions=4,
              topology_parallel_processes=False)
    run.topology_burst_chunks = 1  # tight cadence within this short window
    run.do_mcmc_steps(4000)
    assert run.topology_proposed > 0
    got = float(run.ledger.log_coal)
    want = float(run.calc_cur_ledger().log_coal)
    # the refresh uses the host grid (<=400 cells) vs the device ledger grid:
    # allow quadrature placement differences, but catch O(move-delta)
    # staleness
    assert abs(got - want) < 0.02 * abs(want) + 0.5, (got, want)

def test_burst_amortization_statistics():
    """Amortized topology bursts (debt paid every K boundaries) must sample
    the same posterior as tight per-boundary bursts: compare topology
    acceptance fraction and posterior log_post mean on a small problem
    (cadence coupling)."""
    from delphy_tpu.ess import ess

    def sample(K):
        run, _ = make_run(seed=37, T=16, L=250, lmpgm=300)
        run.topology_burst_chunks = K
        lps = []
        # this high-mutation-load problem has a long equilibration transient
        # (measured round 4: log_post still drifting at 45k, plateaus near
        # -38k by ~90k steps for both cadences); means compared during the
        # transient are cadence-sensitive for the wrong reason
        run.do_mcmc_steps(90_000)
        for _ in range(30):
            run.do_mcmc_steps(1200)
            lps.append(run.log_posterior)
        acc = run.topology_accepted / max(1, run.topology_proposed)
        return np.asarray(lps), acc

    lps_tight, acc_tight = sample(K=1)
    lps_amort, acc_amort = sample(K=8)
    assert 0.05 < acc_tight < 0.95 and 0.05 < acc_amort < 0.95
    # acceptance fractions agree within a loose band (same move machinery,
    # different interleaving)
    assert abs(acc_tight - acc_amort) < 0.25, (acc_tight, acc_amort)
    # posterior locations agree within joint MC error x5.  The samples are
    # strongly autocorrelated at this spacing, so the MCSE must divide by
    # the EFFECTIVE sample size, not the raw count (an iid s/sqrt(n) was
    # measured ~3x too small here and made the test a coin flip).

    def mcse(x):
        return x.std() / np.sqrt(max(ess(x), 1.0))

    se = np.hypot(mcse(lps_tight), mcse(lps_amort))
    assert abs(lps_tight.mean() - lps_amort.mean()) < 5.0 * se + 20.0, \
        (lps_tight.mean(), lps_amort.mean(), se)
