"""Replay of the reference's hand-built test fixture.

The reference validates its likelihood bookkeeping on one explicit 5-node
tree with a 2-partition evolution model, inner-node missations and an
above-root delta (tests/phylo_tree_calc_tests.cpp:14-116).  This module
rebuilds that EXACT scenario — same topology, times, mutations, missations,
rate matrices — and asserts our kernels reproduce the same analytically
derived expectations (ported from the EXPECT blocks at
phylo_tree_calc_tests.cpp:236-441).  Since the reference binary cannot be
built in this environment, replaying its fixtures is the cross-engine
contract check.

Reference tree (phylo_tree_calc_tests.cpp:16-27):

  Time:             -1.0          0.0        1.0        2.0        3.0
                                   +-- T0C -- a (CANN)
                                   |
                      +A2N- A0T ---+ x (TANN)
                      |            |
  (AACA) A3N- C2A --+ r (AAAN)     +-------- A1G ------- b (TGNN)
                      |
                      +A1N--------A0T------- T0G ------------------ c (GNAN)
"""

import numpy as np
import pytest

import jax.numpy as jnp

from delphy_tpu.evo import make_evo_params
from delphy_tpu.phylo import FlatTree, Mutation, NO_NODE
from delphy_tpu.state import pack_state
from delphy_tpu.ops import likelihood as lk

A, C, G, T = 0, 1, 2, 3

# node indices (tips-first layout; reference uses r=0,x=1,a=2,b=3,c=4)
a, b, c, x, r = 0, 1, 2, 3, 4

NU = np.array([0.2, 0.3, 0.4, 0.5])
PART = np.array([0, 1, 0, 1], dtype=np.int32)
MU_P = np.array([0.1, 1.1])          # per-partition mu, folded into q_tab
PI_P = np.array([[0.05, 0.15, 0.25, 0.55],
                 [0.07, 0.17, 0.23, 0.53]])


def _q0():
    q = np.array([[0.0, 0.6, 0.7, 0.8],
                  [0.9, 0.0, 1.0, 1.1],
                  [1.2, 1.3, 0.0, 1.4],
                  [1.5, 1.6, 1.7, 0.0]])
    np.fill_diagonal(q, -q.sum(axis=1))
    return q


def _q1():
    q = np.array([[0.0, 2.6, 2.7, 2.8],
                  [2.9, 0.0, 3.0, 3.1],
                  [3.2, 3.3, 0.0, 3.4],
                  [3.5, 3.6, 3.7, 0.0]])
    np.fill_diagonal(q, -q.sum(axis=1))
    return q


def mu_l(l):
    return MU_P[PART[l]]


def q_l_ab(l, i, j):
    return (_q0() if PART[l] == 0 else _q1())[i, j]


def q_l_a(l, i):
    return -q_l_ab(l, i, i)


@pytest.fixture(scope="module")
def fixture():
    ref = np.array([A, A, C, A], dtype=np.int8)
    parent = np.array([x, x, r, r, NO_NODE], dtype=np.int32)
    children = np.full((5, 2), NO_NODE, dtype=np.int32)
    children[x] = [a, b]
    children[r] = [x, c]
    t = np.array([1.0, 2.0, 3.0, 0.0, -1.0])
    t_min = np.array([1.0, 2.0, 3.0, -np.inf, -np.inf])
    t_max = np.array([1.0, 2.0, 3.0, np.inf, np.inf])

    mutations = [[] for _ in range(5)]
    mutations[r] = [Mutation(site=2, from_=C, to=A, t=-1e30)]  # above-root delta
    mutations[x] = [Mutation(site=0, from_=A, to=T, t=-0.5)]
    mutations[a] = [Mutation(site=0, from_=T, to=C, t=0.5)]
    mutations[b] = [Mutation(site=1, from_=A, to=G, t=1.0)]
    mutations[c] = [Mutation(site=0, from_=A, to=T, t=0.0),
                    Mutation(site=0, from_=T, to=G, t=1.0)]

    miss_intervals = [[] for _ in range(5)]
    miss_from_states = [{} for _ in range(5)]
    miss_intervals[r] = [(3, 4)]          # A3N (from A == ref: canonical omit)
    miss_intervals[x] = [(2, 3)]          # A2N: state above x is A, ref is C
    miss_from_states[x] = {2: A}
    miss_intervals[c] = [(1, 2)]          # A1N (from A == ref)

    tree = FlatTree(parent=parent, children=children, t=t, t_min=t_min,
                    t_max=t_max, root=r, ref_seq=ref, mutations=mutations,
                    miss_intervals=miss_intervals,
                    miss_from_states=miss_from_states,
                    name=["a", "b", "c", "x", "r"])
    tree.check_integrity()

    # 2-partition model: per-partition mu folded into q_tab (our EvoParams
    # keeps a single global mu; mu_l(l) * q_l == mu * (mu_p * q_p))
    evo = make_evo_params(4, mu=1.0, kappa=1.0, alpha=1.0, nu=NU, part=PART)
    q_tab = jnp.asarray(np.stack([MU_P[0] * _q0(), MU_P[1] * _q1()]))
    evo = evo._replace(q_tab=q_tab)

    ts = pack_state(tree, 16, 8, 8)
    tin, tout = tree.euler_positions()
    return tree, ts, evo, jnp.asarray(tin), jnp.asarray(tout)


# expected per-site, per-state presence times (calc_T_l_a,
# phylo_tree_calc_tests.cpp:285-313)
def _T_l_a():
    e = np.zeros((4, 4))
    e[0][A] += 0.5; e[0][T] += 0.5          # r->x around A0T
    e[0][T] += 0.5; e[0][C] += 0.5          # x->a around T0C
    e[0][T] += 2.0                          # x->b
    e[0][A] += 1.0; e[0][T] += 1.0; e[0][G] += 2.0  # r->c, A0T then T0G
    e[1][A] += 1.0                          # r->x
    e[1][A] += 1.0                          # x->a
    e[1][A] += 1.0; e[1][G] += 1.0          # x->b around A1G
    e[2][A] += 4.0                          # r->c (missing elsewhere)
    return e


def test_num_muts(fixture):
    _, ts, evo, _, _ = fixture
    assert int(lk.calc_num_muts(ts)) == 5  # C2A above root not counted


def test_num_muts_ab(fixture):
    _, ts, evo, _, _ = fixture
    M = np.asarray(lk.calc_num_muts_ab(ts))
    e = np.zeros((4, 4), dtype=np.int64)
    e[A][T] += 2   # A0T on r->x and on r->c
    e[T][C] += 1   # T0C on x->a
    e[A][G] += 1   # A1G on x->b
    e[T][G] += 1   # T0G on r->c
    assert (M == e).all()


def test_num_muts_beta_ab(fixture):
    _, ts, evo, _, _ = fixture
    M = np.asarray(lk.calc_num_muts_beta_ab(ts, evo))
    e = np.zeros((2, 4, 4), dtype=np.int64)
    e[0][A][T] += 2
    e[0][T][C] += 1
    e[0][T][G] += 1
    e[1][A][G] += 1
    assert (M == e).all()


def test_num_muts_l(fixture):
    _, ts, evo, _, _ = fixture
    got = np.asarray(lk.calc_num_muts_l(ts))
    assert (got == np.array([4, 1, 0, 0])).all()


def test_calc_T(fixture):
    tree, ts, evo, tin, tout = fixture
    T_below = np.asarray(lk.calc_T_below(ts, tin, tout))
    assert T_below[r] == pytest.approx(1.0 + 1.0 + 2.0 + 4.0, abs=1e-9)


def test_Ttwiddle_a(fixture):
    _, ts, evo, tin, tout = fixture
    _, nucum = lk.calc_ref_state_prefix(ts, evo)
    got = np.asarray(lk.calc_Ttwiddle_a(ts, evo, tin, tout, nucum))
    e = (NU[:, None] * _T_l_a()).sum(axis=0)
    np.testing.assert_allclose(got, e, atol=1e-9)


def test_Ttwiddle_beta_a(fixture):
    _, ts, evo, tin, tout = fixture
    pre = lk.calc_ref_state_prefix_beta(ts, evo)
    got = np.asarray(lk.calc_Ttwiddle_beta_a(ts, evo, tin, tout, pre))
    e = np.zeros((2, 4))
    for l in range(4):
        e[PART[l]] += NU[l] * _T_l_a()[l]
    np.testing.assert_allclose(got, e, atol=1e-9)


def test_Ttwiddle_l(fixture):
    _, ts, evo, tin, tout = fixture
    got = np.asarray(lk.calc_Ttwiddle_l(ts, evo, tin, tout))
    # NOTE our Ttwiddle_l excludes the per-partition mu factor folded into
    # q_tab?  No: Ttwiddle_l[l] = sum_a q_l_a(l,a) T_l_a[l][a] with q from
    # q_tab (mu_p folded in), exactly the reference's q_l_a times mu_p.
    e = np.array([sum(MU_P[PART[l]] * q_l_a(l, s) * _T_l_a()[l][s]
                      for s in range(4)) for l in range(4)])
    np.testing.assert_allclose(got, e, atol=1e-9)


def test_lambda_i(fixture):
    """lambda_i[n] = sum over sites present at n of mu_l nu_l q_l_a(state)
    (phylo_tree_calc_tests.cpp:557-607)."""
    _, ts, evo, _, _ = fixture
    ref_cum_Q = lk.calc_ref_cum_Q(ts, evo)
    lam, _ = lk.calc_lambda_i(ts, evo, ref_cum_Q)
    lam = np.asarray(lam)

    def lam_of(states, present):
        return sum(MU_P[PART[l]] * NU[l] * q_l_a(l, states[l])
                   for l in range(4) if present[l])

    # sequences just above each node (reference view_of_sequence_at with the
    # branch's own mutations EXCLUDED: lambda_i is the intensity entering)
    # reference calc_lambda_i uses the sequence AT the node (all own branch
    # mutations applied); expected tables below use the node sequences
    # r: AAAN, x: TANN, a: CANN, b: TGNN, c: GNAN
    exp = {
        r: lam_of([A, A, A, A], [1, 1, 1, 0]),
        x: lam_of([T, A, A, A], [1, 1, 0, 0]),
        a: lam_of([C, A, A, A], [1, 1, 0, 0]),
        b: lam_of([T, G, A, A], [1, 1, 0, 0]),
        c: lam_of([G, A, A, A], [1, 0, 1, 0]),
    }
    for n, e in exp.items():
        assert lam[n] == pytest.approx(e, abs=1e-9), f"node {n}"


def test_log_G_below_root(fixture):
    """Port of phylo_tree_calc_tests.cpp:381-439 (calc_log_G_below_root)."""
    _, ts, evo, _, _ = fixture
    caches_lam, _ = lk.calc_lambda_i(ts, evo, lk.calc_ref_cum_Q(ts, evo))
    cnt, _ = lk.calc_ref_state_prefix(ts, evo)
    root_freq = lk.calc_root_state_frequencies(ts, evo, cnt)
    log_G = float(lk.calc_log_G(ts, evo, caches_lam, root_freq))
    log_root = float(lk.calc_log_root_prior(root_freq, evo))
    got = log_G - log_root

    def mnq(l, s):
        return mu_l(l) * NU[l] * q_l_a(l, s)

    def mnq_ab(l, i, j):
        return mu_l(l) * NU[l] * q_l_ab(l, i, j)

    e = 0.0
    # site 0
    e += (-mnq(0, A) * 0.5 + np.log(mnq_ab(0, A, T)) - mnq(0, T) * 0.5   # r-x
          - mnq(0, T) * 0.5 + np.log(mnq_ab(0, T, C)) - mnq(0, C) * 0.5  # x-a
          - mnq(0, T) * 2.0                                              # x-b
          - mnq(0, A) * 1.0 + np.log(mnq_ab(0, A, T))                    # r-c
          - mnq(0, T) * 1.0 + np.log(mnq_ab(0, T, G)) - mnq(0, G) * 2.0)
    # site 1
    e += (-mnq(1, A) * 1.0                                               # r-x
          - mnq(1, A) * 1.0                                              # x-a
          - mnq(1, A) * 1.0 + np.log(mnq_ab(1, A, G)) - mnq(1, G) * 1.0)  # x-b
    # site 2 (missing except r-c)
    e += -mnq(2, A) * 4.0
    # site 3: missing everywhere
    assert got == pytest.approx(e, abs=1e-6)


def test_num_sites_missing(fixture):
    """phylo_tree_calc_tests.cpp:497-505: r: AAAN=1, x/a/b/c: 2 each."""
    _, ts, evo, _, _ = fixture
    cnt, _ = lk.calc_ref_state_prefix(ts, evo)
    got = np.asarray(lk.calc_num_sites_missing(ts, cnt))
    e = np.zeros(5, dtype=np.int64)
    e[[r, x, a, b, c]] = [1, 2, 2, 2, 2]
    assert (got == e).all()
