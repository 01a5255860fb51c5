"""The per-boundary global parameter chains (mcmc/kernel.hky_moves and
mcmc/global_moves.exp_pop_moves) against independent numpy replays of the
reference's move sequences (run.cpp:953-1103 and run.cpp:1237-1319).

The replays draw the same random numbers as the jitted chains (same key
splits, same jax.random calls) and re-run the proposals and MH decisions
with numpy control flow.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from delphy_tpu import pop as popm
from delphy_tpu.evo import make_evo_params, hky_q
from delphy_tpu.ops import coalescent as coal
from delphy_tpu.mcmc.global_moves import PriorConfig, exp_pop_moves
from delphy_tpu.mcmc.kernel import hky_moves

f64 = jnp.float64


# ---------------------------------------------------------------------------
# HKY frequency + kappa chain
# ---------------------------------------------------------------------------

def _hky_setup(seed):
    rng = np.random.default_rng(seed)
    evo = make_evo_params(100, mu=1e-3, kappa=1.7,
                          pi=np.array([0.3, 0.2, 0.25, 0.25]), alpha=10.0)
    Ttwiddle_a = jnp.asarray(rng.uniform(1e4, 1e5, 4))
    M_ab = jnp.asarray(np.where(~np.eye(4, dtype=bool),
                                rng.integers(0, 200, (4, 4)), 0.0))
    root_freq = jnp.asarray(rng.integers(0, 40, 4).astype(np.float64))
    return evo, Ttwiddle_a, M_ab, root_freq


def _hky_draws(key, n_rounds):
    """The numbers hky_moves draws, round by round."""
    out = []
    for _ in range(n_rounds):
        key, kf, kk = jax.random.split(key, 3)
        k_d, k_a, k_b, k_accf = jax.random.split(kf, 4)
        k_s, k_acck = jax.random.split(kk)
        out.append(dict(
            d=float(jax.random.uniform(k_d, (), f64, 0.0, 0.01)),
            ia=int(jax.random.randint(k_a, (), 0, 4)),
            ib=int(jax.random.randint(k_b, (), 0, 3)),
            u_f=float(jax.random.uniform(k_accf, (), f64, 1e-300, 1.0)),
            scale=float(jax.random.uniform(k_s, (), f64, 0.75, 1.0 / 0.75)),
            u_k=float(jax.random.uniform(k_acck, (), f64, 1e-300, 1.0))))
    return out


def _hky_replay(draws, evo, Ttwiddle_a, M_ab, root_freq, hyp):
    kappa = float(evo.kappa)
    pi = np.asarray(evo.pi, np.float64).copy()
    q = np.asarray(hky_q(kappa, pi))
    tt, M, rf = (np.asarray(Ttwiddle_a), np.asarray(M_ab),
                 np.asarray(root_freq))
    mu = float(evo.mu)
    off = ~np.eye(4, dtype=bool)

    def delta_of(new_q, old_q):
        d = -mu * np.sum((-np.diag(new_q) + np.diag(old_q)) * tt)
        with np.errstate(divide="ignore", invalid="ignore"):
            ratio = np.where(old_q > 0,
                             new_q / np.where(old_q > 0, old_q, 1.0), 1.0)
        return d + np.sum(np.where(off & (M > 0), M * np.log(ratio), 0.0))

    for r in draws:
        ia = r["ia"]
        ib = (ia + 1 + r["ib"]) % 4
        new_pi = pi.copy()
        new_pi[ia] += r["d"]
        new_pi[ib] -= r["d"]
        if (0 < new_pi[ia] < 1) and (0 < new_pi[ib] < 1):
            new_q = np.asarray(hky_q(kappa, new_pi))
            delta = delta_of(new_q, q)
            delta += np.sum(np.where(rf > 0, rf * np.log(new_pi / pi), 0.0))
            if delta > 0 or np.log(r["u_f"]) < delta:
                pi, q = new_pi, new_q
        new_kappa = kappa * r["scale"]
        new_q = np.asarray(hky_q(new_kappa, pi))
        m, s = hyp.kappa_prior_mean_log, hyp.kappa_prior_sigma_log
        lpr = ((-(np.log(new_kappa) - m) ** 2 + (np.log(kappa) - m) ** 2)
               / (2 * s * s)) + np.log(kappa / new_kappa)
        log_mh = delta_of(new_q, q) + lpr + np.log(kappa / new_kappa)
        if log_mh > 0 or np.log(r["u_k"]) < log_mh:
            kappa, q = new_kappa, new_q
    return kappa, pi, q


@pytest.mark.parametrize("seed", [0, 4, 9])
def test_hky_moves_match_replay(seed):
    evo, Ttwiddle_a, M_ab, root_freq = _hky_setup(seed)
    hyp = PriorConfig()
    key = jax.random.PRNGKey(seed)
    out = jax.jit(hky_moves, static_argnames=("hyp", "n_rounds"))(
        key, evo, Ttwiddle_a, M_ab, root_freq, hyp, n_rounds=10)
    kappa_r, pi_r, q_r = _hky_replay(_hky_draws(key, 10), evo, Ttwiddle_a,
                                     M_ab, root_freq, hyp)
    assert float(out.kappa) == pytest.approx(kappa_r, rel=1e-9)
    np.testing.assert_allclose(np.asarray(out.pi), pi_r, rtol=1e-9)
    np.testing.assert_allclose(np.asarray(out.q), q_r, rtol=1e-8, atol=1e-12)
    # the chain moved something over 10 rounds
    assert (float(out.kappa) != float(evo.kappa)
            or not np.allclose(np.asarray(out.pi), np.asarray(evo.pi)))


def test_hky_moves_keep_rate_matrix():
    evo, Ttwiddle_a, M_ab, root_freq = _hky_setup(2)
    out = hky_moves(jax.random.PRNGKey(3), evo, Ttwiddle_a, M_ab, root_freq,
                    PriorConfig())
    assert float(jnp.sum(out.pi)) == pytest.approx(1.0, abs=1e-9)
    assert out.q_tab.shape == (1, 4, 4)
    np.testing.assert_allclose(np.asarray(out.q_tab[0]), np.asarray(out.q))
    # q stays a proper rate matrix: rows sum to ~0
    np.testing.assert_allclose(np.asarray(jnp.sum(out.q, axis=1)), 0.0,
                               atol=1e-12)


# ---------------------------------------------------------------------------
# Exponential-population n0 / g chain
# ---------------------------------------------------------------------------

def _make_grid(rng, C=96, N=40):
    t = np.sort(rng.uniform(-300.0, 0.0, N))
    is_tip = np.zeros(N, bool)
    is_tip[rng.permutation(N)[: N // 2 + 1]] = True
    p = popm.ExpPopParams(t0=f64(0.0), n0=f64(500.0), g=f64(0.002),
                          min_pop=f64(1.0))
    grid = coal.make_grid(p, jnp.asarray(t), jnp.asarray(is_tip),
                          f64(-400.0), f64(5.0), C)
    return grid, jnp.asarray(t), jnp.asarray(is_tip), p


def _lp(p, grid, t, is_tip):
    """Coalescent log prior at fixed k_bar, from the closed-form cell
    integrals of the exp pop model."""
    lbs = grid.cell_lbounds()
    nbar = jax.vmap(lambda a: popm.exp_pop_integral(p, a, a + grid.t_step))(
        lbs) / grid.t_step
    nbar = jnp.maximum(nbar, 1e-100)
    quad = -jnp.sum(grid.t_step * grid.k_bar * (grid.k_bar - 1.0)
                    / (2.0 * nbar))
    logN = jnp.log(popm.exp_pop_at_time(p, t))
    return float(quad - jnp.sum(jnp.where(is_tip, 0.0, logN)))


def _pop_draws(key, n_rounds):
    """The numbers exp_pop_moves draws, round by round."""
    out = []
    for _ in range(n_rounds):
        key, k1, k2 = jax.random.split(key, 3)
        k_s, k_acc1 = jax.random.split(k1)
        k_d, k_acc2 = jax.random.split(k2)
        out.append(dict(
            scale=float(jax.random.uniform(k_s, (), f64, 0.75, 1.0 / 0.75)),
            u_n0=float(jax.random.uniform(k_acc1, (), f64, 1e-300, 1.0)),
            delta=float(jax.random.uniform(k_d, (), f64, -1.0 / 365.0,
                                           1.0 / 365.0)),
            u_g=float(jax.random.uniform(k_acc2, (), f64, 1e-300, 1.0))))
    return out


def _pop_replay(draws, p, grid, t, is_tip, hyp):
    n0, g = float(p.n0), float(p.g)

    def lp(n0_, g_):
        return _lp(p._replace(n0=f64(n0_), g=f64(g_)), grid, t, is_tip)

    cur = lp(n0, g)
    for r in draws:
        scale = r["scale"]
        new_n0 = n0 * scale
        lpr = (-(hyp.pop_inv_n0_prior_alpha + 1.0) * np.log(scale)
               - hyp.pop_inv_n0_prior_beta * (1.0 / new_n0 - 1.0 / n0))
        new_lp = lp(new_n0, g)
        log_mh = (new_lp - cur) + lpr - np.log(scale)
        if log_mh > 0 or np.log(r["u_n0"]) < log_mh:
            n0, cur = new_n0, new_lp
        new_g = g + r["delta"]
        ok = hyp.pop_g_min <= new_g <= hyp.pop_g_max
        lpr = (abs(g - hyp.pop_g_prior_mu)
               - abs(new_g - hyp.pop_g_prior_mu)) / hyp.pop_g_prior_scale
        new_lp = lp(n0, new_g)
        log_mh = (new_lp - cur) + lpr
        if ok and (log_mh > 0 or np.log(r["u_g"]) < log_mh):
            g, cur = new_g, new_lp
    return n0, g


_exp_pop_jit = jax.jit(exp_pop_moves, static_argnames=("hyp", "n_rounds"))


@pytest.mark.parametrize("n0,g,mp", [
    (500.0, 0.002, 1.0),     # floor crosses inside the grid (g > 0)
    (500.0, -0.003, 1.0),    # g < 0 crossing
    (500.0, 0.0, 1.0),       # g == 0 with floor
    (500.0, 0.004, 0.0),     # no floor
    (0.5, 0.01, 1.0),        # floor binds over most of the grid
    (2000.0, 0.0, 0.0),      # g == 0, no floor
])
def test_exp_pop_moves_regimes_match_replay(n0, g, mp):
    grid, t, is_tip, p0 = _make_grid(np.random.default_rng(7))
    p = p0._replace(n0=f64(n0), g=f64(g), min_pop=f64(mp))
    hyp = PriorConfig()
    key = jax.random.PRNGKey(11)
    out = _exp_pop_jit(key, p, grid, t, is_tip, hyp, n_rounds=10)
    n0_r, g_r = _pop_replay(_pop_draws(key, 10), p, grid, t, is_tip, hyp)
    assert float(out.n0) == pytest.approx(n0_r, rel=1e-9)
    assert float(out.g) == pytest.approx(g_r, rel=1e-9, abs=1e-15)


@pytest.mark.parametrize("seed", [0, 3])
def test_exp_pop_moves_match_replay(seed):
    grid, t, is_tip, p = _make_grid(np.random.default_rng(seed))
    hyp = PriorConfig()
    key = jax.random.PRNGKey(seed)
    out = _exp_pop_jit(key, p, grid, t, is_tip, hyp, n_rounds=50)
    n0_r, g_r = _pop_replay(_pop_draws(key, 50), p, grid, t, is_tip, hyp)
    assert float(out.n0) == pytest.approx(n0_r, rel=1e-9)
    assert float(out.g) == pytest.approx(g_r, rel=1e-9, abs=1e-15)


def test_exp_pop_moves_updates_params():
    grid, t, is_tip, p = _make_grid(np.random.default_rng(1))
    out = exp_pop_moves(jax.random.PRNGKey(2), p, grid, t, is_tip,
                        PriorConfig())
    assert float(out.n0) > 0.0
    assert PriorConfig().pop_g_min <= float(out.g) <= PriorConfig().pop_g_max
    # 50 rounds should move n0 (the 1/x prior + coalescent data both pull)
    assert float(out.n0) != pytest.approx(float(p.n0))
