"""Global parameter moves (reference Run::run_global_moves, core/run.cpp:695-779).

Design: every global boundary starts from a full recompute of all derived
quantities (the reference does the same via invalidate+validate,
run.cpp:697-698), the moves use closed-form MH/Gibbs deltas, and the ledger is
re-derived from scratch at the end — the "periodic full recompute" discipline
that kills FP drift (run.cpp:632) applied at every boundary, which is cheap
here because the recompute is a handful of O(N+M+L+C) vectorized kernels.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..state import TreeState
from ..evo import EvoParams, hky_q
from .. import pop as popm
from ..ops import likelihood as lk
from ..ops import coalescent as coal
from .moves import Ledger, Caches


@dataclasses.dataclass(frozen=True)
class PriorConfig:
    """Prior hyperparameters and move toggles (reference defaults from
    core/run.cpp:14-41 and core/run.h:256-257)."""
    mu_prior_alpha: float = 1.0
    mu_prior_beta: float = 0.0
    alpha_prior_mean: float = 1.0
    kappa_prior_mean_log: float = 1.0
    kappa_prior_sigma_log: float = 1.25
    pop_inv_n0_prior_alpha: float = 0.0
    pop_inv_n0_prior_beta: float = 0.0
    pop_g_prior_mu: float = 0.001 / 365.0
    pop_g_prior_scale: float = 30.701135 / 365.0
    pop_g_min: float = -math.inf
    pop_g_max: float = math.inf
    skygrid_tau_prior_alpha: float = 0.001
    skygrid_tau_prior_beta: float = 0.001
    skygrid_low_gamma_barrier_enabled: bool = True
    skygrid_low_gamma_barrier_loc: float = 0.0          # log(1.0) (run.cpp:31)
    skygrid_low_gamma_barrier_scale: float = 0.35667494393873245  # -log(0.70)
    skygrid_inv_nbar_prior_alpha: float = 0.0
    skygrid_inv_nbar_prior_beta: float = 0.0
    mu_move_enabled: bool = True
    hky_moves_enabled: bool = True
    alpha_move_enabled: bool = False      # site-rate heterogeneity off by default
    pop_size_move_enabled: bool = True
    pop_growth_rate_move_enabled: bool = True
    skygrid_tau_move_enabled: bool = True
    mu_fixed: bool = False
    mpox_enabled: bool = False


def compute_caches(ts: TreeState, evo: EvoParams) -> Caches:
    ref_cum_Q = lk.calc_ref_cum_Q(ts, evo)
    lam, dlam_miss = lk.calc_lambda_i(ts, evo, ref_cum_Q)
    cnt, _ = lk.calc_ref_state_prefix(ts, evo)
    root_freq = lk.calc_root_state_frequencies(ts, evo, cnt)
    return Caches(lambda_i=lam, dlam_miss=dlam_miss, ref_cum_Q=ref_cum_Q,
                  root_freq=root_freq)


def calc_log_other_priors(evo: EvoParams, pop_params, hyp: PriorConfig):
    """Reference Run::calc_cur_log_other_priors (run.cpp:480-560)."""
    lp = (hyp.mu_prior_alpha - 1.0) * jnp.log(evo.mu) - hyp.mu_prior_beta * evo.mu

    # alpha ~ Exponential(mean 1)
    lp += -evo.alpha / hyp.alpha_prior_mean - jnp.log(hyp.alpha_prior_mean)
    # nu_l ~ Gamma(alpha, alpha)
    L = evo.nu.shape[0]
    lp += L * (evo.alpha * jnp.log(evo.alpha) - jax.lax.lgamma(evo.alpha))
    lp += (evo.alpha - 1.0) * jnp.sum(jnp.log(evo.nu)) - evo.alpha * jnp.sum(evo.nu)

    # kappa ~ log-normal
    s = hyp.kappa_prior_sigma_log
    lp += (-(jnp.log(evo.kappa) - hyp.kappa_prior_mean_log) ** 2 / (2 * s * s)
           - 0.5 * jnp.log(2 * jnp.pi * s * s) - jnp.log(evo.kappa))

    if isinstance(pop_params, popm.ExpPopParams):
        lp += (-(hyp.pop_inv_n0_prior_alpha + 1.0) * jnp.log(pop_params.n0)
               - hyp.pop_inv_n0_prior_beta / pop_params.n0)
        lp += (-jnp.abs(pop_params.g - hyp.pop_g_prior_mu) / hyp.pop_g_prior_scale
               - jnp.log(2.0 * hyp.pop_g_prior_scale))
    elif isinstance(pop_params, popm.SkygridPopParams):
        tau = pop_params.tau
        if hyp.skygrid_tau_move_enabled:
            # tau ~ Gamma prior (Gill et al 2012 Eq. 15; run.cpp:536-541)
            lp += ((hyp.skygrid_tau_prior_alpha - 1.0) * jnp.log(tau)
                   - hyp.skygrid_tau_prior_beta * tau)
        lp += calc_skygrid_gmrf_prior(pop_params, hyp)
    return lp


def calc_skygrid_gmrf_prior(p, hyp: PriorConfig):
    """GMRF prior + N_bar InvGamma + low-population barrier
    (run.cpp:564-608)."""
    gamma, tau = p.gamma, p.tau
    M = gamma.shape[0] - 1
    gamma_bar = jnp.mean(gamma)
    lp = (-hyp.skygrid_inv_nbar_prior_alpha * gamma_bar
          - hyp.skygrid_inv_nbar_prior_beta * jnp.exp(-gamma_bar))
    dg = gamma[1:] - gamma[:-1]
    lp += jnp.sum(0.5 * (jnp.log(tau) - jnp.log(2.0 * jnp.pi)) - 0.5 * dg ** 2 * tau)
    if hyp.skygrid_low_gamma_barrier_enabled:
        excess = jnp.maximum(hyp.skygrid_low_gamma_barrier_loc - gamma, 0.0)
        lp -= jnp.sum((excess / hyp.skygrid_low_gamma_barrier_scale) ** 2)
    return lp


def mu_gibbs_move(key, evo: EvoParams, Ttwiddle_a, num_muts, hyp: PriorConfig):
    """Gibbs sample mu ~ Gamma(M + a, Ttwiddle + b) (run.cpp:781-821)."""
    Ttwiddle = jnp.sum(evo.q_a * Ttwiddle_a)
    shape = num_muts.astype(jnp.float64) + hyp.mu_prior_alpha
    rate = Ttwiddle + hyp.mu_prior_beta
    new_mu = jax.random.gamma(key, shape, dtype=jnp.float64) / rate
    return evo._replace(mu=new_mu)


def hky_frequencies_move(key, evo: EvoParams, Ttwiddle_a, M_ab, root_freq):
    """Delta-exchange on two stationary frequencies (run.cpp:953-1034)."""
    k_d, k_a, k_b, k_acc = jax.random.split(key, 4)
    d = jax.random.uniform(k_d, (), jnp.float64, 0.0, 0.01)
    ia = jax.random.randint(k_a, (), 0, 4)
    ib = (ia + 1 + jax.random.randint(k_b, (), 0, 3)) % 4

    new_pi = evo.pi.at[ia].add(d).at[ib].add(-d)
    ok = (new_pi[ia] > 0.0) & (new_pi[ia] < 1.0) & (new_pi[ib] > 0.0) & (new_pi[ib] < 1.0)
    new_q = hky_q(evo.kappa, new_pi)

    old_qa, new_qa = evo.q_a, -jnp.diagonal(new_q)
    delta = -evo.mu * jnp.sum((new_qa - old_qa) * Ttwiddle_a)
    safe_new_pi = jnp.where(new_pi > 0, new_pi, 1.0)
    delta += jnp.sum(jnp.where(root_freq > 0, root_freq * jnp.log(safe_new_pi / evo.pi), 0.0))
    off = ~jnp.eye(4, dtype=bool)
    safe_ratio = jnp.where(evo.q > 0, new_q / jnp.where(evo.q > 0, evo.q, 1.0), 1.0)
    delta += jnp.sum(jnp.where(off & (M_ab > 0), M_ab * jnp.log(safe_ratio), 0.0))

    u = jax.random.uniform(k_acc, (), jnp.float64, 1e-300, 1.0)
    accept = ok & ((delta > 0) | (jnp.log(u) < delta))
    return jax.tree.map(lambda a, b: jnp.where(accept, a, b),
                        evo._replace(pi=new_pi, q=new_q, q_tab=new_q[None]), evo)


def hky_kappa_move(key, evo: EvoParams, Ttwiddle_a, M_ab, hyp: PriorConfig):
    """Scale move on kappa with log-normal prior (run.cpp:1036-1103)."""
    k_s, k_acc = jax.random.split(key)
    scale = jax.random.uniform(k_s, (), jnp.float64, 0.75, 1.0 / 0.75)
    new_kappa = evo.kappa * scale
    new_q = hky_q(new_kappa, evo.pi)

    m, s = hyp.kappa_prior_mean_log, hyp.kappa_prior_sigma_log
    log_prior_ratio = ((-(jnp.log(new_kappa) - m) ** 2 + (jnp.log(evo.kappa) - m) ** 2)
                       / (2 * s * s)) + jnp.log(evo.kappa / new_kappa)
    log_alpha_ratio = jnp.log(evo.kappa / new_kappa)

    old_qa, new_qa = evo.q_a, -jnp.diagonal(new_q)
    delta = -evo.mu * jnp.sum((new_qa - old_qa) * Ttwiddle_a)
    off = ~jnp.eye(4, dtype=bool)
    safe_ratio = jnp.where(evo.q > 0, new_q / jnp.where(evo.q > 0, evo.q, 1.0), 1.0)
    delta += jnp.sum(jnp.where(off & (M_ab > 0), M_ab * jnp.log(safe_ratio), 0.0))

    log_mh = delta + log_prior_ratio + log_alpha_ratio
    u = jax.random.uniform(k_acc, (), jnp.float64, 1e-300, 1.0)
    accept = (log_mh > 0) | (jnp.log(u) < log_mh)
    return jax.tree.map(lambda a, b: jnp.where(accept, a, b),
                        evo._replace(kappa=new_kappa, q=new_q, q_tab=new_q[None]), evo)


def _sample_truncated_gamma_geq1(key, shape, rate):
    """k ~ Gamma(shape, rate) conditioned on k >= 1 (cf. the reference's
    safe_sample_truncated_gamma, distributions.h).  Vectorized rejection over
    64 draws; if all fall below 1 (overwhelming evidence for k ~= 1), returns
    1 — the conditional's mass is then packed against the boundary anyway."""
    draws = jax.random.gamma(key, shape, (64,), jnp.float64) / rate
    ok = draws >= 1.0
    first = jnp.argmax(ok)
    return jnp.where(jnp.any(ok), draws[first], jnp.float64(1.0))


def mpox_hack_moves(key, evo: EvoParams, M_beta_ab, num_muts,
                    Ttwiddle_beta_a, hyp: PriorConfig):
    """10x pseudo-Gibbs of (mu, rho) under the 2-partition APOBEC model
    (reference mpox_hack_moves, run.cpp:823-952):

      mu | rho ~ Gamma[M + a - 1, b + Ttwiddle + 2 rho Ttwiddle*]
      (1 + 6 rho) | mu ~ Gamma[M* + 1, mu Ttwiddle*/3] truncated to [1, inf)

    with M* = M^1_CT + M^1_GA and Ttwiddle* = Ttwiddle^1_C + Ttwiddle^1_G."""
    A, C, G, T = 0, 1, 2, 3
    M = num_muts.astype(jnp.float64)
    M_star = (M_beta_ab[1, C, T] + M_beta_ab[1, G, A]).astype(jnp.float64)
    Ttwiddle = jnp.sum(Ttwiddle_beta_a)
    Ttwiddle_star = Ttwiddle_beta_a[1, C] + Ttwiddle_beta_a[1, G]

    def body(i, carry):
        mu, rho, key = carry
        key, k_mu, k_rho = jax.random.split(key, 3)
        Ttwiddle_eff = Ttwiddle + 2.0 * rho * Ttwiddle_star
        if hyp.mu_move_enabled and not hyp.mu_fixed:
            mu = (jax.random.gamma(k_mu, M + hyp.mu_prior_alpha - 1.0,
                                   dtype=jnp.float64)
                  / (Ttwiddle_eff + hyp.mu_prior_beta))
        k = _sample_truncated_gamma_geq1(k_rho, M_star + 1.0,
                                         mu * Ttwiddle_star / 3.0)
        rho = jnp.where(Ttwiddle_star > 0.0, (k - 1.0) / 6.0, rho)
        return (mu, rho, key)

    mu, rho, _ = jax.lax.fori_loop(
        0, 10, body, (evo.mu, evo.mpox_rho, key))
    return evo.with_mpox_rho(mu=mu, rho=rho)


def _log_p_alpha(alpha, mu, Ttwiddle_l, M_l):
    """log p(alpha) with nu_l integrated out (run.cpp:1157-1181)."""
    L = M_l.shape[0]
    Mf = M_l.astype(jnp.float64)
    has = M_l > 0
    r = jnp.sum(jnp.where(has, jax.lax.lgamma(Mf + alpha), 0.0))
    r -= jnp.sum((Mf + alpha) * jnp.log(mu * Ttwiddle_l + alpha))
    r -= jnp.sum(has) * jax.lax.lgamma(alpha) - L * alpha * jnp.log(alpha)
    return r


def alpha_and_nu_moves(key, evo: EvoParams, Ttwiddle_l, M_l, hyp: PriorConfig):
    """10 MH scale moves on alpha, then Gibbs sample all nu_l
    (run.cpp:1105-1235)."""
    def body(i, carry):
        alpha, cur_lp, key = carry
        key, k_s, k_acc = jax.random.split(key, 3)
        scale = jax.random.uniform(k_s, (), jnp.float64, 0.90, 1.0 / 0.90)
        new_alpha = alpha * scale
        lp_new = _log_p_alpha(new_alpha, evo.mu, Ttwiddle_l, M_l)
        log_mh = (lp_new - cur_lp
                  - (new_alpha - alpha) / hyp.alpha_prior_mean
                  + jnp.log(alpha / new_alpha))
        u = jax.random.uniform(k_acc, (), jnp.float64, 1e-300, 1.0)
        accept = (log_mh > 0) | (jnp.log(u) < log_mh)
        return (jnp.where(accept, new_alpha, alpha),
                jnp.where(accept, lp_new, cur_lp), key)

    lp0 = _log_p_alpha(evo.alpha, evo.mu, Ttwiddle_l, M_l)
    key, k_nu = jax.random.split(key)
    alpha, _, key = jax.lax.fori_loop(0, 10, body, (evo.alpha, lp0, key))

    # Gibbs: nu_l ~ Gamma(M_l + alpha, mu*Ttwiddle_l + alpha), floored at 1e-50
    # (run.cpp:1105-1155)
    shape = M_l.astype(jnp.float64) + alpha
    rate = evo.mu * Ttwiddle_l + alpha
    nu = jax.random.gamma(k_nu, shape, dtype=jnp.float64) / rate
    nu = jnp.maximum(nu, 1e-50)
    return evo._replace(alpha=alpha, nu=nu)


def skygrid_tau_move(key, p: popm.SkygridPopParams, hyp: PriorConfig):
    """Gibbs: tau ~ Gamma(a + M/2, b + sum(dgamma^2)/2) (run.cpp:1321-1358)."""
    M = p.gamma.shape[0] - 1
    ssq = jnp.sum((p.gamma[1:] - p.gamma[:-1]) ** 2)
    shape = hyp.skygrid_tau_prior_alpha + 0.5 * M
    rate = hyp.skygrid_tau_prior_beta + 0.5 * ssq
    new_tau = jax.random.gamma(key, shape, dtype=jnp.float64) / rate
    return p._replace(tau=new_tau)


def skygrid_zero_mode_gibbs_move(key, p: popm.SkygridPopParams,
                                 grid: coal.CoalGrid, n_inner: int,
                                 hyp: PriorConfig):
    """Gibbs sample the overall population scale via I_bar = exp(-gamma_bar):
    I_bar ~ Gamma(N_inner + alpha, B + beta), with an MH correction for the
    low-gamma barrier (run.cpp:2016-2175)."""
    k_g, k_acc = jax.random.split(key)
    gamma_bar = jnp.mean(p.gamma)
    I_bar = jnp.exp(-gamma_bar)
    B = jnp.sum(0.5 * grid.t_step * grid.k_bar * (grid.k_bar - 1.0)
                / grid.popsize_bar) / I_bar
    shape = n_inner + hyp.skygrid_inv_nbar_prior_alpha
    rate = B + hyp.skygrid_inv_nbar_prior_beta
    new_I_bar = jax.random.gamma(k_g, shape, dtype=jnp.float64) / rate
    delta_gamma_bar = jnp.log(I_bar / new_I_bar)
    new_gamma = p.gamma + delta_gamma_bar

    log_mh = jnp.float64(0.0)
    if hyp.skygrid_low_gamma_barrier_enabled:
        loc, scl = hyp.skygrid_low_gamma_barrier_loc, hyp.skygrid_low_gamma_barrier_scale
        old_b = -jnp.sum((jnp.maximum(loc - p.gamma, 0.0) / scl) ** 2)
        new_b = -jnp.sum((jnp.maximum(loc - new_gamma, 0.0) / scl) ** 2)
        log_mh = new_b - old_b
    blew_up = jnp.any(jnp.isnan(new_gamma)) | jnp.isnan(log_mh)
    u = jax.random.uniform(k_acc, (), jnp.float64, 1e-300, 1.0)
    accept = (~blew_up) & ((log_mh >= 0) | (jnp.log(u) < log_mh))
    return p._replace(gamma=jnp.where(accept, new_gamma, p.gamma))


def skygrid_hmc_move(key, p: popm.SkygridPopParams, grid: coal.CoalGrid,
                     t, is_tip, hyp: PriorConfig):
    """Mass-preconditioned randomized HMC over the gamma_k
    (run.cpp:1360-2014).  Masses m_k = tau*[k>0] + tau*[k<M] + c_k equalize
    the normal-mode frequencies; position Verlet with dt ~ Expo(100/2pi) x 25
    steps; trajectories whose kinetic energy exceeds 100*(M+1) are rejected
    outright on both ends (detailed balance preserved).  Forces come from
    jax.grad of the potential instead of the reference's hand-derived
    d_log_int_N_d_gamma."""
    M = p.gamma.shape[0] - 1
    tau = p.tau
    lbs = grid.cell_lbounds()
    C = grid.num_cells
    inner_t = t  # masked with is_tip below

    # coalescence counts per skygrid interval (clamped to [0, M]; run.cpp:1694-1703)
    kk = jnp.clip(jnp.searchsorted(p.x, t, side="left"), 0, M)
    c_k = jnp.zeros(M + 1, jnp.float64).at[kk].add(jnp.where(is_tip, 0.0, 1.0))

    m_k = jnp.where(jnp.arange(M + 1) > 0, tau, 0.0) \
        + jnp.where(jnp.arange(M + 1) < M, tau, 0.0) + c_k
    m_k = jnp.maximum(m_k, 1e-12)
    inv_m_k = 1.0 / m_k

    def U_fn(gamma):
        q = p._replace(gamma=gamma)
        nbar = jax.vmap(lambda a: popm.skygrid_pop_integral(q, a, a + grid.t_step))(lbs) / grid.t_step
        nbar = jnp.maximum(nbar, 1e-100)
        U_coal = jnp.sum(grid.t_step * grid.k_bar * (grid.k_bar - 1.0) / (2.0 * nbar))
        logN = popm.skygrid_log_N(q, inner_t)
        U_coal += jnp.sum(jnp.where(is_tip, 0.0, logN))
        dg = gamma[1:] - gamma[:-1]
        U_prior = 0.5 * tau * jnp.sum(dg ** 2)
        if hyp.skygrid_low_gamma_barrier_enabled:
            excess = jnp.maximum(hyp.skygrid_low_gamma_barrier_loc - gamma, 0.0)
            U_prior += jnp.sum((excess / hyp.skygrid_low_gamma_barrier_scale) ** 2)
        gamma_bar = jnp.mean(gamma)
        U_prior += (hyp.skygrid_inv_nbar_prior_alpha * gamma_bar
                    + hyp.skygrid_inv_nbar_prior_beta * jnp.exp(-gamma_bar))
        return U_coal + U_prior

    grad_U = jax.grad(U_fn)

    key, k_p, k_dt, k_acc = jax.random.split(key, 4)
    p0 = jax.random.normal(k_p, (M + 1,), jnp.float64) * jnp.sqrt(m_k)
    dt = jax.random.exponential(k_dt, dtype=jnp.float64) * (2.0 * jnp.pi / 100.0)

    def calc_K(mom):
        return jnp.sum(0.5 * mom ** 2 * inv_m_k)

    K_cap = 100.0 * (M + 1)

    def body(i, carry):
        gamma, mom, blown = carry
        gamma = gamma + 0.5 * dt * mom * inv_m_k
        f = -grad_U(gamma)
        mom = mom + dt * f
        blown = blown | (calc_K(mom) > K_cap)
        gamma = gamma + 0.5 * dt * mom * inv_m_k
        return (gamma, mom, blown)

    blown0 = calc_K(p0) > K_cap
    gamma_f, p_f, blown = jax.lax.fori_loop(0, 25, body, (p.gamma, p0, blown0))

    old_H = calc_K(p0) + U_fn(p.gamma)
    new_H = calc_K(p_f) + U_fn(gamma_f)
    log_mh = old_H - new_H
    blown = blown | jnp.any(jnp.isnan(gamma_f)) | jnp.isnan(log_mh)
    u = jax.random.uniform(k_acc, (), jnp.float64, 1e-300, 1.0)
    accept = (~blown) & ((log_mh > 0) | (jnp.log(u) < log_mh))
    return p._replace(gamma=jnp.where(accept, gamma_f, p.gamma))


def exp_pop_moves(key, pop_params: popm.ExpPopParams, grid: coal.CoalGrid,
                  t, is_tip, hyp: PriorConfig, n_rounds: int = 50):
    """50 rounds of n0 scale moves + g random-walk moves (run.cpp:1237-1319).

    k_bar is fixed (node times don't change); each proposal re-evaluates the
    coalescent prior with new popsize_bars in O(C) + O(N).
    """
    lbs = grid.cell_lbounds()

    def coal_log_prior_for(p):
        nbar = jax.vmap(lambda a: popm.exp_pop_integral(p, a, a + grid.t_step))(lbs) / grid.t_step
        nbar = jnp.maximum(nbar, 1e-100)
        quad = -jnp.sum(grid.t_step * grid.k_bar * (grid.k_bar - 1.0) / (2.0 * nbar))
        logN = jnp.log(popm.exp_pop_at_time(p, t))
        return quad - jnp.sum(jnp.where(is_tip, 0.0, logN))

    def n0_move(key, p, cur_lp):
        k_s, k_acc = jax.random.split(key)
        scale = jax.random.uniform(k_s, (), jnp.float64, 0.75, 1.0 / 0.75)
        new_p = p._replace(n0=p.n0 * scale)
        log_prior_ratio = (-(hyp.pop_inv_n0_prior_alpha + 1.0) * jnp.log(scale)
                           - hyp.pop_inv_n0_prior_beta * (1.0 / new_p.n0 - 1.0 / p.n0))
        new_lp = coal_log_prior_for(new_p)
        log_mh = (new_lp - cur_lp) + log_prior_ratio + jnp.log(1.0 / scale)
        u = jax.random.uniform(k_acc, (), jnp.float64, 1e-300, 1.0)
        accept = (log_mh > 0) | (jnp.log(u) < log_mh)
        return (jax.tree.map(lambda a, b: jnp.where(accept, a, b), new_p, p),
                jnp.where(accept, new_lp, cur_lp))

    def g_move(key, p, cur_lp):
        k_d, k_acc = jax.random.split(key)
        delta = jax.random.uniform(k_d, (), jnp.float64, -1.0 / 365.0, 1.0 / 365.0)
        new_g = p.g + delta
        ok = (new_g >= hyp.pop_g_min) & (new_g <= hyp.pop_g_max)
        new_p = p._replace(g=new_g)
        log_prior_ratio = (jnp.abs(p.g - hyp.pop_g_prior_mu)
                           - jnp.abs(new_g - hyp.pop_g_prior_mu)) / hyp.pop_g_prior_scale
        new_lp = coal_log_prior_for(new_p)
        log_mh = (new_lp - cur_lp) + log_prior_ratio
        u = jax.random.uniform(k_acc, (), jnp.float64, 1e-300, 1.0)
        accept = ok & ((log_mh > 0) | (jnp.log(u) < log_mh))
        return (jax.tree.map(lambda a, b: jnp.where(accept, a, b), new_p, p),
                jnp.where(accept, new_lp, cur_lp))

    def body(i, carry):
        p, cur_lp, key = carry
        key, k1, k2 = jax.random.split(key, 3)
        if hyp.pop_size_move_enabled:
            p, cur_lp = n0_move(k1, p, cur_lp)
        if hyp.pop_growth_rate_move_enabled:
            p, cur_lp = g_move(k2, p, cur_lp)
        return (p, cur_lp, key)

    cur_lp = coal_log_prior_for(pop_params)
    p, cur_lp, key = jax.lax.fori_loop(0, n_rounds, body, (pop_params, cur_lp, key))
    return p
