"""Jitted JC mutational-history proposal sampler.

Device twin of the host sampler (delphy_tpu/topo/history.py; reference
core/spr_move.cpp:1164-1370): K-truncated Poisson event counts, Nielsen
rejection to the endpoint constraint, uniformized event times.  This is the
likelihood-heavy inner piece of the SPR proposal expressed as fixed-shape
batched kernels — the building block for moving topology proposals onto the
device.

Distributionally identical to the host sampler (pinned by
tests/test_distributions.py::test_jit_history_matches_host), not
stream-identical: the host consumes numpy RNG draws sequentially, the device
batches threefry draws.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

# static cap on events per site: P(k > 32 | mu*T <~ 1) is astronomically
# small in this engine's regime (branch-length mutation intensities << 1);
# the kernels renormalize within [min_k, KMAX) exactly like the host
# sampler's max_k cutoff (topo/history.py:26)
KMAX = 32


def k_truncated_poisson_weights(lam, min_k: int):
    """Unnormalized Poisson(lam) weights over k in [0, KMAX), zeroed below
    min_k (distributions.h:77-165 analogue, log-space for stability)."""
    k = jnp.arange(KMAX, dtype=lam.dtype)
    logw = k * jnp.log(lam) - jax.lax.lgamma(k + 1.0)
    logw = jnp.where(k >= min_k, logw, -jnp.inf)
    m = jnp.max(logw)
    return jnp.exp(logw - m)


def sample_k_truncated_poisson(key, lam, min_k: int):
    """k ~ Poisson(lam) | k >= min_k via inverse CDF over [min_k, KMAX)."""
    w = k_truncated_poisson_weights(lam, min_k)
    c = jnp.cumsum(w)
    u = jax.random.uniform(key, (), dtype=lam.dtype) * c[-1]
    return jnp.searchsorted(c, u, side="right").astype(jnp.int32)


def _chain_states(key, frm, k_mask):
    """JC 'choose a different state' chain: each active step jumps to one of
    the 3 other states uniformly (topo/history.py:54)."""
    steps = jax.random.randint(key, (KMAX,), 1, 4, dtype=jnp.int32)

    def body(s, inp):
        step, active = inp
        nxt = jnp.where(active, (s + step) % 4, s)
        return nxt, nxt

    end, states = jax.lax.scan(body, frm, (steps, k_mask))
    return end, states


@partial(jax.jit, static_argnames=("min_k",))
def sample_site_history(key, frm, to, T, mu, min_k: int = 1):
    """One site's constrained history: event count k ~ K-trunc-Poisson(mu*T),
    chain of different-state jumps, REJECTED until the chain ends at `to`
    (Nielsen rejection, spr_move.cpp:1164-1240); times uniform on [-T, 0],
    sorted (uniformization).

    Returns (k, to_states[KMAX], times[KMAX]) with entries beyond k padded
    (state -1, time +inf).  Batch with vmap over (key, frm, to).
    """
    lam = mu * T

    def cond(carry):
        _, _, _, ok = carry
        return ~ok

    def body(carry):
        key, _, _, _ = carry
        key, k_key, c_key = jax.random.split(key, 3)
        k = sample_k_truncated_poisson(k_key, lam, min_k)
        mask = jnp.arange(KMAX) < k
        end, states = _chain_states(c_key, frm, mask)
        return key, k, states, end == to

    key, t_key = jax.random.split(key)
    _, k, states, _ = jax.lax.while_loop(
        cond, body, (key, jnp.int32(0), jnp.zeros(KMAX, jnp.int32),
                     jnp.bool_(False)))
    mask = jnp.arange(KMAX) < k
    times = jnp.where(mask,
                      jax.random.uniform(t_key, (KMAX,), dtype=T.dtype,
                                         minval=-T, maxval=0.0),
                      jnp.inf)
    times = jnp.sort(times)
    states = jnp.where(mask, states, -1)
    return k, states, times


@jax.jit
def sample_constrained_histories(key, frm, to, T, mu):
    """Batched constrained site histories: frm/to int32[B] (frm != to).
    Returns (k[B], to_states[B,KMAX], times[B,KMAX])."""
    B = frm.shape[0]
    keys = jax.random.split(key, B)
    return jax.vmap(
        lambda kk, a, b: sample_site_history(kk, a, b, T, mu, min_k=1))(
            keys, frm, to)


@partial(jax.jit, static_argnames=("L",))
def sample_roundtrip_mask(key, L: int, T, mu):
    """Which of L unconstrained sites get a >=2-event round trip.

    The host samples these with a geometric skip whose per-site hit
    probability is 1 - exp(log(1 - p*)) with p* the tricky-site probability
    (topo/history.py:83-99, spr_move.cpp:1258-1297); per-site independent
    Bernoulli is the same distribution, vectorized."""
    muT = mu * T
    p1 = muT * jnp.exp(-muT)
    log_one_minus_p = jnp.where(muT < 1e-4, -0.5 * muT * muT,
                                -muT - jnp.log1p(-p1))
    q = -jnp.expm1(log_one_minus_p)  # per-site tricky probability
    return jax.random.uniform(key, (L,), dtype=q.dtype) < q


@partial(jax.jit, static_argnames=("L",))
def sample_unconstrained_history(key, L: int, T, mu):
    """Backward-Gillespie JC trajectory over L sites on [-T, 0] with every
    site's end state A (spr_move.cpp:1372-1407; host twin
    topo/history.py:120-136): event count ~ Poisson(mu*L*T), event times
    uniform, sites uniform, and per-site state chains built BACKWARD from
    the end state (each event's `to` is the site's state just after it,
    `from` a uniformly different state).

    Returns (k, site[KMAX], frm[KMAX], to[KMAX], t[KMAX]) in forward time
    order, padded with site -1 / time +inf past k.  States are relative to
    end-state A (rotate via adjust_mutational_history semantics on the
    host, topo/history.py:139-156).
    """
    lam = mu * L * T
    k_key, t_key, s_key, c_key = jax.random.split(key, 4)
    k = sample_k_truncated_poisson(k_key, lam, 0)
    mask = jnp.arange(KMAX) < k
    times = jnp.where(mask,
                      jax.random.uniform(t_key, (KMAX,), dtype=T.dtype,
                                         minval=-T, maxval=0.0), -jnp.inf)
    order = jnp.argsort(-times)  # backward: latest event first
    sites = jnp.where(mask, jax.random.randint(s_key, (KMAX,), 0, L), 0)
    steps = jax.random.randint(c_key, (KMAX,), 1, 4, dtype=jnp.int32)

    # walk events backward (permute every per-event array into backward-time
    # order so multi-event sites chain correctly); cur[l] = state of site l
    # at the current time
    sites_b = sites[order]
    steps_b = steps[order]
    active_b = mask[order]

    def body(cur, inp):
        site, step, active = inp
        s_now = cur[site]
        s_prev = (s_now + step) % 4
        cur = jnp.where(active, cur.at[site].set(s_prev), cur)
        return cur, (jnp.where(active, s_prev, -1),
                     jnp.where(active, s_now, -1))

    cur0 = jnp.zeros(L, jnp.int32)  # end state A everywhere
    _, (frm_b, to_b) = jax.lax.scan(body, cur0, (sites_b, steps_b, active_b))

    # back to original slot order, then emit in forward time order
    inv = jnp.argsort(order)
    frm = frm_b[inv]
    to = to_b[inv]
    out_t = jnp.where(mask, times, jnp.inf)
    srt = jnp.argsort(out_t)
    out_sites = jnp.where(mask, sites, -1)
    return (k, out_sites[srt].astype(jnp.int32), frm[srt], to[srt],
            out_t[srt])
