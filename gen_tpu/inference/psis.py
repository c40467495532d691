"""Pareto-smoothed importance sampling (PSIS) and the k-hat diagnostic.

No reference analogue: Gen.jl's importance sampling reports raw normalized
weights with no reliability diagnostic. PSIS (Vehtari, Simpson, Gelman,
Yao & Gabry 2024, JMLR) fits a generalized Pareto distribution (GPD) to
the largest importance ratios and

  * replaces the noisy tail weights by the expected order statistics of
    the fitted GPD (stabilizing IS estimates), and
  * reports the shape k-hat — THE reliability diagnostic: k < 0.5 means
    finite-variance ratios (CLT applies); 0.5 <= k < 0.7 usable;
    k >= 0.7 means the proposal is too narrow and the estimate should not
    be trusted, no matter how many samples were drawn.

accelerator-native: everything is fixed-shape jnp given a static sample count —
one sort, a fixed-size tail slice, and the Zhang & Stephens (2009)
profile-posterior GPD fit as a small batched reduction — so `psis` jits
and composes with vmapped/sharded importance sampling.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from ..utils import logsumexp


def gpd_fit(x):
    """Fit GPD(sigma, k) to exceedances ``x`` (1-D, sorted ascending,
    positive) by the Zhang & Stephens (2009) profile posterior with the
    weak prior regularization used by PSIS. Returns (k, sigma)."""
    x = jnp.asarray(x)
    n = x.shape[0]
    prior_bs, prior_k = 3.0, 10.0
    m_est = 30 + int(float(n) ** 0.5)

    jj = jnp.arange(1, m_est + 1, dtype=x.dtype)
    quart = x[int(n / 4 + 0.5) - 1]
    b = 1.0 - jnp.sqrt(m_est / (jj - 0.5))
    b = b / (prior_bs * quart) + 1.0 / x[-1]

    k_b = jnp.log1p(-b[:, None] * x[None, :]).mean(axis=1)      # (m,)
    log_lik = n * (jnp.log(-b / k_b) - k_b - 1.0)
    w = jnp.exp(log_lik - logsumexp(log_lik))
    b_post = jnp.sum(b * w)
    k_post = jnp.log1p(-b_post * x).mean()
    k_post = (n * k_post + prior_k * 0.5) / (n + prior_k)
    sigma = -k_post / b_post
    return k_post, sigma


def _gpd_quantile(p, k, sigma):
    """Inverse CDF of GPD with location 0: sigma/k * (1 - (1-p)^k)
    (limit -sigma*log(1-p) as k -> 0)."""
    safe_k = jnp.where(jnp.abs(k) < 1e-12, 1.0, k)
    q = sigma * jnp.expm1(-safe_k * jnp.log1p(-p)) / safe_k
    q0 = -sigma * jnp.log1p(-p)
    return jnp.where(jnp.abs(k) < 1e-12, q0, q)


class PSISResult(NamedTuple):
    log_weights: jnp.ndarray   # smoothed, same normalization as the input
    khat: jnp.ndarray          # GPD shape diagnostic
    tail_len: int              # number of smoothed tail weights


def psis(log_weights):
    """Pareto-smooth a vector of (unnormalized) log importance weights.

    Returns :class:`PSISResult`. The tail length follows the paper:
    M = min(S/5, 3*sqrt(S)). If the tail is degenerate (all equal — e.g.
    an exact proposal) the weights are returned unsmoothed with
    khat = -inf.
    """
    lw = jnp.asarray(log_weights)
    s = lw.shape[0]
    m = int(min(0.2 * s, 3.0 * float(s) ** 0.5))
    if m < 5 or s < 16:
        return PSISResult(lw, jnp.asarray(-jnp.inf, lw.dtype), 0)

    order = jnp.argsort(lw)
    lw_sorted = lw[order]
    # stabilize: work relative to the max weight
    shift = lw_sorted[-1]
    tail = jnp.exp(lw_sorted[-m:] - shift)           # ascending, in (0, 1]
    cutoff = jnp.exp(lw_sorted[-m - 1] - shift)
    exceed = tail - cutoff                           # > 0 (up to ties)

    ok = exceed[-1] > 0                              # non-degenerate tail
    exceed_safe = jnp.where(ok, jnp.maximum(exceed, 1e-30), jnp.ones(m))
    k, sigma = gpd_fit(exceed_safe)

    # expected order statistics of the fitted GPD, capped at the max ratio
    p = (jnp.arange(1, m + 1) - 0.5) / m
    smoothed = jnp.minimum(_gpd_quantile(p, k, sigma) + cutoff, tail[-1])
    new_tail = jnp.log(jnp.maximum(smoothed, 1e-38)) + shift
    new_sorted = jnp.where(ok, lw_sorted.at[-m:].set(new_tail), lw_sorted)

    # inverse permutation via gather (a scatter here lowers to the slow
    # per-element path under vmap — CLAUDE.md's 84x trap)
    out = new_sorted[jnp.argsort(order)]
    khat = jnp.where(ok, k, -jnp.inf)
    return PSISResult(out, khat, m)


def psis_effective_sample_size(log_weights):
    """ESS of (possibly smoothed) log weights: 1 / sum(w_norm^2)."""
    lw = jnp.asarray(log_weights)
    lnw = lw - logsumexp(lw)
    return jnp.exp(-logsumexp(2.0 * lnw))
