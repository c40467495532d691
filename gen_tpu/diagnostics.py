"""MCMC convergence diagnostics: rank-normalized split-R-hat, bulk/tail
effective sample size, and Monte-Carlo standard errors.

No reference analogue: Gen.jl ships no convergence diagnostics (its tests
compare posterior moments directly). A production many-chain accelerator workflow
needs them — with 10^5 vmapped chains the whole point is cross-chain
diagnostics. All functions are pure jnp on ``(draws, chains)`` arrays (or
pytrees of them via :func:`summarize`), so they jit and run on-device:
autocovariance is one batched FFT, rank normalization is two argsorts, and
the Geyer truncation is the same cumsum masking used in bench.py.

Definitions follow Vehtari, Gelman, Simpson, Carpenter & Bürkner (2021),
"Rank-normalization, folding, and localization: an improved R-hat for
assessing convergence of MCMC":

* chains are split in half (so within-chain trends show up as
  between-chain variance),
* draws are rank-normalized (pooled average ranks -> normal scores via the
  Blom offset (r - 3/8)/(S + 1/4)) so the statistics are defined for any
  continuous distribution without moment assumptions,
* R-hat is the max of the rank-normalized split-R-hat of the draws and of
  the draws folded about their median (catches scale mismatch),
* bulk-ESS uses the multi-chain autocorrelation
  rho_t = 1 - (W - mean_m acov_{m,t}) / var_plus with Geyer's initial
  monotone positive sequence; tail-ESS is the min ESS of the 5%/95%
  exceedance indicators.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def _split_chains(x):
    """(N, M) -> (N//2, 2M): split each chain in half (drop odd draw)."""
    n = (x.shape[0] // 2) * 2
    x = x[:n]
    half = n // 2
    return jnp.concatenate([x[:half], x[half:]], axis=1)


def _rank_normalize(x):
    """Pooled average-rank normal scores (Blom), shape-preserving.

    Ties get AVERAGE ranks (two searchsorteds into the sorted pool) — with
    ordinal tie-breaking, tied runs (e.g. the tail-ESS indicators) would
    inherit ranks in draw order and fabricate autocorrelation."""
    from jax.scipy.special import ndtri
    shape = x.shape
    flat = x.reshape(-1)
    s = flat.shape[0]
    srt = jnp.sort(flat)
    lo = jnp.searchsorted(srt, flat, side="left")
    hi = jnp.searchsorted(srt, flat, side="right")
    # TAIL-SAFE normal scores (round-5 fix): the naive
    # ndtri((rank - 0.375) / (s + 0.25)) computes p by dividing two
    # nearly equal f32 numbers for top ranks — at pooled sizes past
    # ~2^23 (e.g. 6000 draws x 2048 chains) both round to the SAME f32
    # and p == 1.0 exactly, so ndtri returns inf and every downstream
    # statistic is NaN (which a max-against-0 gate then silently
    # passes). Use the symmetric form: the upper half goes through
    # 1 - p with the small numerator (s - rank + 0.625) built from
    # EXACT integer arithmetic, precise exactly where precision
    # matters.
    m2 = lo + hi + 1                     # 2 * rank (exact int)
    num_lo = m2.astype(jnp.float32) / 2.0 - 0.375
    num_hi = (2 * s - m2).astype(jnp.float32) / 2.0 + 0.625
    den = jnp.float32(s + 0.25)
    z = jnp.where(m2 <= s + 1,
                  ndtri(num_lo / den),
                  -ndtri(num_hi / den))
    return z.reshape(shape).astype(jnp.result_type(x, jnp.float32))


def _autocov(x):
    """Per-chain FFT autocovariance; x: (N, M) -> (N, M)."""
    n = x.shape[0]
    xc = x - x.mean(axis=0, keepdims=True)
    nfft = 2 * n
    f = jnp.fft.rfft(xc, n=nfft, axis=0)
    acov = jnp.fft.irfft(f * jnp.conj(f), n=nfft, axis=0)[:n].real
    return acov / n


def _split_rhat(x):
    """Split-R-hat of already-(optionally rank-)normalized draws (N, M)."""
    z = _split_chains(x)
    n, m = z.shape
    chain_means = z.mean(axis=0)
    b = n * jnp.var(chain_means, ddof=1)
    w = jnp.mean(jnp.var(z, axis=0, ddof=1))
    var_plus = (n - 1) / n * w + b / n
    return jnp.sqrt(var_plus / w)


def rhat(x):
    """Rank-normalized split-R-hat (max of bulk and folded variants).

    ``x``: (draws, chains). Values near 1 (< 1.01) indicate convergence."""
    x = jnp.asarray(x)
    bulk = _split_rhat(_rank_normalize(x))
    folded = _split_rhat(_rank_normalize(jnp.abs(x - jnp.median(x))))
    return jnp.maximum(bulk, folded)


def _ess_from_draws(z):
    """Multi-chain ESS of (already transformed) split draws z: (N, M)."""
    z = _split_chains(z)
    n, m = z.shape
    acov = _autocov(z)                      # (N, M)
    chain_var = acov[0] * n / (n - 1.0)
    w = jnp.mean(chain_var)
    chain_means = z.mean(axis=0)
    b_over_n = jnp.var(chain_means, ddof=1)
    var_plus = (n - 1) / n * w + b_over_n
    mean_acov = acov.mean(axis=1)           # (N,)
    rho = 1.0 - (w - mean_acov) / var_plus
    # Geyer pair sums Γ_k = ρ_{2k} + ρ_{2k+1} (positive for reversible
    # chains); initial-positive truncation then initial-monotone clamp
    n_pairs = n // 2
    g = rho[:2 * n_pairs].reshape(n_pairs, 2).sum(axis=1)
    g = jnp.where(jnp.cumsum(g < 0) > 0, 0.0, g)           # positive
    g = jax.lax.associative_scan(jnp.minimum, g)           # monotone
    g = jnp.maximum(g, 0.0)
    tau = jnp.maximum(-1.0 + 2.0 * jnp.sum(g), 1e-3)
    ess = n * m / tau
    return jnp.minimum(ess, n * m * jnp.log10(jnp.asarray(n * m,
                                                          jnp.float32)))


def ess_bulk(x):
    """Rank-normalized bulk effective sample size; x: (draws, chains)."""
    return _ess_from_draws(_rank_normalize(jnp.asarray(x)))


def ess_tail(x):
    """Tail ESS: min ESS of the 5% and 95% exceedance indicators."""
    x = jnp.asarray(x)
    q05, q95 = jnp.quantile(x, jnp.asarray([0.05, 0.95]))
    e05 = _ess_from_draws(_rank_normalize((x <= q05).astype(jnp.float32)))
    e95 = _ess_from_draws(_rank_normalize((x <= q95).astype(jnp.float32)))
    return jnp.minimum(e05, e95)


def ess_mean(x):
    """Plain (non-rank-normalized) ESS for the mean estimator — the
    quantity ESS/sec headline metrics report."""
    return _ess_from_draws(jnp.asarray(x))


def mcse_mean(x):
    """Monte-Carlo standard error of the posterior-mean estimate."""
    x = jnp.asarray(x)
    return x.std(ddof=1) / jnp.sqrt(ess_mean(x))


def summarize(samples):
    """Per-leaf diagnostics for a pytree of (draws, chains[, ...]) arrays.

    Trailing event dimensions are flattened and reported per coordinate.
    Returns {path: {"mean", "sd", "rhat", "ess_bulk", "ess_tail",
    "mcse_mean"}} with arrays shaped like the event dims.
    """
    out = {}
    flat = jax.tree_util.tree_flatten_with_path(samples)[0]
    for path, leaf in flat:
        leaf = jnp.asarray(leaf)
        if leaf.ndim < 2:
            raise ValueError(f"leaf {path} must be (draws, chains[, ...])")
        ev_shape = leaf.shape[2:]
        cols = leaf.reshape(leaf.shape[0], leaf.shape[1], -1)
        stats = {
            "mean": cols.mean(axis=(0, 1)),
            "sd": cols.std(axis=(0, 1), ddof=1),
            "rhat": jax.vmap(rhat, in_axes=2)(cols),
            "ess_bulk": jax.vmap(ess_bulk, in_axes=2)(cols),
            "ess_tail": jax.vmap(ess_tail, in_axes=2)(cols),
            "mcse_mean": jax.vmap(mcse_mean, in_axes=2)(cols),
        }
        if len(path) == 1 and hasattr(path[0], "key"):
            key = path[0].key          # plain dict entry -> its key
        else:
            key = jax.tree_util.keystr(path) or "value"
        out[key] = {k: v.reshape(ev_shape) if ev_shape else v[0]
                    for k, v in stats.items()}
    return out
