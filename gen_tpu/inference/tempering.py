"""Tempering methods: AIS, SMC samplers, parallel tempering.

No reference analogue — Gen.jl ships no annealing machinery (its log-ML
estimators are importance sampling, importance.jl, and the particle
filter, particle_filter.jl). These are the standard tools for multimodal
posteriors and tight marginal-likelihood estimates, and they are exactly
the shape accelerators like: N particles/replicas vmapped over a flat latent
vector, a ``lax.scan`` over the temperature ladder, weight collectives for
resampling.

Target decomposition. For a trace with observations constrained and a
latent selection, every method here works on

    log p_beta(v) = log prior(v) + beta * log lik(v),

obtained from the GFI with no model-specific code: ``rebuild(v)`` (one
key-free fully-constrained ``update``), then ``prior = project(trace,
latent_selection)`` and ``lik = score - prior``. Initialization at beta=0
is ``generate`` with the observations as constraints: the internal
proposal fills latents from the prior and the returned weight IS
log lik(v) (gen_fn_interface.jl:185-191 semantics with the default
proposal).

Estimators:

* :func:`ais` — annealed importance sampling (Neal 2001): particles move
  through the ladder with tempered-HMC transitions; log-ML estimate is
  logsumexp of the accumulated incremental weights. Unbiased on the
  MARGINAL-likelihood scale for any ladder/kernel.
* :func:`smc_sampler` — tempered SMC (Del Moral-Doucet-Jasra 2006): AIS +
  ESS-triggered resampling between rungs; same estimator, much lower
  variance when the ladder is coarse.
* :func:`parallel_tempering` — replica exchange: K replicas per chain run
  tempered HMC, adjacent temperatures propose swaps with acceptance
  log alpha = (beta_i - beta_j)(lik_j - lik_i); even/odd pairs alternate
  so every sweep is one fused batched step. Returns the beta=1 chain.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from ..gfi import Trace
from ..selection import Selection
from ..utils import logsumexp
from .particle_filter import _resample_parents
from .target import FlatTarget


class TemperedTarget:
    """``logprior(flat)`` / ``loglik(flat)`` over the selected latents of a
    trace whose remaining choices (the observations) are held fixed."""

    def __init__(self, trace: Trace, selection: Selection):
        self._flat = FlatTarget(trace, selection)
        self._selection = selection
        self.dim = self._flat.dim
        self.flat0 = self._flat.flat0

        def prior_lik(flat):
            tr = self._flat.rebuild(flat)
            prior = tr.project(selection)
            return prior, tr.get_score() - prior

        self.prior_lik = prior_lik

    def logp_at(self, beta):
        def logp(flat):
            prior, lik = self.prior_lik(flat)
            return prior + beta * lik
        return logp

    def rebuild(self, flat):
        return self._flat.rebuild(flat)


def _tempered_hmc_step(key, flat, target: TemperedTarget, beta,
                       L: int, eps):
    """One MH-corrected leapfrog trajectory on log p_beta. Returns
    (new_flat, accepted)."""
    logp = target.logp_at(beta)
    vag = jax.value_and_grad(logp)
    k_mom, k_acc = jax.random.split(key)
    p0 = jax.random.normal(k_mom, jnp.shape(flat), jnp.result_type(flat))
    lp0, g = vag(flat)

    def leapfrog(carry, _):
        q, p, g = carry
        p = p + 0.5 * eps * g
        q = q + eps * p
        lp, g = vag(q)
        p = p + 0.5 * eps * g
        return (q, p, g), lp

    (q, p, _), lps = jax.lax.scan(leapfrog, (flat, p0, g), None, length=L)
    lp1 = lps[-1]
    log_alpha = (lp1 - 0.5 * jnp.sum(p * p)) - (lp0 - 0.5 * jnp.sum(p0 * p0))
    accept = jnp.log(jax.random.uniform(k_acc)) < log_alpha
    return jnp.where(accept, q, flat), accept


def _init_particles(key, trace: Trace, selection: Selection, n: int):
    """Latents from the prior + their log-likelihoods, via ``generate``
    with the trace's non-selected choices (the observations) as
    constraints."""
    gen_fn = trace.get_gen_fn()
    args = trace.get_args()
    obs = trace.get_choices().filter(selection.complement())

    def one(k):
        tr, w = gen_fn.generate(k, args, obs)
        flat = tr.get_choices().filter(selection).to_array()
        return flat, w

    return jax.vmap(one)(jax.random.split(key, n))


def ais(key, trace: Trace, selection: Selection, betas,
        n_particles: int, L: int = 10, eps: float = 0.1,
        moves_per_rung: int = 1):
    """Annealed importance sampling from the prior to the posterior of the
    selected latents.

    ``betas``: increasing ladder, e.g. ``jnp.linspace(0, 1, 51)[1:]`` —
    each entry is a rung AFTER the prior stage (the last must be 1.0 for a
    posterior/evidence estimate).

    Returns ``(flats, log_weights, log_ml)``: particle latents (N, dim) at
    beta = betas[-1], their AIS weights, and the log-marginal-likelihood
    estimate ``logsumexp(log_weights) - log N``.
    """
    betas = jnp.asarray(betas)
    k_init, k_scan = jax.random.split(key)
    flats, _ = _init_particles(k_init, trace, selection, n_particles)
    target = TemperedTarget(trace, selection)

    def rung(carry, inp):
        flats, log_w, beta_prev = carry
        beta, k = inp
        # incremental weight at the CURRENT positions
        lik = jax.vmap(lambda f: target.prior_lik(f)[1])(flats)
        log_w = log_w + (beta - beta_prev) * lik

        def moves(flats, k):
            def one_move(f, kk):
                new, _ = _tempered_hmc_step(kk, f, target, beta, L, eps)
                return new
            return jax.vmap(one_move)(flats, jax.random.split(k, n_particles))

        def sweep(flats, k):
            ks = jax.random.split(k, moves_per_rung)
            return jax.lax.fori_loop(
                0, moves_per_rung, lambda i, fl: moves(fl, ks[i]), flats)

        flats = sweep(flats, k)
        return (flats, log_w, beta), None

    keys = jax.random.split(k_scan, betas.shape[0])
    (flats, log_w, _), _ = jax.lax.scan(
        rung, (flats, jnp.zeros(n_particles), jnp.asarray(0.0, betas.dtype)),
        (betas, keys))
    log_ml = logsumexp(log_w) - jnp.log(n_particles)
    return flats, log_w, log_ml


def smc_sampler(key, trace: Trace, selection: Selection, betas,
                n_particles: int, L: int = 10, eps: float = 0.1,
                moves_per_rung: int = 1,
                ess_threshold: Optional[float] = None,
                resample_method: str = "systematic"):
    """Tempered SMC: AIS with ESS-triggered resampling between rungs.

    Returns ``(flats, log_weights, log_ml)`` — ``log_weights`` are the
    residual (post-resampling) weights; the posterior sample is the
    weighted set, near-uniform when resampling triggered late.
    """
    betas = jnp.asarray(betas)
    n = n_particles
    if ess_threshold is None:
        ess_threshold = n / 2
    k_init, k_scan = jax.random.split(key)
    flats, _ = _init_particles(k_init, trace, selection, n)
    target = TemperedTarget(trace, selection)

    def rung(carry, inp):
        flats, log_w, log_ml = carry
        beta, beta_prev, k = inp
        k_res, k_mov = jax.random.split(k)

        lik = jax.vmap(lambda f: target.prior_lik(f)[1])(flats)
        log_w = log_w + (beta - beta_prev) * lik

        log_total = logsumexp(log_w)
        lnw = log_w - log_total
        ess = jnp.exp(-logsumexp(2.0 * lnw))

        def resample(_):
            parents = _resample_parents(k_res, lnw, resample_method)
            return (flats[parents], jnp.zeros(n),
                    log_ml + log_total - jnp.log(n))

        def keep(_):
            return (flats, log_w, log_ml)

        flats, log_w, log_ml = jax.lax.cond(ess < ess_threshold, resample,
                                            keep, None)

        def one_move(f, kk):
            new, _ = _tempered_hmc_step(kk, f, target, beta, L, eps)
            return new

        def sweep(i, fl):
            ks = jax.vmap(jax.random.fold_in, in_axes=(None, 0))(
                jax.random.fold_in(k_mov, i), jnp.arange(n))
            return jax.vmap(one_move)(fl, ks)

        flats = jax.lax.fori_loop(0, moves_per_rung, sweep, flats)
        return (flats, log_w, log_ml), None

    keys = jax.random.split(k_scan, betas.shape[0])
    beta_prevs = jnp.concatenate([jnp.zeros(1, betas.dtype), betas[:-1]])
    (flats, log_w, log_ml), _ = jax.lax.scan(
        rung, (flats, jnp.zeros(n), jnp.asarray(0.0)),
        (betas, beta_prevs, keys))
    log_ml = log_ml + logsumexp(log_w) - jnp.log(n)
    return flats, log_w, log_ml


def smc_sampler_adaptive(key, trace: Trace, selection: Selection,
                         n_particles: int, target_ess: float = 0.5,
                         max_stages: int = 64, L: int = 10,
                         eps: float = 0.1, moves_per_rung: int = 1,
                         resample_method: str = "systematic"):
    """Tempered SMC with an ESS-ADAPTIVE ladder (Del Moral et al. 2012,
    §3.3): each stage bisects the next beta so the incremental weights'
    ESS hits ``target_ess * N``, then resamples and moves. The whole
    sampler is ONE ``lax.while_loop`` program — the number of stages is
    data-dependent (bounded by ``max_stages``), with no host round-trips.

    Returns ``(flats, log_ml, n_stages, betas)``: equally-weighted
    posterior particles, the evidence estimate, the number of stages used,
    and the (max_stages,) ladder actually taken (NaN-padded).
    """
    n = n_particles
    k_init, k_loop = jax.random.split(key)
    flats0, _ = _init_particles(k_init, trace, selection, n)
    target = TemperedTarget(trace, selection)
    tgt = target_ess * n

    def ess_of(log_w):
        lnw = log_w - logsumexp(log_w)
        return jnp.exp(-logsumexp(2.0 * lnw))

    def body(carry):
        flats, log_ml, beta, stage, betas_hist, k = carry
        k, k_res, k_mov = jax.random.split(k, 3)
        lik = jax.vmap(lambda f: target.prior_lik(f)[1])(flats)

        # bisect the largest next beta whose incremental ESS >= target
        # (log_w is uniform here — we resample every stage)
        def bisect(_, lohi):
            lo, hi = lohi
            mid = 0.5 * (lo + hi)
            ok = ess_of((mid - beta) * lik) >= tgt
            return (jnp.where(ok, mid, lo), jnp.where(ok, hi, mid))

        full_ok = ess_of((1.0 - beta) * lik) >= tgt
        lo, _ = jax.lax.fori_loop(0, 50, bisect,
                                  (beta, jnp.asarray(1.0, beta.dtype)))
        new_beta = jnp.where(full_ok, 1.0, lo)

        log_w = (new_beta - beta) * lik
        log_total = logsumexp(log_w)
        log_ml = log_ml + log_total - jnp.log(n)
        parents = _resample_parents(k_res, log_w - log_total,
                                    resample_method)
        flats = flats[parents]

        def one_move(f, kk, b):
            new, _ = _tempered_hmc_step(kk, f, target, b, L, eps)
            return new

        def sweep(i, fl):
            ks = jax.vmap(jax.random.fold_in, in_axes=(None, 0))(
                jax.random.fold_in(k_mov, i), jnp.arange(n))
            return jax.vmap(one_move, in_axes=(0, 0, None))(fl, ks, new_beta)

        flats = jax.lax.fori_loop(0, moves_per_rung, sweep, flats)
        betas_hist = betas_hist.at[stage].set(new_beta)
        return (flats, log_ml, new_beta, stage + 1, betas_hist, k)

    def cond(carry):
        _, _, beta, stage, _, _ = carry
        return (beta < 1.0) & (stage < max_stages)

    betas_hist0 = jnp.full((max_stages,), jnp.nan)
    flats, log_ml, _, n_stages, betas_hist, _ = jax.lax.while_loop(
        cond, body,
        (flats0, jnp.asarray(0.0), jnp.asarray(0.0), jnp.asarray(0),
         betas_hist0, k_loop))
    return flats, log_ml, n_stages, betas_hist


def parallel_tempering(key, trace: Trace, selection: Selection, betas,
                       n_sweeps: int, L: int = 10, eps: float = 0.1,
                       thin: int = 1):
    """Replica-exchange MCMC over a temperature ladder.

    ``betas``: increasing, ending at 1.0 (e.g. ``jnp.geomspace(0.05, 1.0,
    8)``); one replica per temperature starts at the trace's current
    latents. Each sweep: one tempered-HMC move per replica (vmapped over
    the ladder), then even/odd adjacent swap proposals with exact
    acceptance log alpha = (beta_i - beta_j)(lik_j - lik_i).

    Returns ``(samples, swap_rate)``: (n_sweeps//thin, dim) latents from
    the beta=1 replica and the mean adjacent-swap acceptance rate.
    """
    betas = jnp.asarray(betas)
    K = betas.shape[0]
    target = TemperedTarget(trace, selection)
    flats0 = jnp.broadcast_to(target.flat0, (K, target.dim))

    def swap_pass(flats, liks, k, parity):
        # propose swaps for pairs (i, i+1) with i = parity, parity+2, ...
        i = jnp.arange(K - 1)
        eligible = (i % 2) == parity
        lik_i, lik_j = liks[:-1], liks[1:]
        log_alpha = (betas[:-1] - betas[1:]) * (lik_j - lik_i)
        u = jax.random.uniform(k, (K - 1,))
        acc = eligible & (jnp.log(u) < log_alpha)
        # build the permutation induced by the accepted swaps (disjoint
        # pairs by parity, so one pass suffices)
        idx = jnp.arange(K)
        swap_lo = jnp.concatenate([acc, jnp.zeros(1, bool)])   # i swaps up
        swap_hi = jnp.concatenate([jnp.zeros(1, bool), acc])   # i+1 swaps dn
        perm = jnp.where(swap_lo, idx + 1, jnp.where(swap_hi, idx - 1, idx))
        return flats[perm], liks[perm], jnp.sum(acc), jnp.sum(eligible)

    def sweep(carry, inp):
        flats, liks = carry
        t, k = inp
        k_move, k_swap = jax.random.split(k)

        def one(f, b, kk):
            new, _ = _tempered_hmc_step(kk, f, target, b, L, eps)
            return new

        flats = jax.vmap(one)(flats, betas, jax.random.split(k_move, K))
        liks = jax.vmap(lambda f: target.prior_lik(f)[1])(flats)
        flats, liks, n_acc, n_el = swap_pass(flats, liks, k_swap, t % 2)
        return (flats, liks), (flats[-1], n_acc, n_el)

    liks0 = jax.vmap(lambda f: target.prior_lik(f)[1])(flats0)
    keys = jax.random.split(key, n_sweeps)
    (_, _), (samples, n_acc, n_el) = jax.lax.scan(
        sweep, (flats0, liks0), (jnp.arange(n_sweeps), keys))
    swap_rate = jnp.sum(n_acc) / jnp.maximum(jnp.sum(n_el), 1)
    return samples[::thin], swap_rate
