"""Batch sequential Monte Carlo with ancestry tracking (genealogy PF).

The arena-based :func:`gen_tpu.combinators.arena.smc_run` resamples whole
particle histories every step — O(N · T · trace_size) gather traffic. This
module implements the genealogy formulation: per-step kernel traces are
collected time-major by ``lax.scan`` (sequential writes, no scatter),
resampling permutes only the O(N · state_dim) carried state plus an
ancestry row, and full trajectories are reconstructed once at the end by a
backward gather pass. log-ML estimates are identical in distribution; the
per-step cost no longer grows with history length.

This is the accelerator-native answer to SURVEY.md §5.7's "long-sequence story":
one compiled program for the entire filter, with resampling traffic
independent of T."""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from ..combinators.vector import VectorChoiceMap
from ..gfi import GenerativeFunction
from ..utils import logsumexp
from .particle_filter import _resample_parents


def smc_genealogy(key, kernel: GenerativeFunction, init_state, params: Tuple,
                  observations: VectorChoiceMap, num_particles: int,
                  ess_threshold: Optional[float] = None,
                  resample_method: str = "systematic"):
    """Run a full particle filter over an Unfold-style kernel
    ``(t, state, *params) -> state``.

    Returns (subtraces, ancestry, log_weights, log_ml_estimate):
      subtraces: time-major batched kernel traces, leaves (T, N, ...)
      ancestry:  (T, N) int32 — parent indices chosen at each step's
                 resampling (identity rows where no resampling happened)
      log_weights: (N,) final unnormalized log weights
    Use :func:`reconstruct_trajectories` for coherent particle histories.
    """
    T = observations.length
    if ess_threshold is None:
        ess_threshold = num_particles / 2
    n = num_particles

    k_init, k_scan = jax.random.split(key)

    def extend(ks, t, states, obs_t):
        def one(k, s):
            return kernel.generate(k, (t, s) + tuple(params), obs_t)
        return jax.vmap(one)(ks, states)

    def step(carry, inp):
        states, log_w, log_ml = carry
        t, k = inp
        k_res, k_ext = jax.random.split(k)

        log_total = logsumexp(log_w)
        lnw = log_w - log_total
        ess = jnp.exp(-logsumexp(2.0 * lnw))
        do = (ess < ess_threshold) & (t > 0)

        # lax.cond so steps that keep their weights skip the resampling
        # sort and the state gather entirely (they dominate the step cost
        # at large N); under vmap this degrades gracefully to a select
        lm_dtype = jnp.result_type(log_ml, log_total)

        def resample(_):
            parents = _resample_parents(k_res, lnw,
                                        resample_method).astype(jnp.int32)
            permuted = jax.tree_util.tree_map(lambda x: x[parents], states)
            return (permuted, jnp.zeros_like(log_w),
                    (log_ml + log_total - jnp.log(n)).astype(lm_dtype),
                    parents)

        def keep(_):
            return (states, log_w, jnp.asarray(log_ml, lm_dtype),
                    jnp.arange(n, dtype=jnp.int32))

        states, log_w, log_ml, parents = jax.lax.cond(do, resample, keep,
                                                      None)

        obs_t = jax.tree_util.tree_map(
            lambda x: jax.lax.dynamic_index_in_dim(x, t, keepdims=False),
            observations.inner)
        subs, ws = extend(jax.random.split(k_ext, n), t, states, obs_t)
        return ((subs.get_retval(), log_w + ws, log_ml),
                (subs, parents))

    init_states = jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(jnp.asarray(x),
                                   (n,) + jnp.shape(jnp.asarray(x))),
        init_state)
    ts = jnp.arange(T)
    keys = jax.random.split(k_scan, T)
    (states, log_w, log_ml), (subtraces, ancestry) = jax.lax.scan(
        step, (init_states, jnp.zeros(n), jnp.asarray(0.0)), (ts, keys))
    final_lml = log_ml + logsumexp(log_w) - jnp.log(n)
    return subtraces, ancestry, log_w, final_lml


def reconstruct_trajectories(subtraces, ancestry):
    """Resolve the genealogy: returns time-major subtraces re-indexed so
    that column j is the coherent history of final particle j. One backward
    scan of (N,) gathers — O(T·N) total, independent of trace size per
    gather step only touching index vectors plus one final take."""
    T, n = ancestry.shape

    def back(carry, anc_t):
        idx = carry            # indices into step t's particles
        prev_idx = anc_t[idx]  # their parents at step t
        return prev_idx, idx

    # ancestry[t] maps step-t particle -> its parent's index at step t-1
    # walk backwards collecting the index each trajectory used at each step
    idx0 = jnp.arange(n, dtype=ancestry.dtype)
    _, step_indices = jax.lax.scan(back, idx0, ancestry, reverse=True)
    # step_indices[t, j] = which step-t particle belongs to trajectory j
    return jax.tree_util.tree_map(
        lambda x: jax.vmap(lambda xt, it: xt[it])(x, step_indices),
        subtraces)
