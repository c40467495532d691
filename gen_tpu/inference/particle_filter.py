"""Particle filtering / sequential Monte Carlo.

Reference: /root/reference/src/inference/particle_filter.jl (216 LoC).
Design: the particle axis is a ``vmap`` axis — ``init`` and each
``particle_filter_step`` compile to one batched XLA program; resampling is a
fused gather. With Unfold models the step rides the O(1) trace-extension
fast path, so per-step cost is independent of history length. On a device
mesh the same state shards over particles (see gen_tpu.parallel) with
``psum``-based weight normalization and collective resampling.

The state is functional (a pytree), not mutated in place; every function
returns a new state."""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from ..choice_map import ChoiceMap
from ..gfi import GenerativeFunction
from ..utils import logsumexp


class ParticleFilterState:
    """Pytree: vectorized traces + per-particle log weights + accumulated
    log-ML (reference: particle_filter.jl:18-24)."""

    __slots__ = ("traces", "log_weights", "log_ml_est", "parents")

    def __init__(self, traces, log_weights, log_ml_est, parents=None):
        self.traces = traces
        self.log_weights = log_weights
        self.log_ml_est = log_ml_est
        self.parents = parents

    @property
    def num_particles(self) -> int:
        return self.log_weights.shape[0]


jax.tree_util.register_pytree_node(
    ParticleFilterState,
    lambda s: ((s.traces, s.log_weights, s.log_ml_est, s.parents), None),
    lambda _, c: ParticleFilterState(*c))


def effective_sample_size(log_normalized_weights) -> jnp.ndarray:
    """ESS = exp(-logsumexp(2 * log w_norm)) (reference:
    particle_filter.jl:3-6)."""
    return jnp.exp(-logsumexp(2.0 * log_normalized_weights))


def initialize_particle_filter(key, model: GenerativeFunction,
                               model_args: Tuple, observations: ChoiceMap,
                               num_particles: int,
                               proposal: Optional[GenerativeFunction] = None,
                               proposal_args: Tuple = ()):
    """Reference: particle_filter.jl:79-108."""
    keys = jax.random.split(key, num_particles)
    if proposal is None:
        traces, log_weights = jax.vmap(
            lambda k: model.generate(k, model_args, observations))(keys)
    else:
        def one(k):
            kp, km = jax.random.split(k)
            prop_choices, prop_weight, _ = proposal.propose(kp, proposal_args)
            constraints = observations.merge(prop_choices)
            trace, model_weight = model.generate(km, model_args, constraints)
            return trace, model_weight - prop_weight
        traces, log_weights = jax.vmap(one)(keys)
    return ParticleFilterState(traces, log_weights, jnp.asarray(0.0))


def particle_filter_step(key, state: ParticleFilterState, new_args: Tuple,
                         argdiffs: Tuple, observations: ChoiceMap,
                         proposal: Optional[GenerativeFunction] = None,
                         proposal_args: Tuple = ()):
    """Extend every particle to the new arguments/observations.

    Default: weight increment from ``update`` (particle_filter.jl:162-180).
    Custom proposal: propose per particle, then constrained update, weight =
    update_weight − proposal_weight (the SimpleExtendingTraceTranslator path,
    particle_filter.jl:139-154)."""
    n = state.num_particles
    keys = jax.random.split(key, n)
    gen_fn = None

    def one(k, trace):
        fn = trace.get_gen_fn()
        if proposal is None:
            new_trace, weight, _, _ = fn.update(
                k, trace, new_args, argdiffs, observations)
            return new_trace, weight
        kp, ku = jax.random.split(k)
        prop_choices, prop_weight, _ = proposal.propose(
            kp, (trace,) + tuple(proposal_args))
        constraints = observations.merge(prop_choices)
        new_trace, weight, _, discard = fn.update(
            ku, trace, new_args, argdiffs, constraints)
        if not discard.is_empty():
            raise ValueError(
                "particle_filter_step: proposal overwrote existing choices "
                "(discard non-empty) — not a valid trace extension "
                "(reference: trace_translators.jl:795-799)")
        return new_trace, weight - prop_weight

    new_traces, weights = jax.vmap(one)(keys, state.traces)
    return ParticleFilterState(new_traces, state.log_weights + weights,
                               state.log_ml_est, state.parents)


def _resample_parents(key, log_normalized_weights, method: str):
    n = log_normalized_weights.shape[0]
    if method == "multinomial":
        if n > 32768:
            # categorical with shape (n,) materializes an (n, n) gumbel
            # matrix; use inverse-CDF with sorted uniforms (exponential-
            # spacings) + rank merge instead — O(n log n), exact in
            # distribution (parents come out sorted; particles are
            # exchangeable so this is harmless)
            from ..ops.resample import _rank_merge_parents
            e = jax.random.exponential(key, (n + 1,))
            c = jnp.cumsum(e)
            us = c[:-1] / c[-1]
            w = jnp.exp(log_normalized_weights
                        - jnp.max(log_normalized_weights))
            cdf = jnp.cumsum(w)
            return jnp.clip(_rank_merge_parents(cdf / cdf[-1], us), 0, n - 1)
        return jax.random.categorical(key, log_normalized_weights, shape=(n,))
    if method == "systematic":
        # single uniform, stratified positions — deterministic layout,
        # collective-friendly (ops/resample.py)
        from ..ops.resample import systematic_resample
        u = jax.random.uniform(key)
        return systematic_resample(log_normalized_weights, u)
    if method == "residual":
        w = jnp.exp(log_normalized_weights)
        counts = jnp.floor(w * n).astype(jnp.int32)
        resid = w * n - counts
        k1, = jax.random.split(key, 1)
        extra = jax.random.categorical(
            k1, jnp.log(jnp.maximum(resid, 1e-38)), shape=(n,))
        base = jnp.repeat(jnp.arange(n), counts, total_repeat_length=n)
        num_det = jnp.sum(counts)
        idx = jnp.arange(n)
        return jnp.where(idx < num_det, base, extra)
    raise ValueError(f"unknown resampling method {method!r}")


def maybe_resample(key, state: ParticleFilterState,
                   ess_threshold: Optional[float] = None,
                   method: str = "systematic"):
    """Resample when ESS < threshold (default N/2), accumulating the log-ML
    increment (reference: particle_filter.jl:189-213). Returns
    (new_state, did_resample). jit-safe: both branches are traced and
    selected with ``where``."""
    n = state.num_particles
    if ess_threshold is None:
        ess_threshold = n / 2
    log_total = logsumexp(state.log_weights)
    lnw = state.log_weights - log_total
    ess = effective_sample_size(lnw)
    do = ess < ess_threshold

    # lax.cond: skip the resampling sort and the whole-trace gather when
    # ESS is high (they dominate at large N); under vmap this lowers to
    # the same select-of-both as before
    lm_dtype = jnp.result_type(state.log_ml_est, log_total)

    def resample(_):
        parents = _resample_parents(key, lnw, method).astype(jnp.int32)
        traces = jax.tree_util.tree_map(lambda x: x[parents], state.traces)
        return ParticleFilterState(
            traces, jnp.zeros_like(state.log_weights),
            (state.log_ml_est + log_total - jnp.log(n)).astype(lm_dtype),
            parents)

    def keep(_):
        return ParticleFilterState(
            state.traces, state.log_weights,
            jnp.asarray(state.log_ml_est, lm_dtype),
            jnp.arange(n, dtype=jnp.int32))

    return jax.lax.cond(do, resample, keep, None), do


def log_ml_estimate(state: ParticleFilterState):
    """Reference: particle_filter.jl:52-55."""
    n = state.num_particles
    return (state.log_ml_est + logsumexp(state.log_weights) - jnp.log(n))


def sample_unweighted_traces(key, state: ParticleFilterState,
                             num_samples: int):
    """Reference: particle_filter.jl:60-72."""
    log_total = logsumexp(state.log_weights)
    idx = jax.random.categorical(key, state.log_weights - log_total,
                                 shape=(num_samples,))
    return jax.tree_util.tree_map(lambda x: x[idx], state.traces)


def get_traces(state):
    return state.traces


def get_log_weights(state):
    return state.log_weights
