"""Importance sampling & resampling.

Reference: /root/reference/src/inference/importance.jl:1-110. accelerator-native
design: the N particles are one ``vmap`` axis — ``generate`` runs as a
single batched XLA program, and the weight normalization is one fused
logsumexp. On a device mesh the same code shards the particle axis (see
gen_tpu.parallel)."""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from ..choice_map import ChoiceMap
from ..gfi import GenerativeFunction
from ..utils import logsumexp


def importance_sampling(key, model: GenerativeFunction, model_args: Tuple,
                        observations: ChoiceMap, num_samples: int,
                        proposal: Optional[GenerativeFunction] = None,
                        proposal_args: Tuple = (), verbose: bool = False):
    """Returns (vmapped_traces, log_normalized_weights, log_ml_estimate).

    Default proposal: weights come straight from ``generate``
    (importance.jl:30-48). Custom proposal: propose → merge with
    observations → generate fully-constrained (importance.jl:66-96)."""
    keys = jax.random.split(key, num_samples)
    if verbose:
        print(f"importance sampling: {num_samples} particles")

    if proposal is None:
        def one(k):
            return model.generate(k, model_args, observations)
        traces, log_weights = jax.vmap(one)(keys)
    else:
        def one(k):
            kp, km = jax.random.split(k)
            prop_choices, prop_weight, _ = proposal.propose(kp, proposal_args)
            constraints = observations.merge(prop_choices)
            trace, model_weight = model.generate(km, model_args, constraints)
            return trace, model_weight - prop_weight
        traces, log_weights = jax.vmap(one)(keys)

    log_total_weight = logsumexp(log_weights)
    log_ml_estimate = log_total_weight - jnp.log(num_samples)
    log_normalized_weights = log_weights - log_total_weight
    return traces, log_normalized_weights, log_ml_estimate


def importance_resampling(key, model: GenerativeFunction, model_args: Tuple,
                          observations: ChoiceMap, num_samples: int,
                          proposal: Optional[GenerativeFunction] = None,
                          proposal_args: Tuple = ()):
    """Sample one trace ∝ importance weight (importance.jl:98-110).
    Returns (trace, log_ml_estimate)."""
    k1, k2 = jax.random.split(key)
    traces, log_normalized_weights, log_ml = importance_sampling(
        k1, model, model_args, observations, num_samples, proposal,
        proposal_args)
    idx = jax.random.categorical(k2, log_normalized_weights)
    chosen = jax.tree_util.tree_map(lambda x: x[idx], traces)
    return chosen, log_ml
