"""Conditional SMC and Particle Gibbs with ancestor sampling.

No reference analogue: Gen.jl's inference library stops at the particle
filter + PMMH (src/inference/particle_filter.jl; examples/pmmh/pf.jl). The
standard companion — Particle Gibbs (Andrieu, Doucet & Holenstein 2010)
with ancestor sampling (Lindsten, Jordan & Schön 2014) — needs a
*conditional* SMC kernel: a particle filter in which one lane is pinned to
a reference trajectory, leaving the exact posterior over trajectories
invariant. PMMH explores parameters with pseudo-marginal noise; PG
resamples the whole latent path as a Gibbs block, which is what you want
for state inference and for Gibbs-within-PG parameter updates.

Design: built on the genealogy formulation
(:func:`gen_tpu.inference.smc.smc_genealogy`) — the whole conditional
filter is ONE compiled ``lax.scan``; the reference lane is expressed with
:class:`~gen_tpu.masked.MaskedValue` constraints (flag = lane==0), so lane
pinning is branchless and the extension step stays a single vmapped
``generate``. Resampling is conditional multinomial (iid parents for lanes
1..N-1, lane 0's ancestor pinned or ancestor-sampled); the final
trajectory is reconstructed by the backward genealogy gather.

Weight bookkeeping (GFI-exact): for non-reference lanes the incremental
weight is the ``generate`` weight with the step's observations constrained.
For the reference lane, ``generate`` is called with ALL of the reference's
step choices constrained (weight = full joint density); subtracting
``project(subtrace, latent_selection)`` — the internal-proposal density of
the latent choices — recovers exactly the weight the lane would have
received had the internal proposal happened to sample the reference values.
This is the general-GFI form of "the reference particle gets the same
importance weight as everyone else".

Ancestor-sampling validity: the one-step ancestor weight
``w_{t-1}^i · p(ref step-t choices | state_i)`` (computed via ``assess``)
is exact when the kernel's carried state is determined by its traced
choices at that step (e.g. ``x ~ normal(f(prev), q); return x``) — the
standard SSM parameterization, where grafting the reference's future onto
a new ancestor leaves its states unchanged. For noise-parameterized
kernels (``eps ~ normal(0,1); return prev + eps``) one-step AS is not
valid; use :func:`check_state_is_choice_determined` to verify a kernel,
and fall back to ``ancestor_sampling=False`` (plain CSMC, always valid).
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from ..choice_map import ChoiceMap
from ..combinators.vector import VectorChoiceMap
from ..gfi import GenerativeFunction
from ..masked import MaskedValue
from ..selection import select
from ..utils import logsumexp
from .smc import reconstruct_trajectories


def _conditional_multinomial_parents(key, lnw):
    """(n-1,) IID multinomial parents for the non-reference lanes,
    O(n log n) at any n: exponential-spacings sorted uniforms + the
    rank-merge counting trick (ops/resample.py).
    ``jax.random.categorical(shape=(n,))`` materializes an (n, n) gumbel
    block — 1 GB at n=16k, measured 3x slower end-to-end at 16k particles.

    Exactly n-1 draws are made and ALL are kept (the caller prepends the
    pinned/ancestor-sampled lane-0 parent). Drawing n and overwriting
    index 0 would discard the MINIMUM of n sorted draws — the kept n-1
    would no longer be iid (measured: with n=4 uniform weights, parent
    index 0 appears with frequency 0.106 instead of 0.25), systematically
    suppressing the previous reference particle's offspring and breaking
    CSMC invariance. The sorted order itself is harmless: lanes 1..N-1
    are exchangeable (all extended by iid proposals)."""
    from ..ops.resample import _rank_merge_parents
    n = lnw.shape[0]
    e = jax.random.exponential(key, (n,))
    c = jnp.cumsum(e)
    us = c[:-1] / c[-1]                       # (n-1,) sorted iid uniforms
    w = jnp.exp(lnw - jnp.max(lnw))
    cdf = jnp.cumsum(w)
    return jnp.clip(_rank_merge_parents(cdf / cdf[-1], us),
                    0, n - 1).astype(jnp.int32)


def _index_inner(inner: ChoiceMap, t):
    """Step-t slice of a time-major choice map (leaves indexed at axis 0)."""
    return jax.tree_util.tree_map(
        lambda x: jax.lax.dynamic_index_in_dim(x, t, keepdims=False), inner)


def _latent_paths(ref_inner: ChoiceMap, obs_inner: ChoiceMap):
    obs_addrs = set(obs_inner.addresses())
    latent = [a for a in ref_inner.addresses() if a not in obs_addrs]
    if not latent:
        raise ValueError("reference choices contain no latent addresses "
                         "beyond the observations — nothing to condition on")
    return latent


def csmc_genealogy(key, kernel: GenerativeFunction, init_state,
                   params: Tuple, observations: VectorChoiceMap,
                   ref_choices: VectorChoiceMap, num_particles: int,
                   ancestor_sampling: bool = False,
                   ess_threshold: Optional[float] = None):
    """Conditional SMC over an Unfold-style kernel
    ``(t, state, *params) -> state``, pinning lane 0 to ``ref_choices``.

    ``ref_choices`` must be the FULL per-step choices of a coherent
    trajectory (latents and observations), time-major — e.g. the output of
    :func:`particle_gibbs_step` or ``get_choices()`` of a reconstructed
    genealogy trajectory. ``ess_threshold=None`` resamples every step (the
    standard CSMC schedule); pass a value for adaptive resampling.

    Returns ``(subtraces, ancestry, log_weights, log_ml_estimate)`` with
    the same shapes/semantics as :func:`gen_tpu.inference.smc.smc_genealogy`.
    """
    T = observations.length
    if ref_choices.length != T:
        raise ValueError(f"ref_choices length {ref_choices.length} != "
                         f"observations length {T}")
    n = num_particles
    always_resample = ess_threshold is None
    thr = jnp.inf if always_resample else ess_threshold

    latent_sel = select(*_latent_paths(ref_choices.inner, observations.inner))
    latent_addrs = _latent_paths(ref_choices.inner, observations.inner)

    k_scan, = jax.random.split(key, 1)
    lane = jnp.arange(n)

    def step(carry, inp):
        states, log_w, log_ml = carry
        t, k = inp
        k_anc, k_res, k_ext = jax.random.split(k, 3)

        ref_t = _index_inner(ref_choices.inner, t)
        obs_t = _index_inner(observations.inner, t)

        log_total = logsumexp(log_w)
        lnw = log_w - log_total
        ess = jnp.exp(-logsumexp(2.0 * lnw))
        do = (ess < thr) & (t > 0) if not always_resample else (t > 0)
        lm_dtype = jnp.result_type(log_ml, log_total)

        def resample(_):
            rest = _conditional_multinomial_parents(k_res, lnw)
            if ancestor_sampling:
                # w_{t-1}^i * p(ref step-t choices | state_i): exact under
                # the choice-determined-state condition (module docstring)
                as_lp = jax.vmap(
                    lambda s: kernel.assess((t, s) + tuple(params),
                                            ref_t)[0])(states)
                p0 = jax.random.categorical(k_anc,
                                            lnw + as_lp).astype(jnp.int32)
            else:
                p0 = jnp.int32(0)
            parents = jnp.concatenate([p0[None], rest])
            permuted = jax.tree_util.tree_map(lambda x: x[parents], states)
            return (permuted, jnp.zeros_like(log_w),
                    (log_ml + log_total - jnp.log(n)).astype(lm_dtype),
                    parents)

        def keep(_):
            return (states, log_w, jnp.asarray(log_ml, lm_dtype),
                    jnp.arange(n, dtype=jnp.int32))

        states, log_w, log_ml, parents = jax.lax.cond(do, resample, keep,
                                                      None)

        def one(k_i, s, flag):
            cons = obs_t
            for addr in latent_addrs:
                cons = cons.set_value(
                    addr, MaskedValue(ref_t.get_value(addr), flag))
            sub, w = kernel.generate(k_i, (t, s) + tuple(params), cons)
            # reference lane: full joint weight -> importance weight by
            # removing the internal-proposal density of the pinned latents
            w = w - jnp.where(flag, sub.project(latent_sel), 0.0)
            return sub, w

        subs, ws = jax.vmap(one)(jax.random.split(k_ext, n), states,
                                 lane == 0)
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


def particle_gibbs_step(key, kernel: GenerativeFunction, init_state,
                        params: Tuple, observations: VectorChoiceMap,
                        ref_choices: VectorChoiceMap, num_particles: int,
                        ancestor_sampling: bool = True,
                        ess_threshold: Optional[float] = None):
    """One Particle-Gibbs sweep: run conditional SMC against the current
    reference trajectory, then draw the new reference from the final
    particle weights. Jit/scan-able end to end (the returned choice map has
    the same structure as the input).

    Returns ``(new_ref_choices, log_ml_estimate)``. Iterating this function
    is a Markov chain on full latent trajectories whose invariant
    distribution is the exact posterior ``p(latents | observations)``
    (Andrieu et al. 2010 Thm 5); ``ancestor_sampling=True`` dramatically
    improves mixing of the early-time states for long sequences (Lindsten
    et al. 2014) and requires the choice-determined-state condition (module
    docstring).
    """
    k_run, k_pick = jax.random.split(key)
    subs, ancestry, log_w, lml = csmc_genealogy(
        k_run, kernel, init_state, params, observations, ref_choices,
        num_particles, ancestor_sampling=ancestor_sampling,
        ess_threshold=ess_threshold)
    j = jax.random.categorical(k_pick, log_w - logsumexp(log_w))
    trajs = reconstruct_trajectories(subs, ancestry)
    traj_j = jax.tree_util.tree_map(lambda x: x[:, j], trajs)
    new_inner = traj_j.get_choices()
    return VectorChoiceMap(new_inner, observations.length), lml


def particle_gibbs(key, kernel: GenerativeFunction, init_state,
                   params: Tuple, observations: VectorChoiceMap,
                   num_particles: int, num_sweeps: int,
                   ancestor_sampling: bool = True,
                   init_ref: Optional[VectorChoiceMap] = None):
    """Run a full Particle-Gibbs chain as ONE compiled program (a
    ``lax.scan`` of :func:`particle_gibbs_step`).

    The initial reference is drawn from an unconditional genealogy SMC run
    (a draw from the posterior approximation — a valid initialization)
    unless ``init_ref`` is given. Returns ``(refs, log_mls)`` where
    ``refs`` is a time-major choice map whose leaves have a leading
    ``(num_sweeps,)`` axis — sweep s's trajectory is
    ``VectorChoiceMap(tree_map(lambda x: x[s], refs.inner), T)``.
    """
    from .smc import smc_genealogy
    k_init, k_pick, k_scan = jax.random.split(key, 3)
    if init_ref is None:
        subs, anc, log_w, _ = smc_genealogy(
            k_init, kernel, init_state, params, observations, num_particles)
        j = jax.random.categorical(k_pick, log_w - logsumexp(log_w))
        trajs = reconstruct_trajectories(subs, anc)
        traj_j = jax.tree_util.tree_map(lambda x: x[:, j], trajs)
        init_ref = VectorChoiceMap(traj_j.get_choices(), observations.length)

    def sweep(ref, k):
        new_ref, lml = particle_gibbs_step(
            k, kernel, init_state, params, observations, ref, num_particles,
            ancestor_sampling=ancestor_sampling)
        return new_ref, (new_ref, lml)

    _, (refs, lmls) = jax.lax.scan(sweep, init_ref,
                                   jax.random.split(k_scan, num_sweeps))
    return refs, lmls


def check_state_is_choice_determined(key, kernel: GenerativeFunction,
                                     states, t, params: Tuple,
                                     step_choices: ChoiceMap,
                                     atol: float = 0.0) -> bool:
    """Host-side validator for the ancestor-sampling condition: generate
    the kernel at step ``t`` from each of several ``states`` (a batched
    pytree) with ``step_choices`` fully constrained, and check the returned
    carried state is identical across ancestors. Run this (outside jit, on
    representative states) before enabling ``ancestor_sampling=True``."""
    def one(k, s):
        sub, _ = kernel.generate(k, (t, s) + tuple(params), step_choices)
        return sub.get_retval()

    n = jax.tree_util.tree_leaves(states)[0].shape[0]
    retvals = jax.vmap(one)(jax.random.split(key, n), states)
    import numpy as np
    for leaf in jax.tree_util.tree_leaves(retvals):
        leaf = np.asarray(leaf)
        if not np.all(np.abs(leaf - leaf[0]) <= atol):
            return False
    return True
