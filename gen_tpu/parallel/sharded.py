"""Sharded inference: chains/particles laid out over a device mesh.

Design (SURVEY.md §5.8, §7.1): the per-chain/per-particle computation is the
same vmapped program as single-chip; sharding annotations on the batch axis
make XLA partition it across devices, and the cross-particle reductions
(logsumexp weight normalization, ESS, log-ML, resampling CDF, VI gradient
means) lower to ``all-reduce``/``all-gather`` collectives over the interconnect. No
explicit psum calls are needed in the common path — the sharding propagation
inserts them — which keeps these functions identical in semantics to their
single-chip counterparts in gen_tpu.inference."""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..choice_map import ChoiceMap
from ..gfi import GenerativeFunction
from ..inference.particle_filter import ParticleFilterState
from ..utils import logsumexp
from .mesh import shard_keys


def _batch_sharding(mesh: Mesh, axis: str):
    return NamedSharding(mesh, P(axis))


def sharded_importance_sampling(key, model: GenerativeFunction,
                                model_args: Tuple, observations: ChoiceMap,
                                num_samples: int, mesh: Mesh,
                                axis: str = "chains"):
    """Importance sampling with the particle axis sharded over the mesh.
    Returns (traces, log_normalized_weights, log_ml_estimate); the logsumexp
    reduction is a cross-device all-reduce."""
    keys = shard_keys(key, num_samples, mesh, axis)

    @jax.jit
    def run(keys):
        traces, log_weights = jax.vmap(
            lambda k: model.generate(k, model_args, observations))(keys)
        log_total = logsumexp(log_weights)
        return (traces, log_weights - log_total,
                log_total - jnp.log(num_samples))

    return run(keys)


def sharded_mcmc_step(step_fn, traces, keys):
    """Apply a (trace, key) -> (trace, aux) kernel step to sharded chains.
    Chains are independent — no collectives; XLA runs each shard locally."""
    return jax.jit(jax.vmap(step_fn))(traces, keys)


def sharded_hmc_chains(key, model: GenerativeFunction, model_args: Tuple,
                       observations: ChoiceMap, selection, num_chains: int,
                       num_steps: int, mesh: Mesh, axis: str = "chains",
                       L: int = 10, eps: float = 0.1):
    """Run many HMC chains sharded over the mesh; returns the final batched
    traces and the per-step selected-choice history."""
    from ..inference.hmc import hmc
    k_init, k_steps = jax.random.split(key)
    init_keys = shard_keys(k_init, num_chains, mesh, axis)

    @jax.jit
    def run(init_keys, k_steps):
        traces, _ = jax.vmap(
            lambda k: model.generate(k, model_args, observations))(init_keys)

        def body(trs, step_key):
            ks = jax.vmap(
                lambda i: jax.random.fold_in(step_key, i))(
                    jnp.arange(num_chains))

            def one(tr, k):
                new_tr, acc = hmc(k, tr, selection, L=L, eps=eps)
                return new_tr, acc

            trs, accs = jax.vmap(one)(trs, ks)
            return trs, (trs.get_score(), accs)

        step_keys = jax.random.split(k_steps, num_steps)
        final, (scores, accs) = jax.lax.scan(body, traces, step_keys)
        return final, scores, accs

    return run(init_keys, k_steps)


def sharded_particle_filter_init(key, model: GenerativeFunction,
                                 model_args: Tuple, observations: ChoiceMap,
                                 num_particles: int, mesh: Mesh,
                                 axis: str = "particles"):
    """PF initialization with particles sharded over the mesh."""
    keys = shard_keys(key, num_particles, mesh, axis)

    @jax.jit
    def run(keys):
        traces, log_weights = jax.vmap(
            lambda k: model.generate(k, model_args, observations))(keys)
        return ParticleFilterState(traces, log_weights, jnp.asarray(0.0))

    return run(keys)


def sharded_maybe_resample(key, state: ParticleFilterState,
                           ess_threshold: Optional[float] = None,
                           method: str = "systematic"):
    """Collective resampling: the weight CDF is a cross-device reduction and
    the parent gather is an all-gather over the particle axis. Semantics
    identical to gen_tpu.inference.maybe_resample."""
    from ..inference.particle_filter import maybe_resample
    return maybe_resample(key, state, ess_threshold, method)


def sharded_vi_step(key, model, model_args, observations, var_model,
                    var_model_args, num_samples: int, mesh: Mesh,
                    axis: str = "chains"):
    """One BBVI gradient estimate with the sample axis sharded; the gradient
    mean is an all-reduce. Returns (elbo, bundle_grads)."""
    from ..dynamic.params import override_params
    from ..learning.variational import (_bundle, _overrides,
                                        collect_params_targets)
    from ..utils import combine, partition_inexact

    fns = collect_params_targets(var_model)
    keys = shard_keys(key, num_samples, mesh, axis)
    bdyn, bstatic = partition_inexact(_bundle(fns))

    @jax.jit
    def step(keys, bdyn):
        b0 = combine(bdyn, bstatic)
        with override_params(_overrides(fns, b0)):
            var_traces = jax.vmap(
                lambda k: var_model.simulate(k, var_model_args))(keys)

        def model_weight(tr):
            w, _ = model.assess(model_args,
                                observations.merge(tr.get_choices()))
            return w

        log_weights = (jax.vmap(model_weight)(var_traces)
                       - var_traces.get_score())
        elbo = jnp.mean(log_weights)

        def obj(bdyn_):
            b = combine(bdyn_, bstatic)
            with override_params(_overrides(fns, b)):
                def q_logp(tr, lw):
                    w, _ = var_model.assess(var_model_args, tr.get_choices())
                    return jax.lax.stop_gradient(lw) * w
                return jnp.mean(jax.vmap(q_logp)(var_traces, log_weights))

        return elbo, jax.grad(obj)(bdyn)

    return step(keys, bdyn)


@functools.partial(jax.jit, static_argnames=(
    "logp", "n_steps", "mesh", "axis", "L", "eps", "eps_jitter",
    "collect_idx", "interpret"))
def sharded_hmc_chains_fused(key, logp, values0, n_steps: int, mesh: Mesh,
                             axis: str = "chains", L: int = 10,
                             eps: float = 0.1, eps_jitter: float = 0.2,
                             collect_idx=0, inv_mass_diag=None,
                             interpret: bool = False):
    """The fused HMC sampler (ops/hmc_fused.py) sharded over a mesh:
    chains are independent, so each device runs the whole kernel on its
    local chain shard with a device-folded key — zero collectives, linear
    weak scaling by construction. Where the kernel runs is the one backend
    decision (:mod:`gen_tpu.ops.backend`): the kernel on GPUs, the XLA
    sampler per shard on the CPU (how the CPU-mesh dryrun validates this
    path).

    values0: (n_chains, d) with n_chains divisible by the mesh axis size.
    ``inv_mass_diag``: optional (d,) inverse-mass diagonal (e.g. the ChEES
    warmup's adapted mass) — replicated state, forwarded to every device's
    kernel. ``interpret`` runs the kernel in Pallas interpret mode (the
    CPU tests of this path). Returns the same (values, collected,
    accept_counts) as :func:`gen_tpu.ops.hmc_fused.hmc_chains_fused`,
    sharded on the chain axis."""
    from jax import shard_map
    from ..ops.hmc_fused import hmc_chains_fused

    n_dev = mesh.shape[axis]
    n, d = values0.shape
    if n % n_dev != 0:
        raise ValueError(f"n_chains={n} not divisible by mesh axis "
                         f"{axis}={n_dev}")
    inv_mass = (jnp.ones((d,), jnp.float32) if inv_mass_diag is None
                else jnp.asarray(inv_mass_diag, jnp.float32))

    def local(vals, raw_key, inv_m):
        idx = jax.lax.axis_index(axis)
        k = jax.random.fold_in(jax.random.wrap_key_data(raw_key), idx)
        return hmc_chains_fused(k, logp, vals, n_steps=n_steps, L=L,
                                eps=eps, eps_jitter=eps_jitter,
                                collect_idx=collect_idx,
                                inv_mass_diag=inv_m, interpret=interpret)

    coll_spec = P(None, axis) if collect_idx is not None \
        else P(None, axis, None)
    # check_vma off: a pallas_call's outputs carry no varying-axes type,
    # which shard_map's check requires
    fn = shard_map(local, mesh=mesh,
                   in_specs=(P(axis), P(), P()),
                   out_specs=(P(axis), coll_spec, P(axis)), check_vma=False)
    return fn(values0, jax.random.key_data(key), inv_mass)


@functools.partial(jax.jit, static_argnames=(
    "logp", "num_ticks", "mesh", "axis", "eps", "max_depth", "collect_idx"))
def sharded_nuts_chains_fused(key, logp, values0, num_ticks: int, mesh: Mesh,
                              axis: str = "chains", eps: float = 0.1,
                              max_depth: int = 8, collect_idx=0,
                              inv_mass_diag=None):
    """The many-chain FSM-NUTS engine (ops/nuts_fused.py) sharded over a mesh:
    same zero-collective chain-parallel structure as
    :func:`sharded_hmc_chains_fused` — each device runs the full tick loop
    on its local chain shard with a device-folded key. Returns the same
    ``(values, hist, hist_counts, counts, stats)`` tuple, sharded on the
    chain axis (stats values per chain); jitted like
    :func:`sharded_hmc_chains_fused`."""
    from jax import shard_map
    from ..ops.nuts_fused import nuts_chains_fused

    n_dev = mesh.shape[axis]
    n, d = values0.shape
    if n % n_dev != 0:
        raise ValueError(f"n_chains={n} not divisible by mesh axis "
                         f"{axis}={n_dev}")
    inv_mass = (jnp.ones((d,), jnp.float32) if inv_mass_diag is None
                else jnp.asarray(inv_mass_diag, jnp.float32))

    def local(vals, raw_key, inv_m):
        idx = jax.lax.axis_index(axis)
        k = jax.random.fold_in(jax.random.wrap_key_data(raw_key), idx)
        vout, hist, hcnt, cnt, stats = nuts_chains_fused(
            k, logp, vals, num_ticks=num_ticks, eps=eps,
            max_depth=max_depth, inv_mass_diag=inv_m,
            collect_idx=collect_idx)
        return vout, hist, hcnt, cnt, (stats["mean_accept"],
                                       stats["mean_depth"],
                                       stats["num_divergent"])

    hist_spec = P(None, axis) if collect_idx is not None \
        else P(None, axis, None)
    fn = shard_map(local, mesh=mesh,
                   in_specs=(P(axis), P(), P()),
                   out_specs=(P(axis), hist_spec, P(None, axis), P(axis),
                              (P(axis), P(axis), P(axis))))
    vout, hist, hcnt, cnt, (ma, md, nd) = fn(
        values0, jax.random.key_data(key), inv_mass)
    return vout, hist, hcnt, cnt, dict(mean_accept=ma, mean_depth=md,
                                       num_divergent=nd)
