"""Black-box variational inference.

Reference: /root/reference/src/inference/variational.jl (score-function /
REINFORCE estimator and multi-sample VIMCO with geometric/arithmetic
baselines). Design: the samples_per_iter axis is a ``vmap`` axis
and the entire gradient estimate for one iteration is ONE jitted program —
sample S variational traces, assess the model on all of them, form the
estimator, and differentiate the re-assessed variational log-density bundle.
Estimators are compiled once per (var_model, model) pair and reused every
iteration (the reference loops samples one at a time in Julia, with a "TODO
multithread" at variational.jl:118).

Additionally provides the reparameterization-gradient estimator (not in the
reference; required by the north star): because every continuous sampler is
a differentiable function of its PRNG key and parameters, ``jax.grad`` can
flow straight through ``simulate``."""

from __future__ import annotations

from typing import Tuple

import functools

import jax
import jax.numpy as jnp

from ..choice_map import ChoiceMap
from ..dynamic.params import override_params
from ..gfi import GenerativeFunction
from ..utils import (combine, join_static, logsumexp,
                     partition_inexact, split_static)
from .optimization import ParamUpdate


def collect_params_targets(var_model):
    """All gen fns with params reachable statically from var_model (itself
    plus combinator kernels)."""
    fns = []

    def walk(fn):
        if fn is None or fn in fns:
            return
        if getattr(fn, "params", None):
            fns.append(fn)
        for attr in ("kernel", "fn", "dist"):
            sub = getattr(fn, attr, None)
            if sub is not None and hasattr(sub, "simulate"):
                walk(sub)

    walk(var_model)
    return fns


def _bundle(fns):
    return {i: dict(fn.params) for i, fn in enumerate(fns)}


def _distribute_grads(fns, bundle_grads):
    for i, fn in enumerate(fns):
        for name, g in bundle_grads[i].items():
            acc = fn.params_grad.get(name)
            fn.params_grad[name] = g if acc is None else acc + g


def vimco_geometric_baselines(log_weights):
    """Vectorized form of reference variational.jl:23-35."""
    k = log_weights.shape[0]
    s = jnp.sum(log_weights)
    replaced = (s - log_weights) / (k - 1)
    mat = jnp.tile(log_weights, (k, 1))
    mat = mat.at[jnp.arange(k), jnp.arange(k)].set(replaced)
    return logsumexp(mat, axis=1) - jnp.log(k)


def _logdiffexp(x, y):
    m = jnp.maximum(x, y)
    return m + jnp.log(jnp.exp(x - m) - jnp.exp(y - m))


def vimco_arithmetic_baselines(log_weights):
    """Vectorized form of reference variational.jl:41-50."""
    k = log_weights.shape[0]
    log_total = logsumexp(log_weights)
    log_sum_without = _logdiffexp(log_total, log_weights)
    log_f_hat = log_sum_without - jnp.log(k - 1)
    return jnp.logaddexp(log_sum_without, log_f_hat) - jnp.log(k)


_EST_CACHE = {}


def _overrides(fns, b):
    return {id(fn): b[i] for i, fn in enumerate(fns)}


def _score_estimator(var_model, model, num_samples):
    """Jitted (key, var_args, model_args, obs, bdyn, bstatic) →
    (elbo, traces, grads) score-function estimator."""
    cache_key = ("score", id(var_model), id(model), num_samples)
    if cache_key in _EST_CACHE:
        return _EST_CACHE[cache_key]
    fns = collect_params_targets(var_model)

    @functools.partial(jax.jit, static_argnames=("va_aux", "ma_aux"))
    def est_inner(key, va_dyn, va_aux, ma_dyn, ma_aux, observations, bdyn,
                  bstatic):
        var_args = join_static(va_dyn, va_aux)
        model_args = join_static(ma_dyn, ma_aux)
        keys = jax.random.split(key, num_samples)
        b0 = combine(bdyn, bstatic)
        with override_params(_overrides(fns, b0)):
            var_traces = jax.vmap(
                lambda k: var_model.simulate(k, var_args))(keys)

        def model_weight(tr):
            w, _ = model.assess(model_args,
                                observations.merge(tr.get_choices()))
            return w

        model_ws = jax.vmap(model_weight)(var_traces)
        log_weights = model_ws - var_traces.get_score()
        elbo = jnp.mean(log_weights)

        def obj(bdyn_):
            b = combine(bdyn_, bstatic)
            with override_params(_overrides(fns, b)):
                def q_logp(tr, lw):
                    w, _ = var_model.assess(var_args, tr.get_choices())
                    return jax.lax.stop_gradient(lw) * w
                return jnp.mean(jax.vmap(q_logp)(var_traces, log_weights))

        grads = jax.grad(obj)(bdyn)
        return elbo, var_traces, grads

    def est(key, var_args, model_args, observations, bdyn, bstatic):
        va_dyn, va_aux = split_static(var_args)
        ma_dyn, ma_aux = split_static(model_args)
        return est_inner(key, va_dyn, va_aux, ma_dyn, ma_aux, observations,
                         bdyn, bstatic)

    _EST_CACHE[cache_key] = (fns, est)
    return fns, est


def single_sample_gradient_estimate(key, var_model, var_model_args, model,
                                    model_args, observations, num_samples,
                                    scale_factor=1.0):
    """Vectorized score-function estimator: the reference's
    single_sample_gradient_estimate! (variational.jl:2-21) for S samples at
    once. Accumulates into params_grad; returns (elbo, batched_traces)."""
    fns, est = _score_estimator(var_model, model, num_samples)
    bdyn, bstatic = partition_inexact(_bundle(fns))
    elbo, traces, grads = est(key, var_model_args, model_args, observations,
                              bdyn, bstatic)
    if scale_factor != 1.0:
        grads = jax.tree_util.tree_map(lambda g: g * scale_factor, grads)
    _distribute_grads(fns, grads)
    return elbo, traces


def _vimco_estimator(var_model, model, num_samples, geometric):
    cache_key = ("vimco", id(var_model), id(model), num_samples, geometric)
    if cache_key in _EST_CACHE:
        return _EST_CACHE[cache_key]
    fns = collect_params_targets(var_model)

    @functools.partial(jax.jit, static_argnames=("va_aux", "ma_aux"))
    def est_inner(key, va_dyn, va_aux, ma_dyn, ma_aux, observations, bdyn,
                  bstatic):
        var_args = join_static(va_dyn, va_aux)
        model_args = join_static(ma_dyn, ma_aux)
        keys = jax.random.split(key, num_samples)
        b0 = combine(bdyn, bstatic)
        with override_params(_overrides(fns, b0)):
            var_traces = jax.vmap(
                lambda k: var_model.simulate(k, var_args))(keys)

        def model_weight(tr):
            w, _ = model.assess(model_args,
                                observations.merge(tr.get_choices()))
            return w

        model_ws = jax.vmap(model_weight)(var_traces)
        log_weights = model_ws - var_traces.get_score()
        log_total = logsumexp(log_weights)
        L = log_total - jnp.log(num_samples)
        baselines = (vimco_geometric_baselines(log_weights) if geometric
                     else vimco_arithmetic_baselines(log_weights))
        w_norm = jnp.exp(log_weights - log_total)
        signals = (L - baselines) - w_norm

        def obj(bdyn_):
            b = combine(bdyn_, bstatic)
            with override_params(_overrides(fns, b)):
                def q_logp(tr, sig):
                    w, _ = var_model.assess(var_args, tr.get_choices())
                    return jax.lax.stop_gradient(sig) * w
                return jnp.sum(jax.vmap(q_logp)(var_traces, signals))

        grads = jax.grad(obj)(bdyn)
        return L, var_traces, w_norm, grads

    def est(key, var_args, model_args, observations, bdyn, bstatic):
        va_dyn, va_aux = split_static(var_args)
        ma_dyn, ma_aux = split_static(model_args)
        return est_inner(key, va_dyn, va_aux, ma_dyn, ma_aux, observations,
                         bdyn, bstatic)

    _EST_CACHE[cache_key] = (fns, est)
    return fns, est


def multi_sample_gradient_estimate(key, var_model, var_model_args, model,
                                   model_args, observations, num_samples,
                                   scale_factor=1.0, geometric=True):
    """VIMCO estimator (reference variational.jl:55-93). Returns
    (iwelbo_estimate, batched_traces, normalized_weights)."""
    fns, est = _vimco_estimator(var_model, model, num_samples, geometric)
    bdyn, bstatic = partition_inexact(_bundle(fns))
    L, traces, w_norm, grads = est(key, var_model_args, model_args,
                                   observations, bdyn, bstatic)
    if scale_factor != 1.0:
        grads = jax.tree_util.tree_map(lambda g: g * scale_factor, grads)
    _distribute_grads(fns, grads)
    return L, traces, w_norm


def black_box_vi(key, model: GenerativeFunction, model_args: Tuple,
                 observations: ChoiceMap, var_model: GenerativeFunction,
                 var_model_args: Tuple, update: ParamUpdate, iters=1000,
                 samples_per_iter=100, verbose=False, callback=None):
    """Reference black_box_vi! (variational.jl:96-140). Returns
    (final_elbo, batched_traces, elbo_history)."""
    elbo_history = []
    traces = None
    for it in range(iters):
        key, sub = jax.random.split(key)
        elbo, traces = single_sample_gradient_estimate(
            sub, var_model, var_model_args, model, model_args, observations,
            samples_per_iter)
        elbo_history.append(float(elbo))
        if verbose:
            print(f"iter {it}; est objective: {elbo_history[-1]:.4f}")
        if callback is not None:
            callback(it, traces, elbo_history[-1])
        update.apply()
    return elbo_history[-1], traces, jnp.asarray(elbo_history)


def black_box_vimco(key, model: GenerativeFunction, model_args: Tuple,
                    observations: ChoiceMap, var_model: GenerativeFunction,
                    var_model_args: Tuple, update: ParamUpdate,
                    num_samples: int, iters=1000, samples_per_iter=100,
                    verbose=False, geometric=True, callback=None):
    """Reference black_box_vimco! (variational.jl:142-198).

    One VIMCO estimate uses num_samples inner samples; samples_per_iter
    independent estimates are averaged per iteration."""
    history = []
    traces = None
    for it in range(iters):
        est_total = 0.0
        for _ in range(samples_per_iter):
            key, sub = jax.random.split(key)
            L, traces, _ = multi_sample_gradient_estimate(
                sub, var_model, var_model_args, model, model_args,
                observations, num_samples, 1.0 / samples_per_iter, geometric)
            est_total += float(L) / samples_per_iter
        history.append(est_total)
        if verbose:
            print(f"iter {it}; est objective: {est_total:.4f}")
        if callback is not None:
            callback(it, traces, est_total)
        update.apply()
    return history[-1], traces, jnp.asarray(history)


def reparam_vi(key, model: GenerativeFunction, model_args: Tuple,
               observations: ChoiceMap, var_model: GenerativeFunction,
               var_model_args: Tuple, update: ParamUpdate, iters=1000,
               samples_per_iter=32, verbose=False, callback=None):
    """Reparameterized-gradient VI (pathwise estimator; accelerator-native addition
    — lower variance than the score-function estimator whenever all
    variational choices are continuous). Differentiates through
    ``var_model.simulate`` itself."""
    fns = collect_params_targets(var_model)
    elbo_history = []

    @jax.jit
    def step(key_, bdyn, bstatic):
        keys = jax.random.split(key_, samples_per_iter)

        def elbo_fn(bdyn_):
            b = combine(bdyn_, bstatic)
            with override_params(_overrides(fns, b)):
                def one(k):
                    tr = var_model.simulate(k, var_model_args)
                    w, _ = model.assess(
                        model_args, observations.merge(tr.get_choices()))
                    return w - tr.get_score()
                return jnp.mean(jax.vmap(one)(keys))

        return jax.value_and_grad(elbo_fn)(bdyn)

    for it in range(iters):
        key, sub = jax.random.split(key)
        bdyn, bstatic = partition_inexact(_bundle(fns))
        elbo, grads = step(sub, bdyn, bstatic)
        _distribute_grads(fns, grads)
        elbo_history.append(float(elbo))
        if verbose:
            print(f"iter {it}; elbo: {elbo_history[-1]:.4f}")
        if callback is not None:
            callback(it, None, elbo_history[-1])
        update.apply()
    return elbo_history[-1], None, jnp.asarray(elbo_history)
