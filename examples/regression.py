"""Robust Bayesian linear regression with outliers.

Reference: /root/reference/examples/regression/*.jl (the quickstart model:
slope/intercept priors, per-point outlier indicators, inlier/outlier noise).
Inference: importance sampling, block-MH over parameters + Gibbs-style
sweeps over outlier indicators, and MALA/HMC over the continuous block —
all vmapped over chains on one chip.

Run: python examples/regression.py
"""

import jax
import jax.numpy as jnp
import numpy as np

import gen_tpu as gt
from gen_tpu import Map, choicemap, gen, select, vector_choicemap
from gen_tpu.inference import (hmc, importance_sampling, mala, mh_selection)


@gen
def datum(x, slope, intercept, inlier_std, outlier_std):
    is_outlier = gt.bernoulli(0.5) @ "is_outlier"
    mu = slope * x + intercept
    std = jnp.where(is_outlier, outlier_std, inlier_std)
    y = gt.normal(mu, std) @ "y"
    return y


data_fn = Map(datum)


@gen
def model(xs):
    slope = gt.normal(0.0, 2.0) @ "slope"
    intercept = gt.normal(0.0, 2.0) @ "intercept"
    inlier_log_std = gt.normal(0.0, 1.0) @ "inlier_log_std"
    outlier_log_std = gt.normal(2.0, 1.0) @ "outlier_log_std"
    n = xs.shape[0]
    ys = data_fn(
        xs,
        jnp.full(n, slope), jnp.full(n, intercept),
        jnp.full(n, jnp.exp(inlier_log_std)),
        jnp.full(n, jnp.exp(outlier_log_std))) @ "data"
    return ys


def make_dataset(n=50, seed=0):
    rng = np.random.default_rng(seed)
    xs = np.linspace(-5, 5, n)
    ys = -1.2 * xs + 2.0 + rng.normal(0, 0.5, n)
    outliers = rng.random(n) < 0.15
    ys[outliers] = rng.normal(0, 8.0, outliers.sum())
    return jnp.asarray(xs), jnp.asarray(ys)


PARAM_SEL = select("slope", "intercept", "inlier_log_std", "outlier_log_std")


def gibbs_indicators(key, trace, xs, ys):
    """Exact Gibbs on all outlier indicators at once: they are conditionally
    independent given the parameters, so one vectorized sample + one fused
    `update` replaces the reference's per-point loop (the accelerator-idiomatic form
    of examples/regression's Gibbs sweep)."""
    slope = trace["slope"]
    intercept = trace["intercept"]
    in_std = jnp.exp(trace["inlier_log_std"])
    out_std = jnp.exp(trace["outlier_log_std"])
    mu = slope * xs + intercept
    lp_out = -0.5 * ((ys - mu) / out_std) ** 2 - jnp.log(out_std)
    lp_in = -0.5 * ((ys - mu) / in_std) ** 2 - jnp.log(in_std)
    p_out = jax.nn.sigmoid(lp_out - lp_in)
    flags = jax.random.bernoulli(key, p_out)
    cons = gt.ChoiceMap()
    cons.set_submap("data", vector_choicemap(xs.shape[0], is_outlier=flags))
    new_trace, _, _, _ = trace.update(None, cons)
    return new_trace


def mcmc_sweep(key, trace, xs, ys):
    """One sweep: HMC over continuous params + exact Gibbs over indicators."""
    k1, k2 = jax.random.split(key)
    trace, _ = hmc(k1, trace, PARAM_SEL, L=10, eps=0.02)
    return gibbs_indicators(k2, trace, xs, ys)


def main(n_sweeps=200, seed=0):
    xs, ys = make_dataset()
    n = xs.shape[0]
    obs = gt.ChoiceMap()
    obs.set_submap("data", vector_choicemap(n, y=ys))
    key = jax.random.PRNGKey(seed)

    # importance sampling baseline for log-ML
    k_is, k_init, k_run = jax.random.split(key, 3)
    _, _, lml = importance_sampling(k_is, model, (xs,), obs, 2000)
    print(f"IS log-ML estimate (2000 particles): {float(lml):.2f}")

    trace, _ = model.generate(k_init, (xs,), obs)

    @jax.jit
    def sweep_fn(trace, k):
        tr = mcmc_sweep(k, trace, xs, ys)
        return tr, (tr["slope"], tr["intercept"])

    slopes, intercepts = [], []
    for i in range(n_sweeps):
        k_run, sub = jax.random.split(k_run)
        trace, (s, it) = sweep_fn(trace, sub)
        slopes.append(float(s))
        intercepts.append(float(it))

    burn = n_sweeps // 4
    s_mean = np.mean(slopes[burn:])
    i_mean = np.mean(intercepts[burn:])
    n_out = sum(bool(trace[("data", i, "is_outlier")]) for i in range(n))
    print(f"posterior slope     ≈ {s_mean:.3f}  (true -1.2)")
    print(f"posterior intercept ≈ {i_mean:.3f}  (true  2.0)")
    print(f"inferred outliers: {n_out}/{n}")
    assert abs(s_mean + 1.2) < 0.25, s_mean
    assert abs(i_mean - 2.0) < 0.45, i_mean
    print("regression example OK")
    return s_mean, i_mean


if __name__ == "__main__":
    main()
