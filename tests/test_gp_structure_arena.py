"""Tests for the jitted tree-arena gp_structure engine
(examples/gp_structure_arena.py).

Reference workload: /root/reference/examples/gp_structure/involution_mh.jl
and incremental.jl. The key claims under test:

1. the full-universe arena model's ACTIVE-tree marginal is exactly the
   truncated PCFG (inactive slots integrate out),
2. the masked-selection regenerate weight on a subtree move equals the data
   log-likelihood ratio (prior terms cancel),
3. the vectorized sampler's cross-chain structure posterior matches the
   enumerated oracle (TV gate — the same gate as the eager example).
"""

import os
import sys
from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                "examples"))

import gen_tpu as gt
from gen_tpu import choicemap

import gp_structure_arena as A
import gp_structure as eager


def _dataset(n=10, seed=3):
    rng = np.random.default_rng(seed)
    xs = jnp.asarray(np.linspace(0, 1, n))
    ys = jnp.asarray(0.9 * (np.asarray(xs) - 0.4)
                     + 0.07 * rng.standard_normal(n))
    return xs, ys


def test_active_marginal_is_pcfg_prior():
    """Skeleton marginal of the arena prior == PCFG prior (max_depth=1)."""
    xs, _ = _dataset(6)
    model = A.make_arena_model(1)
    n = 20000
    keys = jax.random.split(jax.random.PRNGKey(0), n)
    traces = jax.jit(jax.vmap(lambda k: model.simulate(k, (xs,))))(keys)
    types = traces.get_retval()
    act = jax.vmap(lambda t: A.active_mask(t, 1))(types)
    skels = np.asarray(jnp.where(act, types + 1, 0).astype(jnp.int8))
    counts = Counter(map(tuple, skels.tolist()))

    exact = {}
    for s, lp in eager.enumerate_structures(0, 1):
        exact[A.skeleton_to_key(s, 1)] = float(np.exp(lp))
    assert abs(sum(exact.values()) - 1.0) < 1e-6
    tv = 0.5 * sum(abs(counts.get(k, 0) / n - p) for k, p in exact.items())
    tv += 0.5 * sum(c / n for k, c in counts.items() if k not in exact)
    assert tv < 0.03, tv


def test_subtree_regen_weight_is_lik_ratio():
    """Masked regenerate weight on the region == loglik(new) - loglik(old)."""
    from jax.scipy.stats import multivariate_normal

    xs, ys = _dataset(8)
    max_depth = 2
    N = A.n_slots(max_depth)
    model = A.make_arena_model(max_depth)

    def loglik(trace):
        types = trace.get_retval()
        p0 = jnp.stack([trace[(c, "p0")] for c in range(1, N + 1)])
        p1 = jnp.stack([trace[(c, "p1")] for c in range(1, N + 1)])
        cov = A.eval_cov_arena(types, p0, p1, xs)
        cov = cov + (trace["noise"] + 0.01) * jnp.eye(xs.shape[0])
        return multivariate_normal.logpdf(ys, jnp.zeros(xs.shape[0]), cov)

    key = jax.random.PRNGKey(7)
    trace, _ = model.generate(key, (xs,), choicemap(ys=ys))
    for i, r in enumerate([1, 2, 3]):
        sel = gt.MaskedSelection(A.region_flags(jnp.asarray(r), max_depth))
        new_trace, w, _ = trace.regenerate(jax.random.fold_in(key, i), sel)
        expect = loglik(new_trace) - loglik(trace)
        np.testing.assert_allclose(float(w), float(expect), rtol=0, atol=1e-8)


def test_region_flags():
    flags = A.region_flags(jnp.asarray(2), 2)
    got = {i for i in range(1, 8) if bool(flags[(i, "type")])}
    assert got == {2, 4, 5}
    flags = A.region_flags(jnp.asarray(1), 2)
    assert {i for i in range(1, 8) if bool(flags[(i, "type")])} == set(
        range(1, 8))


def test_posterior_matches_enumerated_oracle():
    """Cross-chain structure posterior vs the enumerated oracle, TV gate
    (the eager example's gate, at vectorized scale)."""
    xs, ys = _dataset(10)
    exact = eager.exact_structure_posterior(xs, ys, max_depth=1,
                                            num_mc=8000)
    exact_by_key = {A.skeleton_to_key(s, 1): p for s, p in exact.items()}
    emp, acc = A.structure_posterior_arena(
        jax.random.PRNGKey(0), xs, ys, max_depth=1, n_chains=384,
        n_burn=300, n_collect=150)
    assert 0.05 < acc < 0.95
    tv = 0.5 * sum(abs(emp.get(k, 0.0) - p)
                   for k, p in exact_by_key.items())
    tv += 0.5 * sum(p for k, p in emp.items() if k not in exact_by_key)
    assert tv < 0.08, (tv, acc)


def test_depth3_smoke():
    """Depth-3 arena sweeps run jitted and keep a plausible accept rate."""
    xs, ys = _dataset(12)
    model = A.make_arena_model(3)
    traces = A.init_chains(jax.random.PRNGKey(0), model, xs, ys, 32)
    traces, skels, acc = A.run_chains(jax.random.PRNGKey(1), traces, 3, 20,
                                      True)
    assert skels.shape == (20, 32, A.n_slots(3))
    assert 0.0 <= float(acc) <= 1.0
    # root slot always active
    assert np.all(np.asarray(skels)[:, :, 0] > 0)


def test_posterior_predictive_beats_mean_baseline():
    """Arena posterior predictive (reference shared.jl:182-200 workflow):
    chain-averaged held-out predictions must clearly beat the
    predict-the-training-mean baseline."""
    xs, ys = eager.make_dataset(40)
    model = A.make_arena_model(2)
    trs = A.init_chains(jax.random.PRNGKey(0), model, xs[:30], ys[:30], 32)
    trs, _, _ = A.run_chains(jax.random.PRNGKey(1), trs, 2, 150, False)
    t, p0, p1, nz = A.extract_params(trs, 2)
    mu = A.posterior_predictive_mean(t, p0, p1, nz, xs, 30, ys[:30])
    mse = float(jnp.mean((mu - ys[30:]) ** 2))
    base = float(jnp.mean((ys[30:] - jnp.mean(ys[:30])) ** 2))
    assert np.isfinite(mse) and mse < 0.5 * base, (mse, base)


# -- incremental engine (examples/gp_structure_incremental.py, round 4) ------

def test_incremental_carried_covs_stay_exact():
    """The incremental engine's carried per-slot covariance planes must
    equal a from-scratch bottom-up recompute of its (types, p0, p1) after
    many accepted moves — the invariant that makes the ancestor-path
    reuse exact rather than drifting (reference incremental.jl's
    correctness property, vectorized)."""
    import gp_structure_incremental as gi

    rng = np.random.default_rng(0)
    xs = jnp.asarray(np.linspace(0, 1, 10))
    ys = jnp.asarray(np.sin(7 * np.asarray(xs))
                     + 0.05 * rng.standard_normal(10))
    st = gi.init_state(jax.random.PRNGKey(0), xs, ys, 2, 64)
    run = gi.make_runner(2, xs, ys)
    st, _, acc = run(jax.random.PRNGKey(1), st, 60, False)
    assert float(acc) > 0.05          # moves actually accept
    fresh = gi.full_covs(st["types"], st["p0"], st["p1"], xs, 2)
    np.testing.assert_allclose(np.asarray(st["covs"]), np.asarray(fresh),
                               rtol=1e-5, atol=1e-5)
    # carried loglik too
    ll = jax.vmap(lambda c, nz: gi.mvn_loglik(ys, c, nz))(
        fresh[0], st["noise"])
    np.testing.assert_allclose(np.asarray(st["loglik"]), np.asarray(ll),
                               rtol=1e-4, atol=1e-4)


def test_incremental_matches_enumerated_oracle():
    """Depth-1 enumerated-oracle TV gate for the incremental engine (same
    oracle as the arena engine's gate)."""
    import gp_structure as eager
    import gp_structure_incremental as gi

    rng = np.random.default_rng(3)
    xs = jnp.asarray(np.linspace(0, 1, 12))
    ys = jnp.asarray(0.9 * (np.asarray(xs) - 0.4)
                     + 0.07 * rng.standard_normal(12))
    exact = eager.exact_structure_posterior(xs, ys, max_depth=1)
    exact_by_key = {A.skeleton_to_key(s, 1): p
                    for s, p in exact.items()}
    emp, acc = gi.structure_posterior_incremental(
        jax.random.PRNGKey(0), xs, ys, max_depth=1, n_chains=384,
        n_burn=500, n_collect=250)
    tv = 0.5 * sum(abs(emp.get(k, 0.0) - p)
                   for k, p in exact_by_key.items())
    tv += 0.5 * sum(p for k, p in emp.items() if k not in exact_by_key)
    assert tv < 0.08, tv


def test_incremental_depth5_smoke():
    """Depth 5 (63 slots) — impractical for the full-recompute arena
    engine, a routine configuration for the incremental one."""
    import gp_structure_incremental as gi

    rng = np.random.default_rng(7)
    xs = jnp.asarray(np.linspace(0, 1, 12))
    ys = jnp.asarray(np.sin(9 * np.asarray(xs))
                     + 0.05 * rng.standard_normal(12))
    st = gi.init_state(jax.random.PRNGKey(0), xs, ys, 5, 32)
    run = gi.make_runner(5, xs, ys)
    st, skels, acc = run(jax.random.PRNGKey(1), st, 40, True)
    assert skels.shape == (40, 32, 63)
    assert np.isfinite(np.asarray(st["loglik"])).all()


def test_airline_real_data_loader():
    """The vendored airline dataset (VERDICT r3 item 4) loads with the
    reference's preprocessing invariants: x in [0,1], y centered and
    scaled by 4/(max-min) — a SKEWED series can exceed |2| around the
    mean; the reference's own loader has the same property."""
    from gp_structure_arena import load_airline
    xs, ys = load_airline(3)
    assert xs.shape == ys.shape == (48,)
    assert float(xs.min()) >= 0.0 and float(xs.max()) <= 1.0
    assert float(jnp.abs(ys).max()) <= 4.0
    # span check: the scaling target is max - min = 4 on the FULL series
    xf, yf = load_airline(1)
    span = float(yf.max() - yf.min())
    assert abs(span - 4.0) < 1e-9, span


def test_direct_engine_matches_enumerated_oracle():
    """The round-5 DIRECT engine (no carried covariance planes, per-chain
    replace sites, full bottom-up recompute — the recompute path for
    gp_structure) is exact at depth 1: TV vs the enumerated 36-structure
    oracle."""
    import gp_structure as eager
    import gp_structure_incremental as gi

    rng = np.random.default_rng(3)
    xs = jnp.asarray(np.linspace(0, 1, 12))
    ys = jnp.asarray(0.9 * (np.asarray(xs) - 0.4)
                     + 0.07 * rng.standard_normal(12))
    exact = eager.exact_structure_posterior(xs, ys, max_depth=1)
    exact_by_key = {gi.skeleton_to_key(s, 1): p for s, p in exact.items()}
    emp, acc = gi.structure_posterior_direct(
        jax.random.PRNGKey(0), xs, ys, max_depth=1, n_chains=384,
        n_burn=500, n_collect=250)
    tv = 0.5 * sum(abs(emp.get(k, 0.0) - p)
                   for k, p in exact_by_key.items())
    tv += 0.5 * sum(p for k, p in emp.items() if k not in exact_by_key)
    assert tv < 0.08, tv
    assert 0.1 < acc < 1.0


def test_depth5_cross_engine_posterior_agreement():
    """Depth-5 correctness gate (VERDICT r4 item 6, replacing the smoke):
    the direct and incremental engines sample the SAME posterior at the
    configuration the engines exist for. Compared statistics (each an
    expectation over the depth-5 structure posterior): P(PERIODIC in
    tree), P(composite root), mean active-node count, and the root-type
    marginal TV — agreement within cross-chain MC tolerances."""
    import gp_structure_incremental as gi
    from gp_structure_arena import active_mask

    rng = np.random.default_rng(7)
    xs = jnp.asarray(np.linspace(0, 1, 14))
    ys = jnp.asarray(np.sin(9 * np.asarray(xs))
                     + 0.1 * np.asarray(xs)
                     + 0.05 * rng.standard_normal(14))
    md, n_chains, n_burn, n_collect = 5, 192, 500, 250

    def stats_of(skels):
        sk = np.asarray(skels)                       # (sweeps, B, N)
        has_per = (sk == gi.PERIODIC + 1).any(axis=-1).mean()
        root = sk[..., 0].reshape(-1)
        comp = np.isin(root, [gi.PLUS + 1, gi.TIMES + 1]).mean()
        n_active = (sk > 0).sum(axis=-1).mean()
        root_marg = np.bincount(root, minlength=7) / root.size
        return has_per, comp, n_active, root_marg

    st_i = gi.init_state(jax.random.PRNGKey(0), xs, ys, md, n_chains)
    run_i = gi.make_runner(md, xs, ys)
    st_i, _, _ = run_i(jax.random.PRNGKey(1), st_i, n_burn, False)
    _, skels_i, acc_i = run_i(jax.random.PRNGKey(2), st_i, n_collect, True)

    st_d = gi.init_state_direct(jax.random.PRNGKey(3), xs, ys, md,
                                n_chains)
    run_d = gi.make_direct_runner(md, xs, ys)
    st_d, _, _ = run_d(jax.random.PRNGKey(4), st_d, n_burn, False)
    _, skels_d, acc_d = run_d(jax.random.PRNGKey(5), st_d, n_collect, True)

    pi, ci, ni, rmi = stats_of(skels_i)
    pd_, cd, nd, rmd = stats_of(skels_d)
    assert abs(pi - pd_) < 0.08, (pi, pd_)
    assert abs(ci - cd) < 0.08, (ci, cd)
    assert abs(ni - nd) < 1.0, (ni, nd)
    assert 0.5 * np.abs(rmi - rmd).sum() < 0.08, (rmi, rmd)
    assert 0.05 < acc_i < 1.0 and 0.05 < acc_d < 1.0
