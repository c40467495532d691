"""LGSSM model family: Kalman filter/smoother vs the dense-joint-Gaussian
oracle, collapsed-distribution GFI weights, SMC log-ML agreement, and the
matmul-path batched MVN kernel vs the per-row reference implementation.

Mirrors the reference test strategy (SURVEY.md §4.3: PF tested against an
exact forward algorithm — test/inference/particle_filter.jl:1-170); here
the continuous analogue of the HMM forward pass is the Kalman filter, and
the *oracle for the oracle* is brute-force joint-Gaussian algebra."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import gen_tpu as gt
from gen_tpu.models import (LGSSMParams, kalman_filter, kalman_smoother,
                            lgssm, lgssm_kernel, lgssm_batch_weights)
from gen_tpu.ops.mvn import mvn_precompute, mvn_logpdf_rows, mvn_sample_rows
from gen_tpu.dists import mvnormal

KEY = jax.random.PRNGKey(0)


def _random_params(seed=0, d=2, p=3):
    rng = np.random.default_rng(seed)
    a = 0.6 * rng.standard_normal((d, d))
    a = a / max(1.0, 1.1 * np.max(np.abs(np.linalg.eigvals(a))))
    q_half = rng.standard_normal((d, d))
    q = q_half @ q_half.T / d + 0.3 * np.eye(d)
    c = rng.standard_normal((p, d))
    r_half = rng.standard_normal((p, p))
    r = r_half @ r_half.T / p + 0.2 * np.eye(p)
    mu0 = rng.standard_normal(d)
    p0_half = rng.standard_normal((d, d))
    p0 = p0_half @ p0_half.T / d + 0.5 * np.eye(d)
    return LGSSMParams(*(jnp.asarray(m) for m in (a, q, c, r, mu0, p0)))


def _dense_joint(params, T):
    """Mean and covariance of the stacked observation vector y_{0:T-1}
    (brute force: propagate state moments, fill every cross-covariance)."""
    A, Q, C, R, mu0, P0 = (np.asarray(m) for m in params)
    d = A.shape[0]
    p = C.shape[0]
    # state marginal moments
    means = [mu0]
    covs = [P0]
    for _ in range(1, T):
        means.append(A @ means[-1])
        covs.append(A @ covs[-1] @ A.T + Q)
    # cross covs: Cov(x_s, x_t) = P_s (A^{t-s})^T for s <= t
    xcov = {}
    for s in range(T):
        acc = covs[s]
        xcov[(s, s)] = acc
        for t in range(s + 1, T):
            acc = acc @ A.T
            xcov[(s, t)] = acc
    mean_y = np.concatenate([C @ m for m in means])
    cov_y = np.zeros((T * p, T * p))
    for s in range(T):
        for t in range(s, T):
            block = C @ xcov[(s, t)] @ C.T
            if s == t:
                block = block + R
            cov_y[s * p:(s + 1) * p, t * p:(t + 1) * p] = block
            if t != s:
                cov_y[t * p:(t + 1) * p, s * p:(s + 1) * p] = block.T
    return mean_y, cov_y


def _mvn_logpdf_np(x, mean, cov):
    d = x - mean
    chol = np.linalg.cholesky(cov)
    z = np.linalg.solve(chol, d)
    return float(-0.5 * (z @ z + len(x) * np.log(2 * np.pi))
                 - np.sum(np.log(np.diag(chol))))


def _simulate_ys(params, T, seed=1):
    rng = np.random.default_rng(seed)
    A, Q, C, R, mu0, P0 = (np.asarray(m) for m in params)
    x = rng.multivariate_normal(mu0, P0)
    ys = []
    for t in range(T):
        if t > 0:
            x = rng.multivariate_normal(A @ x, Q)
        ys.append(rng.multivariate_normal(C @ x, R))
    return jnp.asarray(np.stack(ys))


def test_kalman_log_ml_matches_dense_joint():
    T = 6
    params = _random_params(seed=0)
    ys = _simulate_ys(params, T)
    mean_y, cov_y = _dense_joint(params, T)
    exact = _mvn_logpdf_np(np.asarray(ys).ravel(), mean_y, cov_y)
    res = kalman_filter(params, ys)
    np.testing.assert_allclose(float(res.log_ml), exact, rtol=1e-9)


def test_kalman_filter_posterior_matches_dense_conditioning():
    """Filtered mean at the last step == conditional mean of x_{T-1} given
    all observations (they coincide at t = T-1)."""
    T = 5
    params = _random_params(seed=2)
    ys = _simulate_ys(params, T, seed=3)
    A, Q, C, R, mu0, P0 = (np.asarray(m) for m in params)
    mean_y, cov_y = _dense_joint(params, T)
    # joint of (x_{T-1}, y_{0:T-1}): Cov(x_{T-1}, y_t) = Cov(x_t, x_{T-1})^T C^T
    d = A.shape[0]
    p = C.shape[0]
    means = [mu0]
    covs = [P0]
    for _ in range(1, T):
        means.append(A @ means[-1])
        covs.append(A @ covs[-1] @ A.T + Q)
    cross = np.zeros((d, T * p))
    for t in range(T):
        acc = covs[t]
        for _ in range(t, T - 1):
            acc = acc @ A.T
        # acc = Cov(x_t, x_{T-1})
        cross[:, t * p:(t + 1) * p] = acc.T @ C.T
    resid = np.asarray(ys).ravel() - mean_y
    cond_mean = means[-1] + cross @ np.linalg.solve(cov_y, resid)
    res = kalman_filter(params, ys)
    np.testing.assert_allclose(np.asarray(res.filtered_means[-1]), cond_mean,
                               rtol=1e-7, atol=1e-9)


def test_kalman_smoother_matches_dense_conditioning():
    """Smoothed mean at EVERY step == E[x_t | y_{0:T-1}] by dense joint
    conditioning."""
    T = 5
    params = _random_params(seed=4)
    ys = _simulate_ys(params, T, seed=5)
    A, Q, C, R, mu0, P0 = (np.asarray(m) for m in params)
    mean_y, cov_y = _dense_joint(params, T)
    d = A.shape[0]
    p = C.shape[0]
    means = [mu0]
    covs = [P0]
    for _ in range(1, T):
        means.append(A @ means[-1])
        covs.append(A @ covs[-1] @ A.T + Q)
    # Cov(x_s, x_t) with s <= t is covs[s] @ (A^T)^{t-s}
    def xcov(s, t):
        if s <= t:
            acc = covs[s]
            for _ in range(s, t):
                acc = acc @ A.T
            return acc
        return xcov(t, s).T

    resid = np.asarray(ys).ravel() - mean_y
    solve = np.linalg.solve(cov_y, resid)
    sm_means, _ = kalman_smoother(params, ys)
    for t in range(T):
        cross = np.zeros((d, T * p))
        for u in range(T):
            cross[:, u * p:(u + 1) * p] = xcov(t, u) @ C.T
        cond = means[t] + cross @ solve
        np.testing.assert_allclose(np.asarray(sm_means[t]), cond,
                                   rtol=1e-6, atol=1e-8)


def test_collapsed_lgssm_distribution_gfi():
    """generate() with ys constrained returns weight == exact Kalman
    log-ML; assess agrees; sample round-trips through logpdf finitely."""
    T = 6
    params = _random_params(seed=6)
    ys = _simulate_ys(params, T, seed=7)
    dist = lgssm(T)
    lp = dist.logpdf(ys, *params)
    exact = kalman_filter(params, ys).log_ml
    np.testing.assert_allclose(float(lp), float(exact), rtol=1e-12)

    @gt.gen
    def model(A, Q, C, R, mu0, P0):
        dist(A, Q, C, R, mu0, P0) @ "ys"

    tr, w = model.generate(KEY, tuple(params), gt.choicemap(ys=ys))
    np.testing.assert_allclose(float(w), float(exact), rtol=1e-9)
    # sampling path: a fresh simulate scores its own draw consistently
    tr2 = model.simulate(jax.random.PRNGKey(3), tuple(params))
    lp2 = dist.logpdf(tr2.get_choices()["ys"], *params)
    np.testing.assert_allclose(float(tr2.get_score()), float(lp2), rtol=1e-9)


def test_collapsed_lgssm_gradients_finite_diff():
    """jax.grad of the Kalman log-ML w.r.t. A matches central differences
    (the reference finite-diff harness pattern, test/runtests.jl:17-77)."""
    T = 5
    params = _random_params(seed=8)
    ys = _simulate_ys(params, T, seed=9)

    def f(a_mat):
        return kalman_filter(params._replace(A=a_mat), ys).log_ml

    g = jax.grad(f)(params.A)
    dx = 1e-6
    a_np = np.asarray(params.A)
    for i in range(a_np.shape[0]):
        for j in range(a_np.shape[1]):
            ap, am = a_np.copy(), a_np.copy()
            ap[i, j] += dx
            am[i, j] -= dx
            fd = (float(f(jnp.asarray(ap))) - float(f(jnp.asarray(am)))) / (2 * dx)
            np.testing.assert_allclose(float(g[i, j]), fd, rtol=1e-4,
                                       atol=1e-6)


def test_smc_log_ml_matches_kalman():
    """Genealogy SMC over the uncollapsed lgssm_kernel estimates the exact
    Kalman log-ML within Monte-Carlo error (reference PF-vs-HMM-forward
    test pattern)."""
    from gen_tpu.inference.smc import smc_genealogy

    T, n = 8, 4096
    params = _random_params(seed=10, d=2, p=2)
    ys = _simulate_ys(params, T, seed=11)
    exact = float(kalman_filter(params, ys).log_ml)

    obs = gt.vector_choicemap(T, y=ys)
    lmls = []
    for s in range(3):
        _, _, _, lml = smc_genealogy(
            jax.random.PRNGKey(s), lgssm_kernel,
            jnp.zeros_like(params.mu0), tuple(params), obs, n)
        lmls.append(float(lml))
    assert abs(np.mean(lmls) - exact) < 0.15, (lmls, exact)


def test_mvn_logpdf_rows_matches_reference():
    rng = np.random.default_rng(12)
    n, d = 64, 5
    cov_half = rng.standard_normal((d, d))
    cov = jnp.asarray(cov_half @ cov_half.T + d * np.eye(d))
    mu = jnp.asarray(rng.standard_normal(d))
    xs = jnp.asarray(rng.standard_normal((n, d)))
    prec = mvn_precompute(cov)
    fast = mvn_logpdf_rows(xs, mu, prec)
    ref = jax.vmap(lambda x: mvnormal.logpdf(x, mu, cov))(xs)
    np.testing.assert_allclose(np.asarray(fast), np.asarray(ref), rtol=1e-9)


def test_mvn_logpdf_rows_bf16_close():
    """bf16 matmul path stays within the documented tolerance of f32."""
    rng = np.random.default_rng(13)
    n, d = 256, 16
    cov_half = rng.standard_normal((d, d))
    cov = jnp.asarray((cov_half @ cov_half.T + d * np.eye(d)).astype(np.float32))
    mu = jnp.zeros(d, jnp.float32)
    xs = jnp.asarray(rng.standard_normal((n, d)).astype(np.float32))
    prec = mvn_precompute(cov)
    f32 = np.asarray(mvn_logpdf_rows(xs, mu, prec))
    bf16 = np.asarray(mvn_logpdf_rows(xs, mu, prec, dtype=jnp.bfloat16))
    # relative error on the quadratic form is O(2^-8); logpdfs here are O(10)
    assert np.max(np.abs(f32 - bf16)) < 0.35, np.max(np.abs(f32 - bf16))
    assert np.corrcoef(f32, bf16)[0, 1] > 0.999


def test_mvn_sample_rows_moments():
    rng = np.random.default_rng(14)
    d = 3
    cov_half = rng.standard_normal((d, d))
    cov = jnp.asarray(cov_half @ cov_half.T + d * np.eye(d))
    mu = jnp.asarray(rng.standard_normal(d))
    xs = np.asarray(mvn_sample_rows(jax.random.PRNGKey(5), mu, cov, 200_000))
    np.testing.assert_allclose(xs.mean(0), np.asarray(mu), atol=0.05)
    emp = np.cov(xs.T)
    np.testing.assert_allclose(emp, np.asarray(cov), atol=0.12)


def test_lgssm_batch_weights_matches_per_particle():
    rng = np.random.default_rng(15)
    n, d, p = 32, 4, 3
    params = _random_params(seed=16, d=d, p=p)
    xs = jnp.asarray(rng.standard_normal((n, d)))
    y = jnp.asarray(rng.standard_normal(p))
    prec = mvn_precompute(params.R)
    fast = lgssm_batch_weights(xs, y, params.C, prec)
    ref = jax.vmap(lambda x: mvnormal.logpdf(y, params.C @ x, params.R))(xs)
    np.testing.assert_allclose(np.asarray(fast), np.asarray(ref), rtol=1e-8)
