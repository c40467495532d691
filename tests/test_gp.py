"""GP model family: log marginal likelihood equals the dense MVN logpdf,
the posterior predictive matches the conditional-Gaussian formula, the matrix units
distance formulation is exact, hyperparameter gradients pass finite
differences, and collapsed-GP hyperparameter inference recovers truth."""

import jax
import jax.numpy as jnp
import numpy as np
from scipy import stats

import gen_tpu as gt
from gen_tpu import choicemap, gen, select
from gen_tpu.models import (gp_log_ml, gp_marginal, gp_posterior, gp_predict,
                            gp_sample, matern32, pairwise_sq_dists, periodic,
                            rbf)

KEY = jax.random.PRNGKey(0)
XS = jnp.asarray(np.random.default_rng(0).uniform(-2, 2, 12))
THETA = (1.3, 0.7)
NOISE = 0.3


def dense_cov(kernel, xs, theta, noise):
    k = np.asarray(kernel(xs, xs, *theta))
    return k + (noise ** 2 + 1e-8) * np.eye(len(np.asarray(xs)))


def test_sq_dists_mxu_formulation_exact():
    x1 = np.random.default_rng(1).standard_normal((7, 3))
    x2 = np.random.default_rng(2).standard_normal((5, 3))
    direct = ((x1[:, None, :] - x2[None, :, :]) ** 2).sum(-1)
    np.testing.assert_allclose(np.asarray(pairwise_sq_dists(x1, x2)),
                               direct, rtol=1e-10, atol=1e-10)
    # 1-D convenience
    np.testing.assert_allclose(
        np.asarray(pairwise_sq_dists(x1[:, 0], x2[:, 0])),
        (x1[:, :1] - x2[None, :, 0]) ** 2, rtol=1e-10, atol=1e-10)


def test_log_ml_equals_dense_mvn():
    ys = gp_sample(KEY, rbf, XS, THETA, NOISE)
    for kern in (rbf, matern32, lambda a, b, v, l: periodic(a, b, v, l, 2.0)):
        lml = float(gp_log_ml(kern, XS, ys, THETA, NOISE))
        cov = dense_cov(kern, XS, THETA, NOISE)
        expected = stats.multivariate_normal.logpdf(np.asarray(ys),
                                                    np.zeros(12), cov)
        np.testing.assert_allclose(lml, expected, rtol=1e-8)


def test_posterior_matches_conditional_gaussian():
    ys = gp_sample(KEY, rbf, XS, THETA, NOISE)
    xstar = jnp.asarray([-1.0, 0.3, 1.7])
    mean, cov = gp_posterior(rbf, XS, ys, THETA, NOISE, xstar)
    # direct conditional of the joint Gaussian
    k_xx = dense_cov(rbf, XS, THETA, NOISE)
    k_xs = np.asarray(rbf(XS, xstar, *THETA))
    k_ss = np.asarray(rbf(xstar, xstar, *THETA))
    sol = np.linalg.solve(k_xx, k_xs)
    np.testing.assert_allclose(np.asarray(mean), sol.T @ np.asarray(ys),
                               rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(np.asarray(cov), k_ss - k_xs.T @ sol,
                               rtol=1e-5, atol=1e-7)
    pm, pc = gp_predict(rbf, XS, ys, THETA, NOISE, xstar)
    np.testing.assert_allclose(np.asarray(pc),
                               np.asarray(cov) + NOISE ** 2 * np.eye(3),
                               rtol=1e-6, atol=1e-9)


def test_hyperparameter_gradients_finite_diff():
    ys = gp_sample(KEY, rbf, XS, THETA, NOISE)
    f = lambda v, l, s: gp_log_ml(rbf, XS, ys, (v, l), s)
    g = jax.grad(f, argnums=(0, 1, 2))(1.3, 0.7, 0.3)
    for i, (lo, hi) in enumerate([(1.3 - 1e-5, 1.3 + 1e-5),
                                  (0.7 - 1e-5, 0.7 + 1e-5),
                                  (0.3 - 1e-5, 0.3 + 1e-5)]):
        args_lo = [1.3, 0.7, 0.3]
        args_hi = [1.3, 0.7, 0.3]
        args_lo[i], args_hi[i] = lo, hi
        fd = (float(f(*args_hi)) - float(f(*args_lo))) / 2e-5
        np.testing.assert_allclose(float(g[i]), fd, rtol=1e-4, atol=1e-6)


def test_gp_marginal_distribution_in_model():
    gpdist = gp_marginal("rbf", n_theta=2)
    ys = gpdist.sample(KEY, XS, 1.3, 0.7, NOISE)
    lp = float(gpdist.logpdf(ys, XS, 1.3, 0.7, NOISE))
    np.testing.assert_allclose(
        lp, float(gp_log_ml(rbf, XS, ys, (1.3, 0.7), NOISE)), rtol=1e-10)

    @gen
    def model():
        log_ell = gt.normal(0.0, 1.0) @ "log_ell"
        gpdist(XS, 1.0, jnp.exp(log_ell), NOISE) @ "ys"

    tr = model.simulate(KEY, ())
    w, _ = model.assess((), tr.get_choices())
    np.testing.assert_allclose(float(w), float(tr.get_score()), rtol=1e-10)


def test_collapsed_gp_lengthscale_recovery():
    """HMC on the collapsed GP posterior recovers the generating
    lengthscale within the posterior's own spread."""
    from gen_tpu.inference import sample_posterior
    xs = jnp.linspace(-3, 3, 60)
    true_ell = 0.8
    ys = gp_sample(jax.random.PRNGKey(5), rbf, xs, (1.5, true_ell), 0.1)
    gpdist = gp_marginal("rbf", n_theta=2)

    @gen
    def model():
        log_ell = gt.normal(0.0, 1.0) @ "log_ell"
        gpdist(xs, 1.5, jnp.exp(log_ell), 0.1) @ "ys"

    out = sample_posterior(jax.random.PRNGKey(6), model, (),
                           choicemap(ys=ys), num_chains=4, num_warmup=150,
                           num_samples=150, max_depth=6)
    s = out.summary["log_ell"]
    assert abs(float(s["mean"]) - np.log(true_ell)) < \
        4 * float(s["sd"]) + 0.05
    assert float(s["rhat"]) < 1.05


def test_gp_latent_whitened_prior_matches_mvnormal():
    from gen_tpu.models import gp_latent_rbf
    xs2 = jnp.linspace(-1, 1, 6)
    keys = jax.random.split(jax.random.PRNGKey(7), 30000)
    fs = jax.vmap(lambda k: gp_latent_rbf.simulate(
        k, (xs2, 1.3, 0.6)).get_retval())(keys)
    emp_cov = np.cov(np.asarray(fs).T)
    np.testing.assert_allclose(emp_cov,
                               np.asarray(rbf(xs2, xs2, 1.3, 0.6)),
                               atol=0.05)


def test_whitened_hyperparameter_learning_matches_collapsed():
    """HMC over (z, log_ell) in the whitened parameterization must target
    the same log_ell posterior as the exact collapsed marginal — the move
    the direct f-parameterization cannot make at all."""
    from gen_tpu.inference import hmc
    from gen_tpu.models import gp_latent_rbf

    xs2 = jnp.linspace(-2, 2, 25)
    noise = 0.2
    ys = gp_sample(jax.random.PRNGKey(3), rbf, xs2, (1.0, 0.5), noise)

    @gen
    def model():
        log_ell = gt.normal(0.0, 0.7) @ "log_ell"
        f = gp_latent_rbf(xs2, 1.0, jnp.exp(log_ell)) @ "gp"
        gt.normal(f, noise) @ "ys"

    tr, _ = model.generate(jax.random.PRNGKey(0), (), choicemap(ys=ys))
    sel = select("log_ell", ("gp", "z"))

    @jax.jit
    def chain(tr, k):
        def step(t, sk):
            t, acc = hmc(sk, t, sel, L=20, eps=0.02)
            return t, (t["log_ell"], acc)
        return jax.lax.scan(step, tr, jax.random.split(k, 800))

    _, (ells, accs) = chain(tr, jax.random.PRNGKey(1))
    ells = np.asarray(ells)[200:]
    assert float(np.asarray(accs).mean()) > 0.4
    assert np.unique(np.round(ells, 5)).size > 100  # actually moving

    # exact collapsed posterior over log_ell by quadrature
    grid = np.linspace(-2.5, 2.5, 400)
    lp = np.array([float(gp_log_ml(rbf, xs2, ys, (1.0, np.exp(g)), noise))
                   - 0.5 * (g / 0.7) ** 2 for g in grid])
    w = np.exp(lp - lp.max())
    exact_mean = float((grid * w).sum() / w.sum())
    exact_sd = float(np.sqrt((grid ** 2 * w).sum() / w.sum()
                             - exact_mean ** 2))
    err = abs(ells.mean() - exact_mean)
    assert err < 3 * exact_sd / np.sqrt(60) + 0.08, \
        (ells.mean(), exact_mean, exact_sd)
