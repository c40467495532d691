"""Gaussian-process regression: exact marginals, predictives, and a
collapsed ``gp_marginal`` distribution for hyperparameter inference.

The reference treats GPs only through the covariance-structure example
(examples/gp_structure/shared.jl — dense covariance assembled per point
pair in Julia loops). Here the GP is a model family on the same footing
as the LGSSM/HMM modules (gen_tpu/models/lgssm.py:1-40 for the design
pattern):

  * pairwise distances are computed the matrix units way —
    ||x||^2 + ||x'||^2 - 2 x x'^T is one (n, d) x (d, m) matmul, not an
    O(n m d) broadcast (the broadcast materializes an (n, m, d)
    intermediate; the matmul formulation keeps the FLOPs on the matrix
    array and the memory at O(n m)),
  * the exact log marginal likelihood / posterior predictive are a single
    Cholesky + triangular solves, differentiable with ``jax.grad`` through
    everything (hyperparameter HMC/NUTS needs no custom rules),
  * ``gp_marginal(kernel)`` wraps the collapsed observation vector as a
    :class:`~gen_tpu.dists.distribution.Distribution`, so a ``@gen`` model
    can place priors on kernel hyperparameters and run any gradient
    sampler on the EXACT collapsed posterior — the Rao-Blackwellized
    alternative to sampling latent function values.

Kernels are plain callables ``k(xs1, xs2, *theta) -> (n, m)`` built from
the combinators below; compose with ``+`` / ``*`` on matrices inside a
custom callable (see examples/gp_structure.py for the grammar version).
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp

from ..dists.distribution import Distribution, _f

# f32 dots feeding a log density (kernel matrices, the log-ML quadratic
# form) run at full f32 precision, not TF32
_HI = jax.lax.Precision.HIGHEST


def pairwise_sq_dists(xs1, xs2):
    """(n, d), (m, d) -> (n, m) squared distances via the matrix units matmul
    formulation. 1-D inputs are treated as (n, 1). Clipped at 0 (the
    matmul form can go slightly negative in float arithmetic)."""
    xs1, xs2 = _f(xs1), _f(xs2)
    if xs1.ndim == 1:
        xs1 = xs1[:, None]
    if xs2.ndim == 1:
        xs2 = xs2[:, None]
    n1 = jnp.sum(xs1 * xs1, axis=-1)
    n2 = jnp.sum(xs2 * xs2, axis=-1)
    cross = jnp.matmul(xs1, xs2.T, precision=_HI)
    return jnp.maximum(n1[:, None] + n2[None, :] - 2.0 * cross, 0.0)


def rbf(xs1, xs2, variance, lengthscale):
    """Squared-exponential kernel."""
    d2 = pairwise_sq_dists(xs1, xs2)
    return variance * jnp.exp(-0.5 * d2 / (lengthscale ** 2))


def matern12(xs1, xs2, variance, lengthscale):
    d = jnp.sqrt(pairwise_sq_dists(xs1, xs2) + 1e-36)
    return variance * jnp.exp(-d / lengthscale)


def matern32(xs1, xs2, variance, lengthscale):
    d = jnp.sqrt(pairwise_sq_dists(xs1, xs2) + 1e-36)
    a = jnp.sqrt(3.0) * d / lengthscale
    return variance * (1.0 + a) * jnp.exp(-a)


def matern52(xs1, xs2, variance, lengthscale):
    d = jnp.sqrt(pairwise_sq_dists(xs1, xs2) + 1e-36)
    a = jnp.sqrt(5.0) * d / lengthscale
    return variance * (1.0 + a + a * a / 3.0) * jnp.exp(-a)


def linear_kernel(xs1, xs2, variance):
    xs1, xs2 = _f(xs1), _f(xs2)
    if xs1.ndim == 1:
        xs1 = xs1[:, None]
    if xs2.ndim == 1:
        xs2 = xs2[:, None]
    return variance * jnp.matmul(xs1, xs2.T, precision=_HI)


def periodic(xs1, xs2, variance, lengthscale, period):
    d = jnp.sqrt(pairwise_sq_dists(xs1, xs2) + 1e-36)
    s = jnp.sin(jnp.pi * d / period) / lengthscale
    return variance * jnp.exp(-2.0 * s * s)


KERNELS = {"rbf": rbf, "matern12": matern12, "matern32": matern32,
           "matern52": matern52, "linear": linear_kernel,
           "periodic": periodic}


def _chol_k(kernel_fn, xs, theta, noise):
    n = jnp.shape(xs)[0]
    k = kernel_fn(xs, xs, *theta) + (noise ** 2 + 1e-8) * jnp.eye(n)
    return jnp.linalg.cholesky(k)


def gp_log_ml(kernel_fn: Callable, xs, ys, theta, noise):
    """Exact log p(ys | xs, theta, noise): one Cholesky + one solve."""
    ys = _f(ys)
    n = ys.shape[0]
    chol = _chol_k(kernel_fn, xs, theta, noise)
    alpha = jax.scipy.linalg.cho_solve((chol, True), ys)
    return (-0.5 * jnp.dot(ys, alpha, precision=_HI)
            - jnp.sum(jnp.log(jnp.diagonal(chol)))
            - 0.5 * n * jnp.log(2.0 * jnp.pi))


def gp_posterior(kernel_fn: Callable, xs, ys, theta, noise, xstar):
    """Posterior predictive of the noise-free function at ``xstar``:
    returns (mean (m,), cov (m, m))."""
    ys = _f(ys)
    chol = _chol_k(kernel_fn, xs, theta, noise)
    k_star = kernel_fn(xs, xstar, *theta)           # (n, m)
    alpha = jax.scipy.linalg.cho_solve((chol, True), ys)
    mean = jnp.matmul(k_star.T, alpha, precision=_HI)
    v = jax.scipy.linalg.solve_triangular(chol, k_star, lower=True)
    cov = kernel_fn(xstar, xstar, *theta) - jnp.matmul(v.T, v,
                                                       precision=_HI)
    return mean, cov


def gp_predict(kernel_fn: Callable, xs, ys, theta, noise, xstar):
    """Predictive of NOISY observations at xstar: (mean, cov + noise^2 I)."""
    mean, cov = gp_posterior(kernel_fn, xs, ys, theta, noise, xstar)
    return mean, cov + (noise ** 2) * jnp.eye(jnp.shape(xstar)[0])


def gp_sample(key, kernel_fn: Callable, xs, theta, noise):
    """Draw ys ~ GP prior + observation noise at inputs xs."""
    chol = _chol_k(kernel_fn, xs, theta, noise)
    return jnp.matmul(chol, jax.random.normal(key, (jnp.shape(xs)[0],),
                                              dtype=chol.dtype),
                      precision=_HI)


class GPMarginal(Distribution):
    """``gp_marginal(kernel, n_theta)``: the collapsed noisy observation
    vector ys (shape (n,)) at inputs xs as a Distribution with args
    ``(xs, *theta, noise)`` — the GP analogue of the collapsed ``lgssm(T)``
    (gen_tpu/models/lgssm.py). Gradients w.r.t. every hyperparameter flow
    through the Cholesky; inputs xs are non-differentiable by convention.
    """

    has_output_grad = True

    def __init__(self, kernel: Callable | str, n_theta: int):
        self.kernel = KERNELS[kernel] if isinstance(kernel, str) else kernel
        self.n_theta = n_theta
        self.arg_grads = (False,) + (True,) * n_theta + (True,)

    def sample(self, key, xs, *rest):
        theta, noise = rest[:-1], rest[-1]
        return gp_sample(key, self.kernel, xs, theta, noise)

    def logpdf(self, v, xs, *rest):
        theta, noise = rest[:-1], rest[-1]
        return gp_log_ml(self.kernel, xs, _f(v), theta, noise)


def gp_marginal(kernel: Callable | str, n_theta: int = 2) -> GPMarginal:
    return GPMarginal(kernel, n_theta)


def _make_gp_latent():
    from ..dynamic import gen as _gen
    from ..dists import broadcasted_normal

    @_gen
    def gp_latent_rbf(xs, variance, lengthscale, jitter=1e-6):
        """Whitened latent GP: traces iid-normal "z" and returns
        f = chol(K_rbf(xs)) @ z. The WHITENED parameterization is the
        standard fix for hyperparameter moves in latent-GP models: under
        the direct ``f ~ mvnormal(0, K(theta))`` parameterization, any
        proposal changing theta at fixed f shifts the prior density by
        tens of nats and suffocates (examples/gp_classification.py
        documents the failure); with z as the traced address, changing
        theta re-warps f automatically and HMC/NUTS can move (z, theta)
        jointly. Differentiable end to end (grad flows through the
        Cholesky)."""
        n = xs.shape[0]
        z = broadcasted_normal(jnp.zeros(n), 1.0) @ "z"
        k = rbf(xs, xs, variance, lengthscale) + jitter * jnp.eye(n)
        return jnp.matmul(jnp.linalg.cholesky(k), z, precision=_HI)

    return gp_latent_rbf


gp_latent_rbf = _make_gp_latent()
