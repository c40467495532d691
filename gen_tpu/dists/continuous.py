"""Continuous distributions.

Parameterizations follow the reference files in
/root/reference/src/modeling_library/distributions/ exactly (cited per
class). All ``logpdf``s sum over elements, so every distribution is
"broadcasted" in the sense of the reference's ``broadcasted_normal``
(normal.jl:69-78): a single address may hold an array of iid (elementwise)
draws, which is the accelerator-friendly way to express vectors of choices — one
address, one fused kernel, no per-element Python loop.

Out-of-support handling uses the safe-where pattern so that ``jax.grad`` of
every logpdf is NaN-free at in-support points.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.scipy.special import betaln, gammaln

from .distribution import Distribution, _f, logsumexp2

_HALF_LOG_2PI = 0.9189385332046727  # 0.5*log(2*pi)
# f32 dots feeding a log density run at full f32 precision (not TF32)
_HI = jax.lax.Precision.HIGHEST


class Normal(Distribution):
    """normal(mu, std). Reference: distributions/normal.jl:1-116 (covers both
    the scalar and the broadcasted variant; logpdf sums elementwise as in
    normal.jl:69-78)."""

    arg_grads = (True, True)

    def sample(self, key, mu, std):
        mu, std = _f(mu), _f(std)
        shape = jnp.broadcast_shapes(jnp.shape(mu), jnp.shape(std))
        return mu + std * jax.random.normal(key, shape, dtype=jnp.result_type(mu, std))

    def logpdf(self, v, mu, std):
        v, mu, std = _f(v), _f(mu), _f(std)
        z = (v - mu) / std
        return jnp.sum(-0.5 * z * z - jnp.log(std) - _HALF_LOG_2PI)


class BroadcastedNormal(Normal):
    """Alias with explicit output shape = broadcast of (v, mu, std); identical
    math to Normal above (reference normal.jl:44-116)."""


class MvNormal(Distribution):
    """mvnormal(mu, cov). Reference: distributions/mvnormal.jl."""

    arg_grads = (True, True)

    def sample(self, key, mu, cov):
        mu, cov = _f(mu), _f(cov)
        return jax.random.multivariate_normal(key, mu, cov, method="svd")

    def logpdf(self, v, mu, cov):
        v, mu, cov = _f(v), _f(mu), _f(cov)
        d = v - mu
        chol = jnp.linalg.cholesky(cov)
        alpha = jax.scipy.linalg.cho_solve((chol, True), d)
        logdet = 2.0 * jnp.sum(jnp.log(jnp.diagonal(chol)))
        k = mu.shape[-1]
        return -0.5 * (jnp.dot(d, alpha, precision=_HI) + logdet
                       + k * 2.0 * _HALF_LOG_2PI)


class UniformContinuous(Distribution):
    """uniform(low, high). Reference: distributions/uniform_continuous.jl."""

    arg_grads = (True, True)

    def sample(self, key, low, high):
        low, high = _f(low), _f(high)
        shape = jnp.broadcast_shapes(jnp.shape(low), jnp.shape(high))
        u = jax.random.uniform(key, shape, dtype=jnp.result_type(low, high))
        return low + u * (high - low)

    def logpdf(self, v, low, high):
        v, low, high = _f(v), _f(low), _f(high)
        inside = (v >= low) & (v <= high)
        lp = -jnp.log(high - low)
        return jnp.sum(jnp.where(inside, lp, -jnp.inf))

    def logpdf_grad(self, v, low, high):
        # Analytic (reference uniform_continuous.jl): d/dv = 0 in support.
        v, low, high = _f(v), _f(low), _f(high)
        inv = 1.0 / (high - low)
        return (jnp.zeros_like(v),
                jnp.sum(jnp.broadcast_to(inv, jnp.shape(v))),
                -jnp.sum(jnp.broadcast_to(inv, jnp.shape(v))))


class Beta(Distribution):
    """beta(alpha, beta). Reference: distributions/beta.jl."""

    arg_grads = (True, True)

    def sample(self, key, alpha, beta):
        alpha, beta = _f(alpha), _f(beta)
        return jax.random.beta(key, alpha, beta)

    def logpdf(self, v, alpha, beta):
        v, alpha, beta = _f(v), _f(alpha), _f(beta)
        inside = (v > 0) & (v < 1)
        v_safe = jnp.where(inside, v, 0.5)
        lp = ((alpha - 1) * jnp.log(v_safe) + (beta - 1) * jnp.log1p(-v_safe)
              - betaln(alpha, beta))
        return jnp.sum(jnp.where(inside, lp, -jnp.inf))


class BetaUniformMixture(Distribution):
    """beta_uniform(theta, alpha, beta): w.p. theta a Beta(alpha, beta) draw,
    else Uniform(0,1). Reference: distributions/beta_uniform.jl."""

    arg_grads = (True, True, True)

    def sample(self, key, theta, alpha, beta):
        kb, kc, ku = jax.random.split(key, 3)
        use_beta = jax.random.bernoulli(kc, _f(theta))
        b = jax.random.beta(kb, _f(alpha), _f(beta))
        u = jax.random.uniform(ku, jnp.shape(b))
        return jnp.where(use_beta, b, u)

    def logpdf(self, v, theta, alpha, beta):
        v, theta = _f(v), _f(theta)
        lbeta = jnp.log(theta) + Beta().logpdf(v, alpha, beta)
        inside = (v >= 0) & (v <= 1)
        lunif = jnp.where(jnp.all(inside), jnp.log1p(-theta), -jnp.inf)
        return logsumexp2(lbeta, lunif)


class Gamma(Distribution):
    """gamma(shape, scale). Reference: distributions/gamma.jl (shape/scale
    parameterization)."""

    arg_grads = (True, True)

    def sample(self, key, shape, scale):
        shape, scale = _f(shape), _f(scale)
        return jax.random.gamma(key, shape) * scale

    def logpdf(self, v, shape, scale):
        v, shape, scale = _f(v), _f(shape), _f(scale)
        inside = v > 0
        v_safe = jnp.where(inside, v, 1.0)
        lp = ((shape - 1) * jnp.log(v_safe) - v_safe / scale
              - shape * jnp.log(scale) - gammaln(shape))
        return jnp.sum(jnp.where(inside, lp, -jnp.inf))


class InverseGamma(Distribution):
    """inv_gamma(shape, scale). Reference: distributions/inv_gamma.jl."""

    arg_grads = (True, True)

    def sample(self, key, shape, scale):
        shape, scale = _f(shape), _f(scale)
        return scale / jax.random.gamma(key, shape)

    def logpdf(self, v, shape, scale):
        v, shape, scale = _f(v), _f(shape), _f(scale)
        inside = v > 0
        v_safe = jnp.where(inside, v, 1.0)
        lp = (shape * jnp.log(scale) - (shape + 1) * jnp.log(v_safe)
              - scale / v_safe - gammaln(shape))
        return jnp.sum(jnp.where(inside, lp, -jnp.inf))


class Exponential(Distribution):
    """exponential(rate). Reference: distributions/exponential.jl."""

    arg_grads = (True,)

    def sample(self, key, rate):
        rate = _f(rate)
        return jax.random.exponential(key, jnp.shape(rate)) / rate

    def logpdf(self, v, rate):
        v, rate = _f(v), _f(rate)
        inside = v >= 0
        lp = jnp.log(rate) - rate * jnp.where(inside, v, 0.0)
        return jnp.sum(jnp.where(inside, lp, -jnp.inf))


class Cauchy(Distribution):
    """cauchy(x0, gamma). Reference: distributions/cauchy.jl."""

    arg_grads = (True, True)

    def sample(self, key, x0, gamma):
        x0, gamma = _f(x0), _f(gamma)
        shape = jnp.broadcast_shapes(jnp.shape(x0), jnp.shape(gamma))
        return x0 + gamma * jax.random.cauchy(key, shape)

    def logpdf(self, v, x0, gamma):
        v, x0, gamma = _f(v), _f(x0), _f(gamma)
        z = (v - x0) / gamma
        return jnp.sum(-jnp.log(jnp.pi) - jnp.log(gamma) - jnp.log1p(z * z))


class Laplace(Distribution):
    """laplace(loc, scale). Reference: distributions/laplace.jl."""

    arg_grads = (True, True)

    def sample(self, key, loc, scale):
        loc, scale = _f(loc), _f(scale)
        shape = jnp.broadcast_shapes(jnp.shape(loc), jnp.shape(scale))
        return loc + scale * jax.random.laplace(key, shape)

    def logpdf(self, v, loc, scale):
        v, loc, scale = _f(v), _f(loc), _f(scale)
        return jnp.sum(-jnp.abs(v - loc) / scale - jnp.log(2 * scale))


class StudentT(Distribution):
    """student_t(nu, loc, scale). Not in the reference's 19 (its examples
    hand-roll heavy-tailed likelihoods as mixtures, e.g. the regression
    outlier model); a first-class t is the standard robust alternative."""

    arg_grads = (True, True, True)

    def sample(self, key, nu, loc, scale):
        nu, loc, scale = _f(nu), _f(loc), _f(scale)
        shape = jnp.broadcast_shapes(jnp.shape(nu), jnp.shape(loc),
                                     jnp.shape(scale))
        return loc + scale * jax.random.t(key, nu, shape)

    def logpdf(self, v, nu, loc, scale):
        from jax.scipy.special import gammaln
        v, nu, loc, scale = _f(v), _f(nu), _f(loc), _f(scale)
        z = (v - loc) / scale
        lp = (gammaln((nu + 1) / 2) - gammaln(nu / 2)
              - 0.5 * jnp.log(nu * jnp.pi) - jnp.log(scale)
              - (nu + 1) / 2 * jnp.log1p(z ** 2 / nu))
        return jnp.sum(lp)


class Dirichlet(Distribution):
    """dirichlet(alpha) -> simplex vector. Not in the reference; the
    conjugate prior for categorical/multinomial component weights."""

    arg_grads = (True,)

    def sample(self, key, alpha):
        return jax.random.dirichlet(key, _f(alpha))

    def logpdf(self, v, alpha):
        from jax.scipy.special import gammaln
        v, alpha = _f(v), _f(alpha)
        lp = (jnp.sum((alpha - 1.0) * jnp.log(v), axis=-1)
              + gammaln(jnp.sum(alpha, axis=-1))
              - jnp.sum(gammaln(alpha), axis=-1))
        return jnp.sum(lp)


class PiecewiseUniform(Distribution):
    """piecewise_uniform(bounds, probs): bounds is a sorted vector of n+1 cell
    edges; probs are the n cell probabilities.
    Reference: distributions/piecewise_uniform.jl."""

    arg_grads = (True, True)

    def sample(self, key, bounds, probs):
        bounds, probs = _f(bounds), _f(probs)
        kc, ku = jax.random.split(key)
        idx = jax.random.categorical(kc, jnp.log(probs))
        lo = bounds[idx]
        hi = bounds[idx + 1]
        return lo + jax.random.uniform(ku) * (hi - lo)

    def logpdf(self, v, bounds, probs):
        v, bounds, probs = _f(v), _f(bounds), _f(probs)
        idx = jnp.clip(jnp.searchsorted(bounds, v, side="right") - 1,
                       0, probs.shape[0] - 1)
        width = bounds[idx + 1] - bounds[idx]
        inside = (v >= bounds[0]) & (v <= bounds[-1])
        lp = jnp.log(probs[idx]) - jnp.log(width)
        return jnp.sum(jnp.where(inside, lp, -jnp.inf))


class PiecewisePoissonProcess(Distribution):
    """piecewise_poisson_process(bounds, rates): a piecewise-homogeneous
    Poisson process observed as a vector of event times.
    Reference: examples/coal/poisson_process.jl:31-53.

    ``bounds`` is an ascending vector of n+1 segment edges; ``rates`` the n
    segment intensities. The density over an event vector x is the
    reference's formula exactly::

        logpdf(x) = sum_i log(rates[segment(x_i)]) - sum_j rates_j * len_j

    (-inf if bounds are not ascending or an event falls outside
    [bounds[0], bounds[-1]]).

    accelerator-native notes: the event COUNT is part of the value's static shape,
    so the singleton is observation-oriented (the reference only ever
    observes this distribution). ``sample`` requires an instance built with
    an explicit ``max_events`` and returns a PADDED vector whose inactive
    tail is +inf; logpdf ignores non-finite entries via a mask, so padded
    simulations and fixed-length observations share one density. Zero-
    length segments are allowed (the coal_sort arena pins inactive
    changepoint slots at t_end, making their segments empty).

    .. warning:: ``sample`` TRUNCATES the Poisson event count at
       ``max_events`` (the padded shape is static under XLA), which biases
       simulation when the total intensity approaches ``max_events``.
       Choose ``max_events >= total + 6 * sqrt(total)`` (truncation
       probability < 1e-8); a truncated draw is detectable as a padded
       vector with NO +inf tail entries (all ``max_events`` slots finite).
    """

    arg_grads = (False, True)

    def __init__(self, max_events=None):
        self.max_events = max_events

    def sample(self, key, bounds, rates):
        if self.max_events is None:
            raise NotImplementedError(
                "piecewise_poisson_process is observation-oriented under "
                "XLA's static shapes; construct "
                "PiecewisePoissonProcess(max_events=N) for padded "
                "simulation")
        bounds, rates = _f(bounds), _f(rates)
        lens = jnp.diff(bounds)
        cell = rates * lens
        total = jnp.sum(cell)
        kn, ku = jax.random.split(key)
        n = jnp.minimum(jax.random.poisson(kn, total), self.max_events)
        # inverse-CDF through the cumulative intensity
        cum = jnp.concatenate([jnp.zeros(1, bounds.dtype), jnp.cumsum(cell)])
        u = jax.random.uniform(ku, (self.max_events,)) * total
        seg = jnp.clip(jnp.searchsorted(cum, u, side="right") - 1,
                       0, rates.shape[0] - 1)
        pos = bounds[seg] + (u - cum[seg]) / jnp.maximum(rates[seg], 1e-30)
        return jnp.where(jnp.arange(self.max_events) < n, pos, jnp.inf)

    def logpdf(self, x, bounds, rates):
        x, bounds, rates = _f(x), _f(bounds), _f(rates)
        lens = jnp.diff(bounds)
        ascending = jnp.all(lens >= 0)
        total = jnp.sum(rates * lens)
        finite = jnp.isfinite(x)
        xs = jnp.where(finite, x, bounds[0])
        # segment of x_i: count of interior bounds strictly below it
        # (reference's half-open (b_j, b_{j+1}] convention)
        seg = jnp.sum(xs[..., None] > bounds[None, 1:-1], axis=-1)
        lp_pts = jnp.sum(jnp.where(finite, jnp.log(rates[seg]), 0.0))
        inside = jnp.all(jnp.where(finite,
                                   (xs >= bounds[0]) & (xs <= bounds[-1]),
                                   True))
        return jnp.where(ascending & inside, lp_pts - total, -jnp.inf)


class NormalLinear(Distribution):
    """normal_linear(X, beta, sigma): vector of n iid normal observations
    with mean ``X @ beta`` and shared scale ``sigma`` — the linear-model
    likelihood as a first-class distribution.

    Identical joint density to ``normal(X @ beta, sigma) @ "ys"`` (one
    address holding the whole vector, like the reference's
    broadcasted_normal, distributions/normal.jl:69-78), but the logpdf is
    computed from the Gram matrix ``G = [X|v]^T [X|v]``: with
    ``u = [beta; -1]``, the residual sum of squares is ``u^T G u``.

    Why this matters on an accelerator: ``G`` depends only on the data ``(X, v)``, so
    under ``vmap`` over chains and ``lax.scan`` over MCMC/leapfrog steps
    (where ``X`` and the observed ``v`` are loop-invariant and unbatched)
    XLA hoists the O(n p^2) Gram computation out of the loop entirely and
    each per-chain logpdf/gradient evaluation costs O(p^2) instead of
    O(n p) — the likelihood no longer touches the data at all inside the
    hot loop. For bench.py's regression posterior (n=50, p=2) this is a
    ~25x FLOP reduction per leapfrog step.

    Numerical note: the Gram form subtracts large squares (catastrophic
    cancellation when RSS << sum(v^2)); in float32 keep data standardized
    to O(1) scale, as usual for MCMC.
    """

    arg_grads = (True, True, True)

    def sample(self, key, X, beta_, sigma):
        X, beta_, sigma = _f(X), _f(beta_), _f(sigma)
        mean = X @ beta_
        return mean + sigma * jax.random.normal(key, mean.shape,
                                                dtype=mean.dtype)

    def logpdf(self, v, X, beta_, sigma):
        v, X, beta_, sigma = _f(v), _f(X), _f(beta_), _f(sigma)
        A = jnp.concatenate([X, v[:, None]], axis=1)
        # data-only: hoisted out of vmap/scan. HIGHEST: a TF32 Gram (10-bit
        # mantissa) would shift the residual sum of squares by far more
        # than the accept ratios and moment gates tolerate
        G = jnp.matmul(A.T, A, precision=_HI)
        u = jnp.concatenate([beta_, -jnp.ones((1,), dtype=beta_.dtype)])
        rss = jnp.dot(u, jnp.dot(G, u, precision=_HI), precision=_HI)
        n = X.shape[0]
        return -0.5 * rss / (sigma * sigma) - n * (jnp.log(sigma)
                                                   + _HALF_LOG_2PI)


normal = Normal()
broadcasted_normal = BroadcastedNormal()
normal_linear = NormalLinear()
mvnormal = MvNormal()
uniform = UniformContinuous()
uniform_continuous = uniform
beta = Beta()
beta_uniform = BetaUniformMixture()
gamma = Gamma()
inv_gamma = InverseGamma()
exponential = Exponential()
cauchy = Cauchy()
laplace = Laplace()
piecewise_uniform = PiecewiseUniform()
piecewise_poisson_process = PiecewisePoissonProcess()
student_t = StudentT()
dirichlet = Dirichlet()
