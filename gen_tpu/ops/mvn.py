"""Batched multivariate-normal kernels.

The reference's mvnormal (distributions/mvnormal.jl) scores one vector at a
time through a dense solve. The hot use here is *batched*: N particles /
chains scoring against ONE shared covariance (SMC importance weights, HMC
on collapsed models, BBVI minibatches). The right formulation is:

    precompute  L    = chol(cov)            once   (O(D^3), f32)
                Linv = L^{-1}               once   (O(D^3), f32)
    per batch   Z    = (X - mu) @ Linv.T           (N x D @ D x D matmul)
                logp = -0.5*(rowsum(Z*Z) + logdet + D*log(2*pi))

The batched work is a plain matmul, which XLA hands to its matrix-product
path (a vmapped cho_solve lowers to a batched triangular solve — serial
in D). The default path runs it at full f32 precision. A
``dtype=jnp.bfloat16`` input cast (f32 accumulation) takes the
low-precision matrix path instead.

bf16 accuracy note: the residual cast loses ~3 decimal digits of the
*residual*, so per-row logpdf error grows like O(||z|| * 2^-8 * sqrt(D)).
That is fine for importance/SMC weights at scale (Monte-Carlo error
dominates) and for VI gradients, but use the default f32 path inside
MH/HMC accept ratios where exactness matters.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

_LOG_2PI = 1.8378770664093453


def _precision(dtype):
    """Full f32 precision on the default path (a GPU would otherwise run
    f32 matmuls in TF32); the explicit low-precision opt-in keeps the
    error the module docstring states."""
    return jax.lax.Precision.HIGHEST if dtype is None else None


class MvnChol(NamedTuple):
    """Precomputed factorization of one shared covariance."""

    linv: jnp.ndarray    # (D, D) lower-triangular inverse Cholesky factor
    logdet: jnp.ndarray  # scalar: log det(cov)


def mvn_precompute(cov) -> MvnChol:
    """Factor a shared covariance once; reuse across the whole batch."""
    cov = jnp.asarray(cov)
    chol = jnp.linalg.cholesky(cov)
    eye = jnp.eye(cov.shape[-1], dtype=cov.dtype)
    linv = jax.scipy.linalg.solve_triangular(chol, eye, lower=True)
    logdet = 2.0 * jnp.sum(jnp.log(jnp.diagonal(chol, axis1=-2, axis2=-1)),
                           axis=-1)
    return MvnChol(linv, logdet)


def mvn_logpdf_rows(x, mu, prec: MvnChol,
                    dtype: Optional[jnp.dtype] = None) -> jnp.ndarray:
    """Row-wise MVN logpdf: ``x`` (N, D) against N(mu, cov) with ``prec``
    from :func:`mvn_precompute`.

    ``dtype=jnp.bfloat16`` casts the residuals and Linv for the matmul
    (f32 accumulation via preferred_element_type).
    Returns (N,) in f32 (or the input float dtype if wider).
    """
    x = jnp.asarray(x)
    mu = jnp.asarray(mu)
    d = x - mu
    out_dtype = jnp.result_type(d.dtype, jnp.float32)
    linv = prec.linv
    if dtype is not None:
        d = d.astype(dtype)
        linv = linv.astype(dtype)
    z = jax.lax.dot_general(
        d, linv,
        dimension_numbers=(((d.ndim - 1,), (1,)), ((), ())),
        precision=_precision(dtype), preferred_element_type=out_dtype)
    k = x.shape[-1]
    quad = jnp.sum(z * z, axis=-1)
    return (-0.5 * (quad + prec.logdet + k * _LOG_2PI)).astype(out_dtype)


def mvn_sample_rows(key, mu, prec_or_cov, n: int,
                    dtype: Optional[jnp.dtype] = None) -> jnp.ndarray:
    """Draw n samples from N(mu, cov) as an (n, D) matrix via one
    matmul: X = mu + E @ L.T with E ~ N(0, I)."""
    if isinstance(prec_or_cov, MvnChol):
        # invert back: L = linv^{-1}; cheaper to require cov/chol here
        chol = jax.scipy.linalg.solve_triangular(
            prec_or_cov.linv, jnp.eye(prec_or_cov.linv.shape[-1],
                                      dtype=prec_or_cov.linv.dtype),
            lower=True)
    else:
        chol = jnp.linalg.cholesky(jnp.asarray(prec_or_cov))
    mu = jnp.asarray(mu)
    d = chol.shape[-1]
    eps = jax.random.normal(key, (n, d), dtype=chol.dtype)
    if dtype is not None:
        eps = eps.astype(dtype)
        chol = chol.astype(dtype)
    x = jax.lax.dot_general(
        eps, chol,
        dimension_numbers=(((1,), (1,)), ((), ())),
        precision=_precision(dtype),
        preferred_element_type=jnp.result_type(mu.dtype, jnp.float32))
    return mu + x
