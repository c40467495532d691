"""Linear-Gaussian state-space models (LGSSM) with exact Kalman inference.

The reference has no Kalman code — its state-space story is the Unfold
combinator + particle filter (SURVEY.md §5.7; examples/pmmh uses a scalar
AR(1)+noise model and a hand-written scalar Kalman recursion only as a
*test oracle*, examples/pmmh/run.jl). The multivariate linear-Gaussian
family deserves first-class support because every piece of it is dense
matrix work:

  * the Kalman filter/smoother is a ``lax.scan`` of (D x D) matmuls and
    Cholesky solves — exact marginal likelihood + posteriors in one
    compiled program, differentiable via ``jax.grad`` through the scan;
  * the collapsed marginal p(y_{1:T} | A, Q, C, R) is exposed as a
    :class:`~gen_tpu.dists.distribution.Distribution` (``lgssm(T)``), so a
    @gen model can place priors on the dynamics and run HMC/NUTS on the
    *collapsed* posterior — the Rao-Blackwellized alternative to PMMH,
    with no particles and no pseudo-marginal noise;
  * the per-particle observation weights of an SMC run over the
    uncollapsed model are a batched shared-covariance MVN logpdf — the
    batched kernel in :mod:`gen_tpu.ops.mvn`.

Generative model (time-major, T steps, state dim D, obs dim P):

    x_0 ~ N(mu0, P0);   x_t = A x_{t-1} + N(0, Q)   t = 1..T-1
    y_t = C x_t + N(0, R)                            t = 0..T-1
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..dists.distribution import Distribution, _f
from ..dists import mvnormal
from ..dynamic import gen
from ..ops.mvn import MvnChol, mvn_logpdf_rows, mvn_precompute

_LOG_2PI = 1.8378770664093453


def _mm(a, b):
    """Matrix product at full f32 precision: the Kalman recursions and the
    SMC weights feed log densities, where TF32 (a GPU's default for f32
    matmuls) loses too many digits."""
    return jnp.matmul(a, b, precision=jax.lax.Precision.HIGHEST)


class LGSSMParams(NamedTuple):
    A: jnp.ndarray    # (D, D) transition
    Q: jnp.ndarray    # (D, D) transition noise covariance
    C: jnp.ndarray    # (P, D) emission
    R: jnp.ndarray    # (P, P) emission noise covariance
    mu0: jnp.ndarray  # (D,) initial mean
    P0: jnp.ndarray   # (D, D) initial covariance


class KalmanResult(NamedTuple):
    log_ml: jnp.ndarray          # scalar: log p(y_{0:T-1})
    filtered_means: jnp.ndarray  # (T, D) E[x_t | y_{0:t}]
    filtered_covs: jnp.ndarray   # (T, D, D)
    predicted_means: jnp.ndarray  # (T, D) E[x_t | y_{0:t-1}]
    predicted_covs: jnp.ndarray   # (T, D, D)


def _sym(m):
    return 0.5 * (m + jnp.swapaxes(m, -1, -2))


def kalman_filter(params: LGSSMParams, ys) -> KalmanResult:
    """Exact filtering + marginal likelihood, one ``lax.scan`` over time.

    Differentiable w.r.t. every field of ``params`` (jax.grad through the
    scan); uses Joseph-form covariance updates for numerical symmetry.
    ``ys``: (T, P).
    """
    A, Q, C, R, mu0, P0 = (jnp.asarray(_f(p)) for p in params)
    ys = jnp.asarray(_f(ys))
    # harmonize dtypes: mixed f32/f64 inputs (e.g. f32 data with f64 traced
    # params under x64) would give the lax.scan a carry whose input/output
    # dtypes differ
    dt = jnp.result_type(A, Q, C, R, mu0, P0, ys)
    A, Q, C, R, mu0, P0, ys = (x.astype(dt)
                               for x in (A, Q, C, R, mu0, P0, ys))
    d = A.shape[-1]
    p = C.shape[-2]
    eye_d = jnp.eye(d, dtype=A.dtype)

    def step(carry, y):
        m, P, first = carry
        # predict (the t=0 step uses the prior directly: branchless select)
        m_pred = jnp.where(first, mu0, _mm(A, m))
        P_pred = jnp.where(first, P0, _sym(_mm(_mm(A, P), A.T) + Q))
        # innovation
        v = y - _mm(C, m_pred)
        S = _sym(_mm(_mm(C, P_pred), C.T) + R)
        chol_s = jnp.linalg.cholesky(S)
        s_inv_v = jax.scipy.linalg.cho_solve((chol_s, True), v)
        log_ml_t = -0.5 * (_mm(v, s_inv_v) + p * _LOG_2PI) \
            - jnp.sum(jnp.log(jnp.diagonal(chol_s)))
        # gain: K = P_pred C^T S^{-1}
        K = jax.scipy.linalg.cho_solve((chol_s, True), _mm(C, P_pred)).T
        m_filt = m_pred + _mm(K, v)
        ImKC = eye_d - _mm(K, C)
        P_filt = _sym(_mm(_mm(ImKC, P_pred), ImKC.T) + _mm(_mm(K, R), K.T))
        return ((m_filt, P_filt, jnp.zeros_like(first)),
                (log_ml_t, m_filt, P_filt, m_pred, P_pred))

    init = (mu0, P0, jnp.asarray(True))
    _, (lml_t, m_f, P_f, m_p, P_p) = jax.lax.scan(step, init, ys)
    return KalmanResult(jnp.sum(lml_t), m_f, P_f, m_p, P_p)


def kalman_smoother(params: LGSSMParams, ys):
    """Rauch–Tung–Striebel smoother: returns (means (T, D), covs (T, D, D))
    of p(x_t | y_{0:T-1}). A backward ``lax.scan`` over the filter output."""
    A, Q, _, _, _, _ = (jnp.asarray(_f(p)) for p in params)
    res = kalman_filter(params, ys)
    m_f, P_f = res.filtered_means, res.filtered_covs
    # predicted moments at t+1 given filtered at t
    m_pred_next = res.predicted_means[1:]   # (T-1, D)
    P_pred_next = res.predicted_covs[1:]    # (T-1, D, D)

    def step(carry, inp):
        m_next_s, P_next_s = carry
        m_filt, P_filt, m_pred, P_pred = inp
        # J = P_filt A^T P_pred^{-1}
        chol = jnp.linalg.cholesky(P_pred)
        J = jax.scipy.linalg.cho_solve((chol, True), _mm(A, P_filt)).T
        m_s = m_filt + _mm(J, m_next_s - m_pred)
        P_s = _sym(P_filt + _mm(_mm(J, P_next_s - P_pred), J.T))
        return (m_s, P_s), (m_s, P_s)

    init = (m_f[-1], P_f[-1])
    _, (m_s_rev, P_s_rev) = jax.lax.scan(
        step, init, (m_f[:-1], P_f[:-1], m_pred_next, P_pred_next),
        reverse=True)
    means = jnp.concatenate([m_s_rev, m_f[-1:]], axis=0)
    covs = jnp.concatenate([P_s_rev, P_f[-1:]], axis=0)
    return means, covs


@gen
def lgssm_kernel(t, prev_x, A, Q, C, R, mu0, P0):
    """Unfold/SMC kernel for the uncollapsed LGSSM: addresses "x", "y" per
    step. Branchless t==0 handling (traced t under lax.scan)."""
    first = (t == 0)
    mean = jnp.where(first, mu0, _mm(A, prev_x))
    cov = jnp.where(first, P0, Q)
    x = mvnormal(mean, cov) @ "x"
    mvnormal(_mm(C, x), R) @ "y"
    return x


class LinearGaussianSSM(Distribution):
    """``lgssm(T)``: the collapsed observation sequence y_{0:T-1} (shape
    (T, P)) of an LGSSM as a single Distribution — its logpdf is the exact
    Kalman-filter marginal likelihood.

    Placing this inside a @gen model Rao-Blackwellizes the latent states:
    MH/HMC/NUTS over (A, Q, C, R) hyperparameters runs on the exact
    collapsed posterior with zero pseudo-marginal variance (the PMMH
    workload of reference examples/pmmh without particles). logpdf is
    differentiable w.r.t. all six parameters via jax.grad through the
    Kalman scan.
    """

    arg_grads = (True, True, True, True, True, True)

    def __init__(self, num_steps: int):
        self.num_steps = int(num_steps)

    def __repr__(self):
        return f"lgssm({self.num_steps})"

    def sample(self, key, A, Q, C, R, mu0, P0):
        A, Q, C, R, mu0, P0 = (jnp.asarray(_f(v))
                               for v in (A, Q, C, R, mu0, P0))
        chol_q = jnp.linalg.cholesky(Q)
        chol_r = jnp.linalg.cholesky(R)
        chol_p0 = jnp.linalg.cholesky(P0)

        def step(carry, k):
            x, first = carry
            kx, ky = jax.random.split(k)
            ex = jax.random.normal(kx, jnp.shape(mu0), dtype=mu0.dtype)
            chol = jnp.where(first, chol_p0, chol_q)
            mean = jnp.where(first, mu0, _mm(A, x))
            x_new = mean + _mm(chol, ex)
            ey = jax.random.normal(ky, (C.shape[-2],), dtype=mu0.dtype)
            y = _mm(C, x_new) + _mm(chol_r, ey)
            return (x_new, jnp.zeros_like(first)), y

        keys = jax.random.split(key, self.num_steps)
        _, ys = jax.lax.scan(step, (mu0, jnp.asarray(True)), keys)
        return ys

    def logpdf(self, ys, A, Q, C, R, mu0, P0):
        return kalman_filter(LGSSMParams(A, Q, C, R, mu0, P0), ys).log_ml


def lgssm(num_steps: int) -> LinearGaussianSSM:
    """Factory for the collapsed-LGSSM distribution with static length."""
    return LinearGaussianSSM(num_steps)


def lgssm_batch_weights(xs, ys_t, C, prec_r: MvnChol, dtype=None):
    """Per-particle observation log-weights for one SMC step: particles
    ``xs`` (N, D), one observation ``ys_t`` (P,), shared emission noise.

    Predicted means = xs @ C.T is one (N,D)x(D,P) matmul and the
    shared-covariance MVN logpdf is one (N,P)x(P,P) matmul
    (:func:`gen_tpu.ops.mvn.mvn_logpdf_rows`), both at full f32 precision
    by default. ``dtype=jnp.bfloat16`` runs both matmuls in bf16 with f32
    accumulation — appropriate for SMC weights where Monte-Carlo error
    dominates.
    """
    xs = jnp.asarray(xs)
    C = jnp.asarray(C)
    if dtype is not None:
        mean = jax.lax.dot_general(
            xs.astype(dtype), C.astype(dtype),
            dimension_numbers=(((1,), (1,)), ((), ())),
            preferred_element_type=jnp.float32)
    else:
        mean = _mm(xs, C.T)
    return mvn_logpdf_rows(jnp.asarray(ys_t)[None, :] - mean,
                           jnp.zeros_like(mean[0]), prec_r, dtype=dtype)
