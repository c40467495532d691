"""Hidden Markov models with exact forward/backward inference.

The reference's HMM story is Unfold + particle filter (its PF tests check
against a hand-written forward algorithm, test/inference/particle_filter.jl
— that oracle is exactly what this module makes a first-class, batched,
differentiable library component). Everything here is scan-of-matmul work:
the forward recursion over N chains is an (N, K) x (K, K) matmul per step
(matmul once K is large), and the whole filter/smoother/FFBS runs as one
compiled program.

API mirrors :mod:`gen_tpu.models.lgssm`:

* :func:`hmm_forward` — log-ML + filtered posteriors, differentiable w.r.t.
  all parameters (Baum-Welch/EM gradients via ``jax.grad`` for free);
* :func:`hmm_smoother` — forward-backward marginals p(z_t | y_{0:T-1});
* :func:`hmm_ffbs` — forward-filter backward-sample: exact joint posterior
  draws of the state path (the Gibbs block move for switching models);
* ``hmm(T)`` — the collapsed observation sequence as a Distribution whose
  logpdf is the exact marginal likelihood: MH/HMC over transition
  parameters runs on the collapsed posterior (Rao-Blackwellized, the
  discrete analogue of ``lgssm(T)``);
* :func:`hmm_kernel` — Unfold/SMC kernel for the uncollapsed model.

Model (T steps, K states, V symbols):

    z_0 ~ Cat(init);  z_t ~ Cat(trans[z_{t-1}])   t = 1..T-1
    y_t ~ Cat(emit[z_t])                           t = 0..T-1
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..dists.distribution import Distribution, _f
from ..dists import categorical
from ..dynamic import gen
from ..utils import logsumexp


class HMMParams(NamedTuple):
    init: jnp.ndarray   # (K,) initial state probabilities
    trans: jnp.ndarray  # (K, K) row-stochastic transition matrix
    emit: jnp.ndarray   # (K, V) row-stochastic emission matrix


def _lse_rows(x, axis=-1):
    m = jnp.max(x, axis=axis, keepdims=True)
    return (m + jnp.log(jnp.sum(jnp.exp(x - m), axis=axis,
                                keepdims=True))).squeeze(axis)


def hmm_forward(params: HMMParams, ys):
    """Exact forward algorithm in log space.

    ``ys``: (T,) int observations. Returns ``(log_ml, log_alpha)`` with
    ``log_alpha`` (T, K) the UNnormalized forward potentials
    log p(z_t, y_{0:t}); filtered posteriors are
    ``softmax(log_alpha, -1)``. Differentiable w.r.t. every parameter.
    """
    init, trans, emit = (jnp.asarray(_f(p)) for p in params)
    ys = jnp.asarray(ys)
    log_init = jnp.log(init)
    log_trans = jnp.log(trans)
    log_emit = jnp.log(emit)

    def step(carry, inp):
        log_a, first = carry
        y = inp
        pred = jnp.where(
            first, log_init,
            _lse_rows(log_a[:, None] + log_trans, axis=0))
        log_a_new = pred + log_emit[:, y]
        return (log_a_new, jnp.zeros_like(first)), log_a_new

    k = init.shape[0]
    (_, _), log_alpha = jax.lax.scan(
        step, (jnp.zeros(k, log_init.dtype), jnp.asarray(True)), ys)
    return logsumexp(log_alpha[-1]), log_alpha


def hmm_forward_batched(params: HMMParams, ys_batch, dtype=None):
    """Scaled (prob-space) forward algorithm batched over sequences: the
    matmul formulation. ``ys_batch``: (N, T) int. Per step the whole batch
    advances with ONE (N, K) x (K, K) matmul — for K >= 64ish this runs on
    the matrix units, where the log-space einsum/logsumexp form is
    elementwise-bound. Per-step renormalization (the classical scaled forward
    recursion) keeps everything in range; log-ML accumulates the log
    normalizers.

    ``dtype=jnp.bfloat16`` runs the transition matmul in bf16
    (f32 accumulation) — appropriate for SMC-style weights and
    EM responsibilities, not for exact MH accept ratios.

    Returns ``(log_mls (N,), filtered (T, N, K))`` — filtered posteriors
    p(z_t | y_{0:t}) per sequence.
    """
    init, trans, emit = (jnp.asarray(_f(p)) for p in params)
    ys_batch = jnp.asarray(ys_batch)
    trans_m = trans.astype(dtype) if dtype is not None else trans
    n = ys_batch.shape[0]

    def step(carry, y_t):
        alpha, log_ml, first = carry  # alpha: (N, K) normalized
        if dtype is not None:
            pred = jax.lax.dot_general(
                alpha.astype(dtype), trans_m,
                dimension_numbers=(((1,), (0,)), ((), ())),
                preferred_element_type=jnp.float32)
        else:
            # full f32 precision: the forward recursion accumulates the
            # log-ML, where TF32 rounding would compound over T steps
            pred = jnp.matmul(alpha, trans,
                              precision=jax.lax.Precision.HIGHEST)
        pred = jnp.where(first, init[None, :], pred)
        un = pred * emit[:, y_t].T          # (N, K): emit gathered per seq
        norm = jnp.sum(un, axis=1)
        alpha = un / norm[:, None]
        return ((alpha, log_ml + jnp.log(norm), jnp.zeros_like(first)),
                alpha)

    k = init.shape[0]
    (_, log_mls, _), filtered = jax.lax.scan(
        step, (jnp.zeros((n, k), init.dtype), jnp.zeros(n, init.dtype),
               jnp.asarray(True)),
        ys_batch.T)
    return log_mls, filtered


def hmm_smoother(params: HMMParams, ys):
    """Forward-backward: (T, K) posterior marginals p(z_t | y_{0:T-1})."""
    init, trans, emit = (jnp.asarray(_f(p)) for p in params)
    ys = jnp.asarray(ys)
    log_trans = jnp.log(trans)
    log_emit = jnp.log(emit)
    log_ml, log_alpha = hmm_forward(params, ys)

    def back(log_b_next, y_next):
        # log beta_t(i) = lse_j [ log A_ij + log emit_j(y_{t+1}) + beta_{t+1}(j) ]
        log_b = _lse_rows(
            log_trans + (log_emit[:, y_next] + log_b_next)[None, :], axis=1)
        return log_b, log_b

    k = init.shape[0]
    _, log_beta_rev = jax.lax.scan(
        back, jnp.zeros(k, log_alpha.dtype), ys[1:], reverse=True)
    log_beta = jnp.concatenate(
        [log_beta_rev, jnp.zeros((1, k), log_alpha.dtype)], axis=0)
    post = log_alpha + log_beta - log_ml
    return jnp.exp(post)


def hmm_ffbs(key, params: HMMParams, ys):
    """Forward-filter backward-sample: one exact draw of z_{0:T-1} from
    p(z | y). Returns an int (T,) path."""
    init, trans, emit = (jnp.asarray(_f(p)) for p in params)
    ys = jnp.asarray(ys)
    log_trans = jnp.log(trans)
    _, log_alpha = hmm_forward(params, ys)
    T = ys.shape[0]
    k_last, k_scan = jax.random.split(key)
    z_last = jax.random.categorical(k_last, log_alpha[-1])

    def back(z_next, inp):
        log_a_t, k = inp
        logits = log_a_t + log_trans[:, z_next]
        z = jax.random.categorical(k, logits)
        return z, z

    keys = jax.random.split(k_scan, T - 1)
    _, zs_rev = jax.lax.scan(back, z_last, (log_alpha[:-1], keys),
                             reverse=True)
    return jnp.concatenate([zs_rev, z_last[None]], axis=0)


@gen
def hmm_kernel(t, prev_z, init, trans, emit):
    """Unfold/SMC kernel for the uncollapsed HMM: addresses "z", "y"."""
    probs = jnp.where(t == 0, init, trans[prev_z])
    z = categorical(probs) @ "z"
    categorical(emit[z]) @ "y"
    return z


class HiddenMarkovModel(Distribution):
    """``hmm(T)``: the collapsed observation sequence y_{0:T-1} (int (T,))
    as a single Distribution — its logpdf is the exact forward-algorithm
    marginal likelihood, differentiable w.r.t. (init, trans, emit)."""

    is_discrete = True
    has_output_grad = False
    arg_grads = (True, True, True)

    def __init__(self, num_steps: int):
        self.num_steps = int(num_steps)

    def __repr__(self):
        return f"hmm({self.num_steps})"

    def sample(self, key, init, trans, emit):
        init, trans, emit = (jnp.asarray(_f(v)) for v in (init, trans, emit))

        def step(carry, k):
            z, first = carry
            kz, ky = jax.random.split(k)
            probs = jnp.where(first, init, trans[z])
            z_new = jax.random.categorical(kz, jnp.log(probs))
            y = jax.random.categorical(ky, jnp.log(emit[z_new]))
            return (z_new, jnp.zeros_like(first)), y

        keys = jax.random.split(key, self.num_steps)
        _, ys = jax.lax.scan(step, (jnp.asarray(0), jnp.asarray(True)), keys)
        return ys

    def logpdf(self, ys, init, trans, emit):
        return hmm_forward(HMMParams(init, trans, emit), jnp.asarray(ys))[0]


def hmm(num_steps: int) -> HiddenMarkovModel:
    """Factory for the collapsed-HMM distribution with static length."""
    return HiddenMarkovModel(num_steps)
