"""Laplace approximation: posterior mode, Gaussian curvature, and a
log-evidence estimate.

No reference analogue: Gen.jl ships ``map_optimize`` (the mode) but nothing
that turns the mode into an approximate posterior / marginal likelihood.
On an accelerator the missing pieces are one ``jax.hessian`` of the same key-free
score function the gradients already use, so the full approximation is a
few fused programs:

  log p(obs) ~= log p(mode, obs) + (d/2) log 2*pi - (1/2) log det(-H)

with H the Hessian of the log joint at the mode. The evidence estimate is
meaningful when ``selection`` covers EVERY unobserved continuous address
(otherwise it is a conditional evidence given the unselected choices).
Model comparison via Laplace evidence pairs naturally with
:func:`gen_tpu.inference.enumerate_posterior` (exact, discrete) and AIS
(:func:`gen_tpu.inference.ais`, stochastic, asymptotically exact).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..diff import all_no_change
from ..gfi import Trace
from ..selection import Selection
from .common import flat_selected
from .map_optimize import map_optimize


class LaplaceResult(NamedTuple):
    trace: Trace          # trace moved to the posterior mode
    mean: jnp.ndarray     # (d,) flat mode (to_array order of the selection)
    cov: jnp.ndarray      # (d, d) inverse negative Hessian at the mode
    log_ml: jnp.ndarray   # scalar Laplace evidence estimate
    rebuild: object       # flat vector -> ChoiceMap (from_array order)


def laplace_approx(trace: Trace, selection: Selection,
                   n_optimize: int = 200,
                   max_step_size: float = 0.1) -> LaplaceResult:
    """Laplace-approximate the posterior over the selected continuous
    choices of ``trace`` (whose unselected choices/observations stay
    fixed). Runs ``n_optimize`` backtracking gradient-ascent moves to find
    the mode, then evaluates the Hessian of the log joint there.
    """
    gen_fn = trace.get_gen_fn()
    args = trace.get_args()
    argdiffs = all_no_change(args)

    def opt_step(tr, _):
        return map_optimize(tr, selection,
                            max_step_size=max_step_size), None

    mode_trace, _ = jax.lax.scan(opt_step, trace, None, length=n_optimize)

    vec, rebuild = flat_selected(mode_trace, selection)

    def logjoint(v):
        new_tr, _, _, _ = gen_fn.update(None, mode_trace, args, argdiffs,
                                        rebuild(v))
        return new_tr.get_score()

    h = jax.hessian(logjoint)(vec)
    h = 0.5 * (h + h.T)
    neg_h = -h
    chol = jnp.linalg.cholesky(neg_h)
    logdet = 2.0 * jnp.sum(jnp.log(jnp.diagonal(chol)))
    d = vec.shape[0]
    log_ml = (mode_trace.get_score()
              + 0.5 * d * jnp.log(2.0 * jnp.pi) - 0.5 * logdet)
    cov = jax.scipy.linalg.cho_solve((chol, True), jnp.eye(d))
    return LaplaceResult(mode_trace, vec, cov, log_ml, rebuild)


def laplace_sample(key, result: LaplaceResult, num_samples: int):
    """Draw flat samples (num_samples, d) from the Laplace Gaussian; map
    each row through ``result.rebuild`` to get choice maps."""
    chol = jnp.linalg.cholesky(result.cov)
    eps = jax.random.normal(key, (num_samples, result.mean.shape[0]))
    return result.mean[None, :] + eps @ chol.T
