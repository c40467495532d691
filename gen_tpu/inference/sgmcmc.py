"""Stochastic-gradient MCMC: SGLD and SGHMC with a GFI-native minibatch
target.

No reference analogue — Gen.jl's gradient kernels (hmc.jl, mala.jl) always
score the FULL dataset. At production scale the likelihood term is a sum
over millions of observations; subsampled gradients (Welling & Teh 2011
SGLD; Chen et al. 2014 SGHMC) are the standard answer, and they fit the
accelerator stack naturally: the minibatch gradient is one fused assess+grad over
a static-shape batch, and the whole chain is a ``lax.scan`` over a
prestacked epoch of batches.

The GFI adapter (:class:`MinibatchTarget`) needs no model-specific code:
for each minibatch it rebuilds the trace with the batch args/observations
via ``update`` (argdiffs = unknown-change), splits prior from likelihood
with ``project`` (same decomposition as :mod:`.tempering`), and scales the
likelihood term by ``n_total / batch_size``. Because batches of equal size
partition the data, the estimator is exactly unbiased:
mean over a partition's batches of the estimated gradient == the full-data
gradient (tested to 1e-9 in tests/test_sgmcmc.py).
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from ..diff import all_unknown_change
from ..gfi import Trace
from ..selection import Selection
from .target import FlatTarget


class MinibatchTarget:
    """Estimated log-posterior over the selected latents of a template
    trace, with the likelihood term computed on a minibatch and scaled to
    the full dataset.

    ``batch_args``/``batch_obs`` passed per call must have static shapes
    (fixed batch size) — the per-step work is then one compiled program.
    """

    def __init__(self, template_trace: Trace, selection: Selection,
                 n_total: int, batch_size: int):
        self._flat = FlatTarget(template_trace, selection)
        self._trace = template_trace
        self._gen_fn = template_trace.get_gen_fn()
        self._selection = selection
        self.dim = self._flat.dim
        self.flat0 = self._flat.flat0
        self.scale = float(n_total) / float(batch_size)
        self._values_chm = self._flat.values_chm

    def logpost_estimate(self, flat, batch_args: Tuple, batch_obs):
        """prior(flat) + (n/m) * loglik(flat; minibatch)."""
        latents = self._values_chm.from_array(flat)
        tr, _, _, _ = self._gen_fn.update(
            None, self._trace, batch_args, all_unknown_change(batch_args),
            batch_obs.merge(latents))
        prior = tr.project(self._selection)
        lik = tr.get_score() - prior
        return prior + self.scale * lik

    def grad_estimate(self, flat, batch_args: Tuple, batch_obs):
        return jax.grad(self.logpost_estimate)(flat, batch_args, batch_obs)


def sgld_step(key, flat, grad, step_size):
    """One SGLD update: flat + (eps/2) g + N(0, eps)."""
    noise = jax.random.normal(key, jnp.shape(flat), jnp.result_type(flat))
    return flat + 0.5 * step_size * grad + jnp.sqrt(step_size) * noise


def sghmc_step(key, flat, momentum, grad, step_size, friction=0.1):
    """One SGHMC update (Chen et al. 2014, eq. 15 with M = I):
    p <- (1-alpha) p + eps g + N(0, 2 alpha eps);  q <- q + p."""
    alpha = friction
    noise = jax.random.normal(key, jnp.shape(flat), jnp.result_type(flat))
    momentum = ((1.0 - alpha) * momentum + step_size * grad
                + jnp.sqrt(2.0 * alpha * step_size) * noise)
    return flat + momentum, momentum


def sgld_chain(key, target: MinibatchTarget, batch_args_stream: Tuple,
               batch_obs_stream, step_size, n_passes: int = 1,
               flat0=None, thin: int = 1):
    """Run SGLD over prestacked minibatches.

    ``batch_args_stream``: tuple of arrays with leading axis S (batches);
    ``batch_obs_stream``: ChoiceMap whose leaves carry the same leading
    axis. ``step_size``: scalar or (S * n_passes,) schedule.

    Returns (S * n_passes // thin, dim) positions.
    """
    flat = target.flat0 if flat0 is None else jnp.asarray(flat0)
    s = jax.tree_util.tree_leaves(batch_obs_stream)[0].shape[0]
    total = s * n_passes
    eps = jnp.broadcast_to(jnp.asarray(step_size), (total,))

    def step(flat, inp):
        i, k, e = inp
        idx = i % s
        bargs = jax.tree_util.tree_map(
            lambda x: jax.lax.dynamic_index_in_dim(x, idx, keepdims=False),
            batch_args_stream)
        bobs = jax.tree_util.tree_map(
            lambda x: jax.lax.dynamic_index_in_dim(x, idx, keepdims=False),
            batch_obs_stream)
        g = target.grad_estimate(flat, bargs, bobs)
        flat = sgld_step(k, flat, g, e)
        return flat, flat

    keys = jax.random.split(key, total)
    _, hist = jax.lax.scan(step, flat,
                           (jnp.arange(total), keys, eps))
    return hist[::thin]
