"""Exact enumerative inference over finite discrete latents.

No reference analogue (Gen.jl answers discrete posteriors by MCMC/SMC; its
tests hand-roll enumeration oracles, e.g. the HMM forward check in
test/inference/particle_filter.jl). On an accelerator, exact enumeration IS a
vectorization problem: the full Cartesian product of the latent supports
is one ``vmap`` of the key-free ``assess`` over a static grid — a few
million grid points score in one fused program, so "small discrete world"
models (structure variables, data-association indicators, model choice)
get EXACT posteriors and marginal likelihoods instead of Monte-Carlo ones.

Also the natural oracle for testing every sampler in this package against
(tests/test_enumerate.py uses it to re-verify MH/SMC/tempering posteriors).

Mixed models: enumerate the discrete addresses and hand each grid point's
continuous conditional to any other method — ``enumerate_posterior``
returns the grid + per-point log densities, so Rao-Blackwellized mixtures
compose by ``logsumexp`` over the grid axis.
"""

from __future__ import annotations

import itertools
from typing import Dict, Tuple

import jax
import jax.numpy as jnp

from ..address import addr_path
from ..choice_map import ChoiceMap
from ..gfi import GenerativeFunction
from ..utils import logsumexp


def _grid(supports):
    """Mesh the supports: dict path -> (M_i,) array of candidate values.
    Returns dict path -> (prod M_i,) flattened grid columns."""
    paths = list(supports.keys())
    arrs = [jnp.asarray(supports[p]) for p in paths]
    sizes = [a.shape[0] for a in arrs]
    mesh = jnp.meshgrid(*[jnp.arange(s) for s in sizes], indexing="ij")
    cols = {}
    for p, a, m in zip(paths, arrs, mesh):
        cols[p] = a[m.reshape(-1)]
    return cols, sizes


def enumerate_posterior(model: GenerativeFunction, args: Tuple,
                        observations: ChoiceMap,
                        supports: Dict):
    """Exact posterior over the Cartesian product of the given supports.

    ``supports``: address (key or tuple path) -> 1-D array of candidate
    values (the address's full support for exactness).

    Returns ``(grid, log_joint, log_ml, log_posterior)``:
      grid: dict path -> (G,) flattened candidate columns (G = prod sizes)
      log_joint: (G,) log p(latents = grid[g], observations)
      log_ml: scalar — log p(observations) (exact if supports are complete)
      log_posterior: (G,) normalized log p(latents = grid[g] | observations)
    """
    supports = {addr_path(k): v for k, v in supports.items()}
    cols, _ = _grid(supports)
    paths = list(cols.keys())

    def joint(vals):
        chm = ChoiceMap()
        for p, v in zip(paths, vals):
            chm.set_value(p, v)
        w, _ = model.assess(args, observations.merge(chm))
        return w

    log_joint = jax.vmap(lambda *vs: joint(vs))(*[cols[p] for p in paths])
    log_ml = logsumexp(log_joint)
    return cols, log_joint, log_ml, log_joint - log_ml


def enumerate_marginals(model: GenerativeFunction, args: Tuple,
                        observations: ChoiceMap, supports: Dict):
    """Per-address exact posterior marginals.

    Returns ``(marginals, log_ml)`` with ``marginals``: dict path ->
    (M_i,) posterior probabilities aligned with the given support order.
    """
    supports_p = {addr_path(k): jnp.asarray(v) for k, v in supports.items()}
    cols, sizes = _grid(supports_p)
    _, log_joint, log_ml, log_post = enumerate_posterior(
        model, args, observations, supports_p)
    post = jnp.exp(log_post).reshape(sizes)
    out = {}
    for i, p in enumerate(cols.keys()):
        axes = tuple(j for j in range(len(sizes)) if j != i)
        out[p] = jnp.sum(post, axis=axes)
    return out, log_ml
