"""Simulation-based calibration (SBC): validate an entire inference
pipeline against its own model.

No reference analogue: Gen.jl validates inference with hand-derived
posteriors per test. SBC (Talts, Betancourt, Simpson, Vehtari & Gelman
2018) needs no closed form: draw theta ~ prior, y ~ p(y | theta), run the
inference procedure on y, and rank theta among L posterior draws — if the
procedure targets the correct posterior, every rank is uniform on
{0..L}. Any bias anywhere (weights, kernels, adaptation, diagnostics-
driven early stopping) shows up as non-uniform ranks.

accelerator-native: the whole study is ``vmap`` over trials of
(simulate -> filter observations -> run inference -> rank), one compiled
program — hundreds of full posterior runs per call is exactly the
many-chains regime the rest of the library optimizes for.
"""

from __future__ import annotations

from typing import Callable, Tuple

import jax
import jax.numpy as jnp

from ..choice_map import ChoiceMap
from ..gfi import GenerativeFunction
from ..selection import Selection


def sbc_ranks(key, model: GenerativeFunction, args: Tuple,
              obs_selection: Selection, run_inference: Callable,
              num_trials: int, thin: int = 1):
    """Run an SBC study.

    ``run_inference(key, observations: ChoiceMap) -> (L, d) array`` must
    return posterior draws over the latent coordinates in the model's
    sorted-address ``to_array`` order (e.g. the flat draws of
    `nuts_warmup_and_sample`, or `sample_posterior(...)` output re-stacked)
    and must be jit/vmap-able. ``thin`` subsamples the draws before ranking
    (SBC requires near-independent draws; autocorrelated MCMC output makes
    the rank histogram too peaked even for a correct sampler).

    Returns ``(ranks, L)``: ranks is (num_trials, d) integers in [0, L],
    the count of posterior draws below the prior draw per coordinate.
    """
    def one(k):
        k_sim, k_inf = jax.random.split(k)
        trace = model.simulate(k_sim, args)
        choices = trace.get_choices()
        obs = choices.filter(obs_selection)
        latents = choices.filter(obs_selection.complement())
        theta = latents.to_array()
        draws = run_inference(k_inf, obs)
        draws = draws[::thin]
        return jnp.sum(draws < theta[None, :], axis=0), draws.shape[0]

    ranks, ls = jax.vmap(one)(jax.random.split(key, num_trials))
    return ranks, int(ls[0])


def sbc_uniformity(ranks, L: int, num_bins: int = 20):
    """Chi-square goodness-of-fit of the rank histograms against uniform.

    Returns (statistic, dof, pvalue) per coordinate (arrays of shape (d,)).
    Small p-values (< 0.01 across coordinates, after accounting for
    multiplicity) indicate a miscalibrated pipeline.
    """
    import numpy as np
    from scipy import stats as sps
    ranks = np.asarray(ranks)
    n, d = ranks.shape
    num_bins = min(num_bins, L + 1)
    edges = np.linspace(0, L + 1, num_bins + 1)
    # ranks are integers 0..L; equal-width bins cover UNequal numbers of
    # integers unless num_bins divides L+1 — use the exact per-bin
    # integer coverage as the expected counts (otherwise a perfectly
    # uniform sampler fails the test)
    ints = np.arange(L + 1)
    per_bin = np.histogram(ints, bins=edges)[0]
    expected = n * per_bin / (L + 1)
    stat = np.empty(d)
    for j in range(d):
        counts, _ = np.histogram(ranks[:, j], bins=edges)
        stat[j] = np.sum((counts - expected) ** 2 / expected)
    dof = num_bins - 1
    pval = sps.chi2.sf(stat, dof)
    return stat, dof, pval
