"""Many-chain FSM-NUTS as one compiled XLA program.

:func:`nuts_chains_fused` vmaps the pair-scheduled FSM-NUTS engine
(:func:`gen_tpu.inference.nuts_fsm.nuts_fsm_paired`) over chains: every
chain does real leapfrog work every tick, with no vmap lockstep on tree
depth, and the whole run is one call. All bookkeeping — power-of-two
momentum checkpoints, block-end U-turn tests, progressive multinomial
candidate selection, biased tree merging, trajectory completion — is
branchless per-chain arithmetic.

The per-chain state is about ``16 + (max_depth - 1)`` d-vectors (tree
endpoints, candidates, checkpoints). At 131,072 chains and d=10 that is
about 120 MB, more than the card's 50 MB L2, so every tick streams it
through device memory; what a hand-written kernel could still save is
launch overhead, which only a trace can size (see ROADMAP).

Reference lineage: the NUTS semantics follow Hoffman & Gelman (2014) as
adopted by the reference's HMC family (inference/hmc.jl:25-73 is its only
dynamic-trajectory-free ancestor); the FSM scheduling has no reference
analogue.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional

import jax
import jax.numpy as jnp


def extract_completed_draws(hist, hist_cnt, m: int):
    """(ticks, n[, d]) tick-series + completed-count streams -> (m, n[, d])
    completed draws: draw i of chain j is the series value at the first
    tick where the count reaches i+1 (``hist_cnt`` is nondecreasing per
    chain, so this is a per-chain searchsorted). These draws weight each
    completed trajectory's endpoint exactly once — use THESE for moments;
    the raw tick series is length-biased (inspection paradox)."""
    idx = jax.vmap(lambda col: jnp.searchsorted(col, jnp.arange(1, m + 1)))(
        hist_cnt.T)                                   # (n, m)
    if hist.ndim == 2:
        return jax.vmap(lambda col, ix: col[ix])(hist.T, idx).T
    return jnp.swapaxes(
        jax.vmap(lambda col, ix: col[ix])(jnp.moveaxis(hist, 0, 1), idx),
        0, 1)


@functools.partial(jax.jit, static_argnames=(
    "logp", "num_ticks", "eps", "max_depth", "collect_idx",
    "divergence_threshold"))
def nuts_chains_fused(key, logp: Callable, values0, num_ticks: int,
                      eps: float, max_depth: int = 8,
                      inv_mass_diag=None, collect_idx: Optional[int] = 0,
                      divergence_threshold: float = 1000.0):
    """Run ``num_ticks`` FSM-NUTS leapfrog slots on (n_chains, d) values.

    Returns ``(values (n, d), hist (pairs, n), hist_counts (pairs, n)
    int32, counts (n,), stats)`` with ``pairs = ceil(num_ticks / 2)`` (the
    engine runs two leapfrogs per tick): ``hist[t, j]`` is coordinate
    ``collect_idx`` (all coordinates, ``(pairs, n, d)``, when
    ``collect_idx=None``) of chain j's CURRENT sample after tick t
    (piecewise-constant between trajectory completions — a valid series
    for autocorrelation ESS, but length-biased for MOMENTS via the
    inspection paradox); ``hist_counts[t, j]`` is the completed-trajectory
    count after tick t (it grows by at most 1 per tick), so
    :func:`extract_completed_draws` extracts each completed draw exactly
    once; ``counts`` the final completed-trajectory counts; ``stats`` a
    dict with ``mean_accept``/``mean_depth``/``num_divergent`` per chain.
    ``eps`` is static; ``inv_mass_diag`` may be traced."""
    from ..inference.nuts_fsm import nuts_fsm_paired
    values0 = jnp.asarray(values0, jnp.float32)
    n, d = values0.shape
    inv_mass = (jnp.ones((d,), jnp.float32) if inv_mass_diag is None
                else jnp.asarray(inv_mass_diag, jnp.float32))
    vag = jax.value_and_grad(logp)
    ci = "all" if collect_idx is None else collect_idx
    res, (hist, hist_cnt) = jax.vmap(
        lambda kk, t: nuts_fsm_paired(
            kk, vag, t, eps, (num_ticks + 1) // 2, max_depth=max_depth,
            inv_mass_diag=inv_mass,
            divergence_threshold=divergence_threshold,
            collect_idx=ci))(jax.random.split(key, n), values0)
    stats = dict(mean_accept=res.mean_accept, mean_depth=res.mean_depth,
                 num_divergent=res.num_divergent)
    return (res.theta, jnp.moveaxis(hist, 0, 1), hist_cnt.T, res.counts,
            stats)


def nuts_chains_fused_chunked(key, logp, values0, num_ticks: int,
                              eps: float, chunk_ticks: Optional[int] = None,
                              **kw):
    """:func:`nuts_chains_fused` in tick chunks of ``chunk_ticks``, with
    the streams stitched: one call when ``chunk_ticks`` is None. A chunk
    boundary restarts the in-flight trajectory from the current sample — a
    valid transition boundary; only the partial trajectory's leapfrogs are
    discarded. ``hist_counts`` is returned CUMULATIVE across chunks, so
    ``extract_completed_draws`` works on the stitched streams unchanged.
    Stats are count-weighted across chunks."""
    if chunk_ticks is None:
        return nuts_chains_fused(key, logp, values0, num_ticks=num_ticks,
                                 eps=eps, **kw)
    values0 = jnp.asarray(values0, jnp.float32)
    n, d = values0.shape
    hists, hcnts = [], []
    cnt_total = jnp.zeros((n,), jnp.int32)
    acc_w = jnp.zeros((n,), jnp.float32)
    depth_w = jnp.zeros((n,), jnp.float32)
    div_total = jnp.zeros((n,), jnp.int32)
    values = values0
    done = 0
    last_stats = None
    while done < num_ticks:
        t = min(chunk_ticks, num_ticks - done)
        key, k_use = jax.random.split(key)
        values, hist, hcnt, cnt, stats = nuts_chains_fused(
            k_use, logp, values, num_ticks=t, eps=eps, **kw)
        hists.append(hist)
        hcnts.append(hcnt + cnt_total[None, :])
        cntf = cnt.astype(jnp.float32)
        acc_w = acc_w + stats["mean_accept"] * cntf
        depth_w = depth_w + stats["mean_depth"] * cntf
        div_total = div_total + stats["num_divergent"]
        cnt_total = cnt_total + cnt
        last_stats = stats
        done += t
    denom = jnp.maximum(cnt_total.astype(jnp.float32), 1.0)
    # a chain with zero completed trajectories falls back to the last
    # chunk's in-flight accept statistic, matching nuts_chains_fused /
    # nuts_fsm semantics (their mean_accept does the same where cnt == 0)
    mean_accept = jnp.where(cnt_total > 0, acc_w / denom,
                            last_stats["mean_accept"])
    stats = dict(mean_accept=mean_accept, mean_depth=depth_w / denom,
                 num_divergent=div_total)
    return (values, jnp.concatenate(hists, axis=0),
            jnp.concatenate(hcnts, axis=0), cnt_total, stats)


def nuts_collect_draws(key, logp, values0, num_draws: int, eps: float,
                       max_ticks: Optional[int] = None,
                       chunk_ticks: int = 512, **kw):
    """Bounded-memory draw collection: drive :func:`nuts_chains_fused` in
    chunks of ``chunk_ticks``, extract each chunk's COMPLETED draws into a
    fixed ``(num_draws, n[, d])`` buffer, and DISCARD the tick streams —
    memory is O(num_draws * n) regardless of how many ticks the slowest
    chain needs (the stitched-stream driver holds O(total_ticks * n)).

    Returns ``(draws, values, counts, ticks_used)``; ``draws[j, i]`` is
    chain i's (j+1)-th completed-trajectory endpoint (coordinate
    ``collect_idx``, or the full vector when ``collect_idx=None``),
    NaN-filled where a chain completed fewer than ``num_draws``
    trajectories within ``max_ticks`` (default ``64 * num_draws``)."""
    values0 = jnp.asarray(values0, jnp.float32)
    n, d = values0.shape
    ci = kw.get("collect_idx", 0)
    if max_ticks is None:
        max_ticks = 64 * num_draws
    targets = jnp.arange(1, num_draws + 1)

    if ci is None:
        draws = jnp.full((num_draws, n, d), jnp.nan, jnp.float32)
    else:
        draws = jnp.full((num_draws, n), jnp.nan, jnp.float32)

    @jax.jit
    def fold_chunk(draws, base, hist, hcnt):
        """Scatter this chunk's completed draws into the buffer."""
        hcnt_abs = hcnt + base[None, :]                # (t, n) cumulative

        def per_chain(col_cnt, base_i, new_i):
            pos = jnp.clip(jnp.searchsorted(col_cnt, targets),
                           0, col_cnt.shape[0] - 1)
            mask = (targets > base_i) & (targets <= new_i)
            return pos, mask

        new_base = base + hcnt[-1]
        pos, mask = jax.vmap(per_chain, in_axes=(1, 0, 0),
                             out_axes=(0, 0))(hcnt_abs, base, new_base)
        # pos/mask: (n, num_draws); gather hist[pos[i, j], i]
        if hist.ndim == 2:
            vals = jnp.take_along_axis(hist.T, pos, axis=1)  # (n, nd)
            draws = jnp.where(mask.T, vals.T, draws)
        else:
            vals = jnp.take_along_axis(
                jnp.moveaxis(hist, 0, 1), pos[:, :, None], axis=1)
            draws = jnp.where(mask.T[:, :, None],
                              jnp.moveaxis(vals, 0, 1), draws)
        return draws, new_base

    base = jnp.zeros((n,), jnp.int32)
    values = values0
    done = 0
    while done < max_ticks:
        t = int(min(chunk_ticks, max_ticks - done))
        key, k_use = jax.random.split(key)
        values, hist, hcnt, cnt, _stats = nuts_chains_fused(
            k_use, logp, values, num_ticks=t, eps=eps, **kw)
        draws, base = fold_chunk(draws, base, hist, hcnt)
        del hist, hcnt
        done += t
        if int(jnp.min(base)) >= num_draws:
            break
    return draws, values, base, done
