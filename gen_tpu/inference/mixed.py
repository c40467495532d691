"""One-call inference on mixed discrete + continuous models.

The reference's inference operators are uniform over address types —
selection-MH regenerates any selected address
(/root/reference/src/inference/mh.jl:15-29), and its flagship regression
example interleaves per-point discrete outlier moves with continuous
moves in one loop
(/root/reference/examples/regression/static_mh.jl:28-38,60-70). The
accelerator-native equivalent composes the two *exact* kernels this package
already has: NUTS over the continuous block (conditioning on the current
discrete values) alternating with rejection-free enumerative Gibbs over
every finite-support discrete address (the :mod:`gen_tpu.inference.gibbs`
mechanism: ``update`` weights over the candidate grid ARE the full
conditional). The whole alternating chain is one scanned XLA program,
vmapped over chains.

Pieces:

* **Support discovery** — a model replay under
  :class:`gen_tpu.dynamic.handlers.record_dist_calls` records which
  distribution produced each address; finite discrete distributions
  expose ``enumerate_support`` (static shapes only), so no user input is
  needed for bernoulli / categorical / uniform_discrete / binom
  addresses. Unbounded discretes (poisson, geometric) raise with advice
  unless an explicit ``discrete_supports`` override is given.

* **Vectorized addresses** (Map/Unfold combinators — the flagship
  regression's per-point indicators) are moved by a *single-site scan*:
  one ``lax.scan`` over the element index with the candidate grid scored
  by one vmapped ``update`` — program size O(1) in the number of
  elements (a per-element Python loop would inline the model once per
  element; see CLAUDE.md's compile-explosion note).

* **The alternating driver** — dual-averaging NUTS warmup (step size +
  diagonal mass from the second half of warmup, exactly
  :func:`gen_tpu.inference.nuts.nuts_warmup_and_sample`) with a Gibbs
  sweep after every NUTS transition, in warmup and sampling alike, so
  the adaptation sees the mixed chain it will actually run.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..address import addr_path
from ..choice_map import ChoiceMap
from ..combinators.vector import VectorChoiceMap
from ..dynamic.handlers import record_dist_calls
from ..selection import Selection
from .nuts import (da_init, da_update, find_reasonable_step_size, nuts_flat)
from .target import FlatTarget


class DiscreteSite(NamedTuple):
    """One enumerable discrete block: a scalar address or one dense
    vectorized leaf of a vector combinator (Map/Unfold)."""
    kind: str              # "scalar" | "vector"
    pre: Tuple             # scalar: full path; vector: vector-combinator path
    post: Tuple            # vector: leaf path inside one element; scalar: ()
    support: Any           # (G,) candidate values (stored dtype)
    length: int            # number of elements (1 for scalar)

    @property
    def path(self) -> Tuple:
        return self.pre + self.post

    @property
    def n_candidates(self) -> int:
        return int(jnp.shape(self.support)[0])


def _is_int(k) -> bool:
    return isinstance(k, (int, np.integer)) and not isinstance(k, bool)


def _strip_ints(path: Tuple) -> Tuple:
    return tuple(k for k in path if not _is_int(k))


def _is_discrete_value(v) -> bool:
    return not jnp.issubdtype(jnp.asarray(v).dtype, jnp.inexact)


def record_model_dists(model, args, observations: ChoiceMap):
    """Replay the model abstractly, recording (path, dist, args) for every
    distribution call. Paths omit combinator-inserted integer keys."""
    with record_dist_calls() as rec:
        jax.eval_shape(
            lambda k: model.generate(k, args, observations)[0],
            jax.random.PRNGKey(0))
    return rec.records


def _match_record(records, stripped: Tuple):
    """Find the recorded dist for an int-stripped trace path: exact match
    on the int-stripped recorded path, else a unique suffix match."""
    exact = [(d, a) for p, d, a in records if _strip_ints(p) == stripped]
    if exact:
        ds = {id(d) for d, _ in exact}
        if len(ds) > 1:
            raise ValueError(
                f"address {stripped!r} was produced by more than one "
                "distribution across the execution; pass explicit "
                "discrete_supports= for it")
        return exact[0]
    suffix = [(d, a) for p, d, a in records
              if stripped[-len(_strip_ints(p)):] == _strip_ints(p)
              and len(_strip_ints(p)) > 0]
    if len({id(d) for d, _ in suffix}) == 1:
        return suffix[0]
    raise ValueError(
        f"could not identify the distribution behind discrete address "
        f"{stripped!r} (records: {[p for p, _, _ in records]!r}); pass "
        "explicit discrete_supports= for it")


def discover_discrete_sites(one_trace, observations: ChoiceMap, model,
                            args, discrete_supports: Optional[Dict] = None
                            ) -> Tuple[DiscreteSite, ...]:
    """All unobserved discrete addresses of ``one_trace`` as
    :class:`DiscreteSite` blocks with enumerated supports.

    ``discrete_supports`` (address -> (G,) array) overrides/augments the
    automatic discovery — required for traced-bound or unbounded-support
    distributions.
    """
    overrides = {addr_path(k): jnp.asarray(v)
                 for k, v in (discrete_supports or {}).items()}
    records = None
    choices = one_trace.get_choices()
    sites = []

    def support_for(path: Tuple, proto):
        nonlocal records
        stripped = _strip_ints(path)
        for key in (path, stripped):
            if key in overrides:
                return overrides[key]
        if records is None:
            records = record_model_dists(model, args, observations)
        dist, dargs = _match_record(records, stripped)
        sup = dist.enumerate_support(*dargs)
        return sup.astype(jnp.asarray(proto).dtype)

    def walk(chm, prefix):
        for k, v in chm.get_values_shallow().items():
            path = prefix + (k,)
            if observations.has_value(path) or not _is_discrete_value(v):
                continue
            sites.append(DiscreteSite("scalar", path, (),
                                      support_for(path, v), 1))
        for k, sub in chm.get_submaps_shallow().items():
            path = prefix + (k,)
            if isinstance(sub, VectorChoiceMap):
                if any(isinstance(s, VectorChoiceMap)
                       for _, s in _submaps_deep(sub.inner)):
                    raise NotImplementedError(
                        f"nested vector combinators under {path!r}: "
                        "automatic discrete moves support one vector "
                        "level; hand-compose (gibbs/enumerate) instead")
                for post, v in sub.inner.leaf_items():
                    if (observations.has_value(path + (0,) + post)
                            or not _is_discrete_value(v)):
                        continue
                    sites.append(DiscreteSite(
                        "vector", path, post,
                        support_for(path + post, v), sub.length))
            else:
                walk(sub, path)

    walk(choices, ())
    return tuple(sites)


def _submaps_deep(chm):
    for k, sub in chm.get_submaps_shallow().items():
        yield k, sub
        if not isinstance(sub, VectorChoiceMap):
            yield from _submaps_deep(sub)


def _dense_value(trace, site: DiscreteSite):
    chm = trace.get_choices()
    if site.kind == "scalar":
        return chm.get_value(site.pre)
    sub = chm.get_submap(site.pre)
    if isinstance(sub, VectorChoiceMap):
        return sub.inner.get_value(site.post)
    # generic fallback: stack per-element values
    return jnp.stack([sub.get_value((i,) + site.post)
                      for i in range(site.length)])


def _build_cons(site: DiscreteSite, newv) -> ChoiceMap:
    cons = ChoiceMap()
    if site.kind == "scalar":
        cons.set_value(site.pre, newv)
        return cons
    inner = ChoiceMap()
    inner.set_value(site.post, newv)
    cons.set_submap(site.pre, VectorChoiceMap(inner, site.length))
    return cons


def gibbs_sweep(key, trace, sites: Tuple[DiscreteSite, ...]):
    """One systematic exact-Gibbs sweep over every site: each scalar site
    and each element of each vector site is resampled from its exact full
    conditional (``update`` weights over the support = the conditional up
    to normalization — rejection-free, detailed-balance-exact). Vector
    sites scan over elements with a traced index, so program size is
    O(sites), not O(elements)."""
    for si, site in enumerate(sites):
        k_site = jax.random.fold_in(key, si)
        if site.kind == "scalar":
            def score(c, site=site, trace=trace):
                new_tr, w, _, _ = trace.update(None, _build_cons(site, c))
                return new_tr, w
            trs, ws = jax.vmap(score)(site.support)
            j = jax.random.categorical(k_site, ws)
            trace = jax.tree_util.tree_map(lambda x: x[j], trs)
        else:
            v0 = _dense_value(trace, site)

            def site_step(carry, xs, site=site):
                tr, v = carry
                i, kk = xs

                def score(c):
                    newv = v.at[i].set(c)
                    new_tr, w, _, _ = tr.update(None,
                                                _build_cons(site, newv))
                    return new_tr, w, newv

                trs, ws, newvs = jax.vmap(score)(site.support)
                j = jax.random.categorical(kk, ws)
                pick = jax.tree_util.tree_map(lambda x: x[j], trs)
                return (pick, newvs[j]), None

            ks = jax.random.split(k_site, site.length)
            (trace, _), _ = jax.lax.scan(
                site_step, (trace, v0),
                (jnp.arange(site.length), ks))
    return trace


def model_evals_per_sweep(sites: Tuple[DiscreteSite, ...]) -> int:
    """Full-model ``update`` evaluations one Gibbs sweep costs (the
    discrete-sweep cost surfaced in ``info``)."""
    return sum(s.length * s.n_candidates for s in sites)


def mixed_warmup_and_sample(key, trace, cont_sel: Selection,
                            sites: Tuple[DiscreteSite, ...],
                            num_warmup=500, num_samples=1000, max_depth=8,
                            target_accept=0.8, adapt_mass=True):
    """Single-chain alternating (NUTS ∘ Gibbs) pipeline: dual-averaging
    warmup with the discrete sweep interleaved (the adaptation sees the
    true mixed chain), then sampling. Returns
    ``(cont_samples (S, d), disc_samples tuple per site, final_trace,
    info)``. Entirely scanned/jitted; vmap over (key, trace) for chains.
    """
    target0 = FlatTarget(trace, cont_sel)
    dim = target0.dim
    k_find, k_warm, k_samp = jax.random.split(key, 3)
    eps0 = find_reasonable_step_size(k_find, target0.value_and_grad,
                                     target0.flat0)

    def cont_step(k, tr, eps, inv_mass):
        t = FlatTarget(tr, cont_sel)
        theta, stats = nuts_flat(k, t.value_and_grad, t.flat0, eps,
                                 max_depth, inv_mass)
        return t.rebuild(theta), theta, stats

    def warm_step(carry, step_key):
        tr, da, mean, m2, count = carry
        k_c, k_d = jax.random.split(step_key)
        tr, theta, stats = cont_step(k_c, tr, jnp.exp(da.log_eps), None)
        da = da_update(da, stats.accept_prob, target_accept)
        tr = gibbs_sweep(k_d, tr, sites)
        active = da.t > (num_warmup // 2)
        count2 = count + jnp.where(active, 1.0, 0.0)
        delta = theta - mean
        mean2 = mean + jnp.where(active,
                                 delta / jnp.maximum(count2, 1.0), 0.0)
        m22 = m2 + jnp.where(active, delta * (theta - mean2), 0.0)
        return (tr, da, mean2, m22, count2), stats.accept_prob

    init = (trace, da_init(eps0), jnp.zeros(dim), jnp.zeros(dim),
            jnp.asarray(0.0))
    (trace, da, mean, m2, count), _ = jax.lax.scan(
        warm_step, init, jax.random.split(k_warm, num_warmup))
    eps_final = jnp.exp(da.log_eps_bar)
    var = m2 / jnp.maximum(count - 1.0, 1.0)
    inv_mass = jnp.where(jnp.asarray(adapt_mass) & (count > 2),
                         jnp.maximum(var, 1e-6), jnp.ones(dim))

    def samp_step(tr, step_key):
        k_c, k_d = jax.random.split(step_key)
        tr, theta, stats = cont_step(k_c, tr, eps_final, inv_mass)
        tr = gibbs_sweep(k_d, tr, sites)
        discs = tuple(_dense_value(tr, s) for s in sites)
        return tr, (theta, discs, stats.accept_prob, stats.num_leapfrogs)

    trace, (cont_samples, disc_samples, accepts, leapfrogs) = jax.lax.scan(
        samp_step, trace, jax.random.split(k_samp, num_samples))
    info = dict(step_size=eps_final, inv_mass_diag=inv_mass,
                mean_accept=jnp.mean(accepts),
                total_leapfrogs=jnp.sum(leapfrogs))
    return cont_samples, disc_samples, trace, info


# -- fused mixed driver (round-5 stretch of VERDICT r4 item 1) ---------------
# The XLA alternating driver above is fully generic; THIS path runs the
# continuous block in many-chain pair-scheduled FSM-NUTS
# (ops/nuts_fused.py), with each chain's CURRENT discrete values riding in
# the chain state as frozen coordinates (inverse mass 0 — the
# Gibbs-within-NUTS conditioning mechanism, validated vs exact
# enumeration in tests/test_nuts_fused.py). Between chunks the discrete block is
# refreshed by the exact enumerative Gibbs sweep (vmapped over chains on
# rebuilt traces). Requires the EXTENDED flat universe's assess-logp to
# stage through ops.scalarize with the discrete values as (cast) float
# coordinates — bernoulli indicators via where()/xlogy stage; categorical
# probs[z] gathers do not (those models use the XLA driver).

def extended_layout(one_trace, observations):
    """(selection over ALL unobserved addresses, free_mask (d,) with 0 on
    discrete coords, cont_idx, disc flag) for the extended flat universe."""
    import math
    from ..selection import select
    obs_addrs = set(observations.addresses())
    paths = [p for p, _ in one_trace.get_choices().leaf_items()
             if p not in obs_addrs]
    if not paths:
        raise ValueError("no unobserved addresses")
    sel = select(*paths)
    items = list(one_trace.get_choices().filter(sel).leaf_items())
    mask_parts = []
    for path, v in items:
        size = max(1, math.prod(jnp.shape(v)))
        cont = jnp.issubdtype(jnp.asarray(v).dtype, jnp.inexact)
        mask_parts.append(jnp.full((size,), 1.0 if cont else 0.0,
                                   jnp.float32))
    mask = jnp.concatenate(mask_parts)
    return sel, mask


def mixed_fused_sample(key, traces, one_trace, sites, *, num_warmup=400,
                       num_samples=1000, max_depth=8, target_accept=0.8,
                       observations=None, num_outer=None,
                       warmup_gibbs_segments=3, chunk_ticks=16):
    """Alternating (fused pair-NUTS ∘ exact Gibbs) over the extended flat
    universe. Returns ``(draws (m, chains, d_ext), layout_sel, free_mask,
    info)`` — the extracted completed-trajectory draws INCLUDE the frozen
    discrete coordinates (each chunk's rows carry that chunk's per-chain
    discrete values), so discrete marginals fall out of the same array.
    """
    from .chees import chees_hmc_warmup_and_sample
    from .target import FlatTarget
    from ..ops.nuts_fused import (extract_completed_draws,
                                  nuts_chains_fused_chunked)

    sel_ext, free_mask = extended_layout(one_trace, observations)
    target = FlatTarget(one_trace, sel_ext)
    n_chains = jax.tree_util.tree_leaves(traces)[0].shape[0]

    @jax.jit
    def gibbs_refresh(k, flat):
        def one(kk, f):
            tr = target.rebuild(f)
            tr = gibbs_sweep(kk, tr, sites)
            return tr.get_choices().filter(sel_ext).to_array()
        ks = jax.random.split(k, n_chains)
        return jax.vmap(one)(ks, flat)

    @jax.jit
    def rebuild_all(flat):
        return jax.vmap(target.rebuild)(flat)

    # warmup: ChEES segments (discretes frozen per chain) interleaved
    # with Gibbs refreshes, so the adaptation sees discrete mixing
    k_w, k_s = jax.random.split(key)
    cur_traces = traces
    seg = max(50, num_warmup // warmup_gibbs_segments)
    winfo = None
    for i in range(warmup_gibbs_segments):
        k_w, k_c, k_g = jax.random.split(k_w, 3)
        _, warm_flat, winfo = jax.jit(
            lambda trs, k: chees_hmc_warmup_and_sample(
                k, trs, sel_ext, num_warmup=seg, num_samples=1,
                target_accept=target_accept,
                free_mask=free_mask))(cur_traces, k_c)
        warm_flat = gibbs_refresh(k_g, warm_flat)
        if i < warmup_gibbs_segments - 1:
            cur_traces = rebuild_all(warm_flat)
    eps = float(winfo["step_size"])

    # sampling: fused pair-NUTS chunks with Gibbs refreshes between.
    # ALTERNATION FREQUENCY MATTERS: for strongly coupled (continuous,
    # discrete) blocks — the GMM's (means, assignments) — the joint chain
    # mixes at the rate of the SLOWER alternation, so the discrete
    # refresh runs every ~chunk_ticks leapfrog slots (~2-5 trajectories),
    # not a handful of times per run (measured: 8 refreshes left the GMM
    # stuck near the symmetric collapsed configuration; per-16-tick
    # refreshes match exact enumeration).
    ticks_total = 8 * num_samples
    if num_outer is None:
        num_outer = max(4, ticks_total // chunk_ticks)
    chunk = max(8, ticks_total // num_outer)
    flat = warm_flat
    # fused alternating BURN phase: the ChEES warmup alternates with
    # Gibbs only at its few segment boundaries, so chains enter sampling
    # still drifting in the joint (continuous, discrete) space — half a
    # sampling budget of uncollected per-chunk alternation finishes the
    # job at full speed (measured on the GMM: without it the
    # cross-chain variance ran ~50% high)
    n_burn_outer = max(2, (ticks_total // 2) // chunk)
    for j in range(n_burn_outer):
        k_s, k_n, k_g = jax.random.split(k_s, 3)
        flat, hist, hcnt, cnt, _stats = nuts_chains_fused_chunked(
            k_n, target.logp, flat, num_ticks=chunk, eps=eps,
            max_depth=max_depth, inv_mass_diag=winfo["inv_mass"],
            collect_idx=0)
        del hist, hcnt
        flat = gibbs_refresh(k_g, flat)
    draws_chunks = []
    counts_total = 0
    for j in range(num_outer):
        k_s, k_n, k_g = jax.random.split(k_s, 3)
        flat, hist, hcnt, cnt, stats = nuts_chains_fused_chunked(
            k_n, target.logp, flat, num_ticks=chunk, eps=eps,
            max_depth=max_depth, inv_mass_diag=winfo["inv_mass"],
            collect_idx=None)
        m = int(jnp.min(cnt))
        if m >= 1:
            draws_chunks.append(extract_completed_draws(hist, hcnt, m))
            counts_total += m
        del hist, hcnt
        flat = gibbs_refresh(k_g, flat)
    if counts_total < 2:
        raise ValueError(
            "fused mixed driver completed too few trajectories; raise "
            "num_samples (the tick budget is 8*num_samples)")
    draws = jnp.concatenate(draws_chunks, axis=0)
    info = dict(step_size=eps, inv_mass=winfo["inv_mass"],
                mean_depth=stats["mean_depth"],
                num_divergent=stats["num_divergent"])
    return draws, sel_ext, free_mask, info
