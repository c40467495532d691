"""Distributed genealogy SMC: particles sharded over a device mesh with
explicit collectives for resampling.

The reference has no distributed runtime (SURVEY.md §5.8); this is the
Design for SURVEY.md §7.3 hard-part #3 ("distributed resampling
that is deterministic and cheap over the interconnect"). The key observation is the one
behind :func:`gen_tpu.inference.smc.smc_genealogy`: resampling only needs to
permute the O(N · state_dim) carried state plus an ancestry row — per-step
kernel traces stay PUT on the device that produced them, and coherent
trajectories are reconstructed once at the end from the ancestry.

Collective pattern per step (all riding the interconnect, nothing touches the host):

1. weight normalization — ``pmax`` + ``psum`` logsumexp over the particle
   axis (the sharded analogue of inference/inference.jl:3-13),
2. ESS — one more ``psum`` (particle_filter.jl:3-6),
3. parent selection — ``all_gather`` of the (N,) normalized log weights
   (4N bytes — negligible next to state), after which every device computes
   the SAME global systematic-resampling parent vector from a shared
   uniform; no scatter, deterministic across devices by construction,
4. state exchange — ``all_gather`` of the carried state (N · state_dim),
   then each device takes the slice its new parents name. The per-step
   traffic is independent of both trace size and history length.

Weight/log-ML bookkeeping is identical to the single-chip
``smc_genealogy``; a 1-device mesh reproduces it exactly.

``exchange="ring"`` replaces the all_gather state exchange with
**island-local resampling + a static half-block ring rotation**:

* each device resamples its own n_local particles from its own normalized
  weights (no weight gather at all — only the scalar psum/pmax for ESS and
  log-ML survive), with offspring assigned the island-average weight so
  every island's total weight is preserved (stratified resampling is
  unbiased stratum-wise; this is the island particle filter of Vergé et
  al. 2015 / an αSMC interaction in the sense of Whiteley-Lee-Heine 2016);
* every step, the upper half-block of (state, weight, ancestry-pointer)
  triples rotates one device along the ring via a single static
  ``ppermute``. A deterministic permutation of the global particle system
  is measure-preserving — states, weights and genealogy pointers move
  together — so this mixing is free of any dynamic routing and keeps
  island weights from drifting apart.

Per-step interconnect traffic: all_gather mode moves (n_dev-1)/n_dev · N ·
state_dim elements onto every device plus the (N,) weight gather; ring
mode moves n_local/2 · state_dim point-to-point and nothing else. The
price is locally-stratified (slightly higher-variance) resampling;
the HMM forward-algorithm test bounds the effect.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..combinators.vector import VectorChoiceMap
from ..gfi import GenerativeFunction


def _global_logsumexp(x_local, axis: str):
    """logsumexp over a sharded axis: pmax for the shift, psum for the sum."""
    m = jax.lax.pmax(jnp.max(x_local), axis)
    s = jax.lax.psum(jnp.sum(jnp.exp(x_local - m)), axis)
    return m + jnp.log(s)


def sharded_smc_genealogy(key, kernel: GenerativeFunction, init_state,
                          params: Tuple, observations: VectorChoiceMap,
                          num_particles: int, mesh: Mesh,
                          axis: str = "particles",
                          ess_threshold: Optional[float] = None,
                          exchange: str = "all_gather"):
    """Particle-sharded genealogy particle filter over an Unfold-style
    kernel ``(t, state, *params) -> state``.

    ``exchange``: ``"all_gather"`` (exact global systematic resampling,
    O(N·state_dim) gather traffic) or ``"ring"`` (island-local resampling
    + static half-block ring rotation, O(n_local/2·state_dim) neighbor
    traffic — see module docstring).

    Returns ``(subtraces, ancestry, log_weights, log_ml_estimate)`` with the
    same meaning as :func:`gen_tpu.inference.smc.smc_genealogy` — subtraces
    time-major (T, N, ...) sharded over particles, ancestry (T, N) holding
    GLOBAL parent indices, log_weights (N,).
    """
    if exchange not in ("all_gather", "ring"):
        raise ValueError(f"unknown exchange mode {exchange!r}")
    n_dev = mesh.shape[axis]
    if num_particles % n_dev != 0:
        raise ValueError(
            f"num_particles={num_particles} must divide over the "
            f"{n_dev}-device '{axis}' mesh axis")
    n = num_particles
    n_local = n // n_dev
    T = observations.length
    if ess_threshold is None:
        ess_threshold = n / 2
    obs_inner = observations.inner

    def run(key, obs_inner):
        dev = jax.lax.axis_index(axis)
        base = dev * n_local
        local_ids = base + jnp.arange(n_local)
        k_init, k_scan = jax.random.split(key)

        def step(carry, inp):
            states, log_w, log_ml = carry
            t, k = inp
            k_res, k_ext = jax.random.split(k)

            # 1-2. global normalization + ESS (psum/pmax collectives)
            log_total = _global_logsumexp(log_w, axis)
            lnw = log_w - log_total
            ess = 1.0 / jax.lax.psum(jnp.sum(jnp.exp(2.0 * lnw)), axis)
            do = (ess < ess_threshold) & (t > 0)

            from ..ops.resample import systematic_resample
            if exchange == "all_gather":
                # 3. parents: gather the (N,) weights, every device computes
                #    the same global systematic parent vector (shared u ⇒
                #    identical)
                lnw_g = jax.lax.all_gather(lnw, axis, tiled=True)
                u = jax.random.uniform(k_res)
                parents_g = systematic_resample(lnw_g, u)
                parents_g = jnp.where(do, parents_g, jnp.arange(n))
                parents_local = jax.lax.dynamic_slice(parents_g, (base,),
                                                      (n_local,))

                # 4. state exchange: gather carried state, slice by parents
                states = jax.tree_util.tree_map(
                    lambda x: jax.lax.all_gather(x, axis,
                                                 tiled=True)[parents_local],
                    states)
                log_w = jnp.where(do, jnp.zeros(n_local), log_w)
                log_ml = jnp.where(do, log_ml + log_total - jnp.log(n),
                                   log_ml)
            else:
                # "ring": island-local resampling — parents drawn from the
                # LOCAL normalized weights with a per-island u; offspring
                # carry the island-average weight so each island's share of
                # the global weight is exactly preserved (unbiased
                # stratum-wise)
                w_local = jax.scipy.special.logsumexp(log_w)
                u = jax.random.uniform(jax.random.fold_in(k_res, dev))
                parents_idx = systematic_resample(log_w - w_local, u)
                parents_idx = jnp.where(do, parents_idx,
                                        jnp.arange(n_local))
                states = jax.tree_util.tree_map(lambda x: x[parents_idx],
                                                states)
                island_w = w_local - log_total + jnp.log(float(n_dev))
                log_w = jnp.where(do, jnp.full(n_local, island_w), log_w)
                log_ml = jnp.where(do, log_ml + log_total - jnp.log(n),
                                   log_ml)
                parents_local = base + parents_idx

                # static half-block ring rotation: a deterministic global
                # permutation of (state, weight, ancestry-pointer) triples —
                # measure-preserving, mixes islands with one ppermute
                half = n_local // 2
                if n_dev > 1 and half > 0:
                    perm = [(i, (i + 1) % n_dev) for i in range(n_dev)]

                    def rotate(x):
                        recv = jax.lax.ppermute(x[half:], axis, perm)
                        return jnp.concatenate([x[:half], recv], axis=0)

                    states = jax.tree_util.tree_map(rotate, states)
                    log_w = rotate(log_w)
                    parents_local = rotate(parents_local)

            obs_t = jax.tree_util.tree_map(
                lambda x: jax.lax.dynamic_index_in_dim(x, t, keepdims=False),
                obs_inner)
            ks = jax.vmap(jax.random.fold_in, in_axes=(None, 0))(
                k_ext, local_ids)
            subs, ws = jax.vmap(
                lambda kk, s: kernel.generate(kk, (t, s) + tuple(params),
                                              obs_t))(ks, states)
            return ((subs.get_retval(), log_w + ws, log_ml),
                    (subs, parents_local))

        # the carried state varies per device; mark the (replicated-valued)
        # initial carry as varying over the particle axis so scan types check
        varying = lambda x: jax.lax.pcast(x, (axis,), to="varying")
        init_states = jax.tree_util.tree_map(
            lambda x: varying(jnp.broadcast_to(
                jnp.asarray(x), (n_local,) + jnp.shape(jnp.asarray(x)))),
            init_state)
        ts = jnp.arange(T)
        keys = jax.random.split(k_scan, T)
        (states, log_w, log_ml), (subtraces, ancestry) = jax.lax.scan(
            step, (init_states, varying(jnp.zeros(n_local)),
                   jnp.asarray(0.0)),
            (ts, keys))
        final_lml = log_ml + _global_logsumexp(log_w, axis) - jnp.log(n)
        return subtraces, ancestry, log_w, final_lml

    shard = jax.shard_map(
        run, mesh=mesh,
        in_specs=(P(), P()),
        out_specs=(P(None, axis), P(None, axis), P(axis), P()))
    return jax.jit(shard)(key, obs_inner)


def sharded_smc_sampler(key, trace, selection, betas, n_particles: int,
                        mesh: Mesh, axis: str = "particles",
                        L: int = 10, eps: float = 0.1,
                        moves_per_rung: int = 1,
                        ess_threshold: Optional[float] = None):
    """Particle-sharded tempered SMC (the distributed form of
    :func:`gen_tpu.inference.tempering.smc_sampler`).

    Latent flats are (dim,) vectors, so the resampling exchange is cheap:
    per rung, one scalar psum/pmax pair for the global weight
    normalization + ESS, and (only when ESS triggers) an all_gather of the
    (N,) weights and the (N, dim) flats followed by the shared-u global
    systematic parent slice. Tempered-HMC moves are embarrassingly local.

    Returns ``(flats, log_w, log_ml)`` — flats (N, dim) sharded over the
    particle axis.
    """
    from ..inference.tempering import (TemperedTarget, _init_particles,
                                       _tempered_hmc_step)
    from ..ops.resample import systematic_resample

    n_dev = mesh.shape[axis]
    n = n_particles
    if n % n_dev != 0:
        raise ValueError(f"num_particles={n} must divide over the "
                         f"{n_dev}-device '{axis}' mesh axis")
    n_local = n // n_dev
    if ess_threshold is None:
        ess_threshold = n / 2
    betas = jnp.asarray(betas)
    beta_prevs = jnp.concatenate([jnp.zeros(1, betas.dtype), betas[:-1]])
    target = TemperedTarget(trace, selection)

    def run(key):
        dev = jax.lax.axis_index(axis)
        base = dev * n_local
        k_init, k_scan = jax.random.split(jax.random.fold_in(key, dev))
        k_scan = jax.random.split(key)[1]  # rung keys shared across devices
        # flats are already device-varying (per-device init key); the
        # zero-initialized weights are replicated-valued and need the cast
        flats, _ = _init_particles(k_init, trace, selection, n_local)
        varying = lambda x: jax.lax.pcast(x, (axis,), to="varying")

        def rung(carry, inp):
            flats, log_w, log_ml = carry
            beta, beta_prev, k = inp
            k_res, k_mov = jax.random.split(k)

            lik = jax.vmap(lambda f: target.prior_lik(f)[1])(flats)
            log_w = log_w + (beta - beta_prev) * lik

            log_total = _global_logsumexp(log_w, axis)
            lnw = log_w - log_total
            ess = 1.0 / jax.lax.psum(jnp.sum(jnp.exp(2.0 * lnw)), axis)
            do = ess < ess_threshold

            lnw_g = jax.lax.all_gather(lnw, axis, tiled=True)
            flats_g = jax.lax.all_gather(flats, axis, tiled=True)
            u = jax.random.uniform(k_res)
            parents_g = systematic_resample(lnw_g, u)
            parents_local = jax.lax.dynamic_slice(parents_g, (base,),
                                                  (n_local,))
            flats = jnp.where(do, flats_g[parents_local], flats)
            log_w = jnp.where(do, jnp.zeros(n_local), log_w)
            log_ml = jnp.where(do, log_ml + log_total - jnp.log(n), log_ml)

            def one_move(f, kk):
                new, _ = _tempered_hmc_step(kk, f, target, beta, L, eps)
                return new

            def sweep(i, fl):
                ks = jax.vmap(jax.random.fold_in, in_axes=(None, 0))(
                    jax.random.fold_in(k_mov, i), base + jnp.arange(n_local))
                return jax.vmap(one_move)(fl, ks)

            flats = jax.lax.fori_loop(0, moves_per_rung, sweep, flats)
            return (flats, log_w, log_ml), None

        keys = jax.random.split(k_scan, betas.shape[0])
        (flats, log_w, log_ml), _ = jax.lax.scan(
            rung, (flats, varying(jnp.zeros(n_local)), jnp.asarray(0.0)),
            (betas, beta_prevs, keys))
        log_ml = log_ml + _global_logsumexp(log_w, axis) - jnp.log(n)
        return flats, log_w, log_ml

    shard = jax.shard_map(run, mesh=mesh, in_specs=(P(),),
                          out_specs=(P(axis), P(axis), P()))
    return jax.jit(shard)(key)
