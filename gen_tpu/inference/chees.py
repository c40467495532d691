"""ChEES-HMC: cross-chain adaptive Hamiltonian Monte Carlo.

Not in the reference. NUTS adapts per-chain trajectory lengths with
data-dependent while_loops, which run in lockstep under ``vmap`` (every
chain waits for the deepest tree). ChEES (Hoffman, Radul & Sountsov 2021,
"An Adaptive MCMC Scheme for Setting Trajectory Lengths in Hamiltonian
Monte Carlo") instead adapts ONE shared trajectory length from cross-chain
statistics — the Change in the Estimator of the Expected Square criterion —
with a uniform jitter per iteration. Every chain runs the same number of
leapfrog steps, so the many-chain program is perfectly shaped for
vmap and accelerators: this is the modern accelerator-native alternative to NUTS.

Per iteration (all chains lockstep):
  1. jitter: L_m = max(1, round(u_m · T / eps)), u_m ~ U(0,1) (shared)
  2. vmapped leapfrog for L_m steps; per-chain MH accept
  3. dual-averaging on eps toward the target acceptance
  4. ChEES gradient ascent on log T:
       Δ_i = ||x'_i − x̄'||² − ||x_i − x̄||²   (cross-chain centering)
       ĝ ∝ Σ_i α_i · Δ_i · ⟨x'_i − x̄', v'_i⟩ · u_m / Σ_i α_i
     (α_i = accept prob, v' = end velocity), Adam on log T.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from ..selection import Selection
from ..utils import sqrt_mass_safe
from .nuts import DAState, da_init, da_update
from .target import FlatTarget


def _halton(i, base=2):
    """Scalar Halton sequence value (traced-index capable, 10 digits)."""
    f = 1.0
    r = 0.0
    x = i + 1
    for _ in range(10):
        f = f / base
        r = r + f * (x % base)
        x = x // base
    return r


class CheesState(NamedTuple):
    log_t: jnp.ndarray        # log total trajectory length
    adam_m: jnp.ndarray
    adam_v: jnp.ndarray
    step: jnp.ndarray


def chees_hmc_warmup_and_sample(key, traces, selection: Selection,
                                num_warmup: int = 300,
                                num_samples: int = 500,
                                target_accept: float = 0.75,
                                init_step_size: float = 0.1,
                                init_traj_length: float = 1.0,
                                adam_lr: float = 0.025,
                                adapt_mass: bool = True,
                                mass_ema_decay: Optional[float] = None,
                                free_mask=None):
    """Run ChEES-adapted HMC on a BATCH of traces (leading chain axis).

    Returns (samples (num_samples, chains, d), final_flat (chains, d),
    info dict with adapted step_size / trajectory_length / mean_accept /
    inv_mass). Everything is one jitted program.

    ``adapt_mass=True`` adapts a diagonal inverse mass (= posterior
    variance) CONTINUOUSLY during warmup, the ChEES/MEADS-paper scheme: an
    exponential moving average of the per-iteration CROSS-CHAIN variance
    of each coordinate (the many-chain estimator needs no per-chain
    history and per-iteration centering makes it immune to warmup drift),
    applied immediately so step size and trajectory length co-adapt in
    whitened time. The per-iteration estimator averages ``num_chains``
    samples, so the EWMA window auto-scales to keep ~128 effective samples
    behind the mass estimate (window = max(10, 128/num_chains) iterations;
    override with ``mass_ema_decay``) — with the engine minimum of 2 chains
    the decay is ~0.985, not the many-chain 0.9, so a 2-sample variance
    never dominates. The mass is eased in geometrically from identity
    (weight m/(m+10) on the log scale) so early unequilibrated iterations
    cannot wreck the metric. A Stan-style two-phase switch was measured
    WORSE here: phase A's trajectory length is adapted in raw time and is
    miscalibrated for phase B's whitened dynamics. The sampling phase and
    the returned ``info["inv_mass"]`` use the final mass; feed it to
    :func:`gen_tpu.ops.hmc_fused.hmc_chains_fused` as ``inv_mass_diag``."""
    example = jax.tree_util.tree_map(lambda x: x[0], traces)
    target = FlatTarget(example, selection)
    xs0 = jax.vmap(
        lambda tr: tr.get_choices().filter(selection).to_array())(traces)
    return chees_warmup_flat(
        key, target.value_and_grad, xs0, num_warmup=num_warmup,
        num_samples=num_samples, target_accept=target_accept,
        init_step_size=init_step_size, init_traj_length=init_traj_length,
        adam_lr=adam_lr, adapt_mass=adapt_mass,
        mass_ema_decay=mass_ema_decay, free_mask=free_mask)


def chees_warmup_flat(key, vag, xs0,
                      num_warmup: int = 300,
                      num_samples: int = 500,
                      target_accept: float = 0.75,
                      init_step_size: float = 0.1,
                      init_traj_length: float = 1.0,
                      adam_lr: float = 0.025,
                      adapt_mass: bool = True,
                      mass_ema_decay: Optional[float] = None,
                      free_mask=None):
    """Flat-coordinate core of :func:`chees_hmc_warmup_and_sample`:
    ``vag(x) -> (logp, grad)`` on a (d,) vector, ``xs0`` the (chains, d)
    initial population. This is the entry the dense-mass machinery uses to
    re-adapt the step size in WHITENED coordinates
    (:mod:`gen_tpu.inference.mass`).

    ``free_mask``: optional (d,) 0/1 array — zero entries are FROZEN
    coordinates (the adapted inverse mass is zeroed there, so they never
    move and their momentum draws are zero; carries per-chain conditioning
    values, see the fused engines' partial-selection support). Warmup-only
    stuck-chain teleport is disabled when a mask is given (teleporting
    would copy one chain's conditioning values onto another — each chain
    has its OWN target)."""
    n_chains, dim = xs0.shape
    logps0, grads0 = jax.vmap(vag)(xs0)

    mass_floor = jnp.asarray(1e-12, xs0.dtype)
    if mass_ema_decay is None:
        # keep ~128 cross-chain variance samples in the EWMA window
        mass_ema_decay = 1.0 - 1.0 / max(10.0, 128.0 / n_chains)
    ema_new = 1.0 - mass_ema_decay

    fmask = (None if free_mask is None
             else jnp.asarray(free_mask, xs0.dtype))

    def cur_inv_mass(ema, m):
        """Geometric ease-in from identity: exp(w log ema), w = m/(m+10)."""
        if not adapt_mass:
            base = jnp.ones(dim, xs0.dtype)
        else:
            w = m.astype(xs0.dtype) / (m.astype(xs0.dtype) + 10.0)
            base = jnp.exp(w * jnp.log(jnp.maximum(ema, mass_floor)))
        return base if fmask is None else base * fmask

    def warmup_iteration(carry, inp):
        """One ChEES warmup step under the current diagonal inverse mass
        (d,). Momenta p ~ N(0, M); kinetic = p'M^{-1}p/2; x += eps M^{-1}p;
        the ChEES statistic uses end VELOCITY v = M^{-1}p."""
        xs, logps, grads, da, chees, streak, ema = carry
        m, k = inp
        inv_mass = cur_inv_mass(ema, m)
        eps = jnp.exp(jnp.clip(da.log_eps, -20.0, 10.0))
        traj = jnp.exp(chees.log_t)
        u = _halton(m)
        # NaN-safe + capped: a diverged warmup iterate must never produce
        # n_leap=0 (identity proposals -> accept=1 -> runaway step size).
        ratio = jnp.nan_to_num(u * traj / eps, nan=1.0, posinf=1000.0)
        n_leap = jnp.round(jnp.clip(ratio, 1.0, 1000.0)).astype(jnp.int32)

        k_mom, k_acc, k_tel = jax.random.split(k, 3)
        mom_scale = sqrt_mass_safe(inv_mass)
        momenta = mom_scale * jax.random.normal(
            k_mom, (n_chains, dim), xs.dtype)

        def kin(p):
            return 0.5 * jnp.sum(inv_mass * p * p, axis=1)

        def leap_body(i, state):
            x, mom, g = state
            mom = mom + 0.5 * eps * g
            x = x + eps * inv_mass * mom
            lp, g = jax.vmap(vag)(x)
            mom = mom + 0.5 * eps * g
            return (x, mom, g)

        x_new, mom_new, g_new = jax.lax.fori_loop(
            0, n_leap, leap_body, (xs, momenta, grads))
        lp_new = jax.vmap(lambda x: vag(x)[0])(x_new)

        finite = (jnp.isfinite(lp_new)
                  & jnp.all(jnp.isfinite(x_new), axis=1)
                  & jnp.all(jnp.isfinite(mom_new), axis=1))
        log_alpha = lp_new - logps - kin(mom_new) + kin(momenta)
        log_alpha = jnp.where(finite & ~jnp.isnan(log_alpha),
                              log_alpha, -jnp.inf)
        alpha = jnp.minimum(1.0, jnp.exp(log_alpha))
        accept = (jnp.log(jax.random.uniform(k_acc, (n_chains,)))
                  < log_alpha)

        xs_out = jnp.where(accept[:, None], x_new, xs)
        logps_out = jnp.where(accept, lp_new, logps)
        grads_out = jnp.where(accept[:, None], g_new, grads)

        # dual averaging on eps
        da = da_update(da, jnp.mean(alpha), target_accept)

        # ChEES gradient on log T.  Diverged chains (non-finite ends) are
        # replaced by their start points so cross-chain means stay finite;
        # their alpha is 0 so they contribute nothing — without this mask
        # 0 * NaN = NaN poisons ghat and the whole adaptation.
        x_stat = jnp.where(finite[:, None], x_new, xs)
        mom_stat = jnp.where(finite[:, None], mom_new, 0.0)
        xbar = jnp.mean(xs, axis=0)
        xbar_new = jnp.mean(x_stat, axis=0)
        d_old = jnp.sum((xs - xbar) ** 2, axis=1)
        d_new = jnp.sum((x_stat - xbar_new) ** 2, axis=1)
        delta = d_new - d_old
        # end VELOCITY, not momentum: v = M^{-1} p
        dot = jnp.sum((x_stat - xbar_new) * (inv_mass * mom_stat), axis=1)
        per_chain = delta * dot * u
        ghat = (jnp.sum(alpha * per_chain)
                / jnp.maximum(jnp.sum(alpha), 1e-6))
        ghat = jnp.nan_to_num(ghat)

        # Warmup-only teleport: a chain initialized in a region whose
        # curvature exceeds the adapted step size rejects forever (classic
        # fixed-eps HMC failure).  After 10 consecutive rejections, jump it
        # to a uniformly random other chain's position.  Warmup need not
        # preserve the target; the sampling phase below is pure MH.
        streak = jnp.where(accept, 0, streak + 1)
        if fmask is None:
            stuck = streak >= 10
            idx = jax.random.randint(k_tel, (n_chains,), 0, n_chains)
            xs_out = jnp.where(stuck[:, None], xs_out[idx], xs_out)
            logps_out = jnp.where(stuck, logps_out[idx], logps_out)
            grads_out = jnp.where(stuck[:, None], grads_out[idx], grads_out)
            streak = jnp.where(stuck, 0, streak)
        # normalized-gradient Adam ascent on log T
        g_norm = ghat / (jnp.abs(ghat) + 1e-12) * jnp.minimum(
            jnp.abs(ghat), 1e3)
        am = 0.9 * chees.adam_m + 0.1 * g_norm
        av = 0.999 * chees.adam_v + 0.001 * g_norm ** 2
        t = chees.step
        mhat = am / (1 - 0.9 ** t)
        vhat = av / (1 - 0.999 ** t)
        log_t = chees.log_t + adam_lr * mhat / (jnp.sqrt(vhat) + 1e-8)
        # keep trajectories sane: between eps and 1000*eps
        log_t = jnp.clip(log_t, da.log_eps, da.log_eps + jnp.log(1000.0))
        chees = CheesState(log_t, am, av, t + 1)

        # mass EWMA: per-iteration cross-chain variance (post-teleport)
        xb = jnp.mean(xs_out, axis=0)
        var_m = jnp.nan_to_num(jnp.mean((xs_out - xb) ** 2, axis=0))
        ema = mass_ema_decay * ema + ema_new * var_m
        return (xs_out, logps_out, grads_out, da, chees, streak, ema), None

    def sample_iteration(inv_mass, carry, inp):
        (xs, logps, grads, eps, n_leap), k = carry, inp
        k_mom, k_acc = jax.random.split(k)
        mom_scale = sqrt_mass_safe(inv_mass)
        momenta = mom_scale * jax.random.normal(
            k_mom, (n_chains, dim), xs.dtype)

        def kin(p):
            return 0.5 * jnp.sum(inv_mass * p * p, axis=1)

        def leap_body(i, state):
            x, mom, g = state
            mom = mom + 0.5 * eps * g
            x = x + eps * inv_mass * mom
            lp, g = jax.vmap(vag)(x)
            mom = mom + 0.5 * eps * g
            return (x, mom, g)

        x_new, mom_new, g_new = jax.lax.fori_loop(
            0, n_leap, leap_body, (xs, momenta, grads))
        lp_new = jax.vmap(lambda x: vag(x)[0])(x_new)
        finite = (jnp.isfinite(lp_new)
                  & jnp.all(jnp.isfinite(x_new), axis=1))
        log_alpha = lp_new - logps - kin(mom_new) + kin(momenta)
        log_alpha = jnp.where(finite & ~jnp.isnan(log_alpha),
                              log_alpha, -jnp.inf)
        accept = (jnp.log(jax.random.uniform(k_acc, (n_chains,)))
                  < log_alpha)
        xs = jnp.where(accept[:, None], x_new, xs)
        logps = jnp.where(accept, lp_new, logps)
        grads = jnp.where(accept[:, None], g_new, grads)
        return (xs, logps, grads, eps, n_leap), (xs, accept)

    k_warm, k_samp = jax.random.split(key)
    da = da_init(init_step_size)
    chees = CheesState(jnp.log(jnp.asarray(init_traj_length)),
                       jnp.asarray(0.0), jnp.asarray(0.0), jnp.asarray(1.0))
    streak0 = jnp.zeros(n_chains, jnp.int32)
    # EWMA seed: the initial cross-chain variance (prior spread)
    ema0 = jnp.maximum(jnp.var(xs0, axis=0), mass_floor)

    (xs, logps, grads, da, chees, _, ema), _ = jax.lax.scan(
        warmup_iteration,
        (xs0, logps0, grads0, da, chees, streak0, ema0),
        (jnp.arange(num_warmup), jax.random.split(k_warm, num_warmup)))
    inv_mass = cur_inv_mass(ema, jnp.asarray(num_warmup))

    eps_final = jnp.exp(jnp.clip(da.log_eps_bar, -20.0, 10.0))
    traj_final = jnp.exp(chees.log_t)
    ratio_final = jnp.nan_to_num(0.7 * traj_final / eps_final,
                                 nan=1.0, posinf=1000.0)
    n_leap_final = jnp.round(
        jnp.clip(ratio_final, 1.0, 1000.0)).astype(jnp.int32)

    (xs, logps, grads, _, _), (samples, accepts) = jax.lax.scan(
        functools.partial(sample_iteration, inv_mass),
        (xs, logps, grads, eps_final, n_leap_final),
        jax.random.split(k_samp, num_samples))
    info = dict(step_size=eps_final, trajectory_length=traj_final,
                num_leapfrogs=n_leap_final,
                mean_accept=jnp.mean(accepts), inv_mass=inv_mass)
    return samples, xs, info

