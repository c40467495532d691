"""Finite-state-machine NUTS: no lockstep waste across vmapped chains.

`nuts_flat` (nuts.py) is the textbook iterative NUTS: a while_loop over
tree doublings around a while_loop over subtree leapfrogs. Under ``vmap``
each transition runs until the SLOWEST chain's trajectory terminates —
every other chain burns full leapfrog gradients as masked no-ops, and
across a scan of transitions the expected waste is
E[max_chains(len)] / E[len], which grows with the chain count (measured:
NUTS ESS/sec *dropped* from 769k at 4k chains to 507k at 32k,
benchmarks/RESULTS.md). The fix (cf. "Efficiently Vectorized MCMC on
Modern Accelerators", arXiv:2503.17405): flatten the sampler into a state
machine stepped by a global leapfrog "tick". Every chain does exactly one
real leapfrog per tick; bookkeeping (subtree U-turn checkpoints, tree
merging, trajectory completion, momentum refresh) happens branchlessly in
the margins. A chain that finishes its trajectory *emits a sample and
starts the next trajectory on the next tick* — zero idle gradients, and
wall-clock per sample tracks the MEAN trajectory length instead of the
max.

Semantics are the same iterative multinomial NUTS as nuts_flat
(progressive within-subtree sampling, biased tree/subtree sampling,
power-of-two checkpoint U-turn scheme, divergence threshold); only the
scheduling differs. Samples land in a fixed ring of ``num_sample_slots``
per chain via one-hot masked writes (dynamic_update_slice under vmap
lowers to per-element scatters — the 84x trap in CLAUDE.md).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from .nuts import _uturn
from ..utils import sqrt_mass_safe


class FSMResult(NamedTuple):
    slots: jnp.ndarray        # (num_sample_slots, dim) FIRST samples, in
                              # order (writes stop once the buffer fills)
    counts: jnp.ndarray       # () int32 — completed trajectories
    theta: jnp.ndarray        # final current sample
    mean_accept: jnp.ndarray  # mean accept-stat over completed trajectories
    mean_depth: jnp.ndarray
    num_divergent: jnp.ndarray
    pos_mean: jnp.ndarray     # (dim,) mean of per-tick leapfrog positions
    pos_var: jnp.ndarray      # (dim,) variance of per-tick positions


def nuts_fsm(key, value_and_grad, theta0, step_size, num_ticks: int,
             max_depth: int = 10, inv_mass_diag=None,
             num_sample_slots: int = 256,
             divergence_threshold: float = 1000.0,
             injected_rng=None, collect_idx=None) -> FSMResult:
    """Run ``num_ticks`` global leapfrog ticks of FSM-NUTS from ``theta0``.

    One chain; ``vmap`` over (key, theta0[, step_size, inv_mass_diag]) for
    many chains — that is the whole point. Returns the sample buffer (the
    first ``min(counts, num_sample_slots)`` slots are the trajectory-end
    samples in order; later samples are dropped, never wrapped), the final
    position, and stats.

    ``injected_rng``: optional ``(z (ticks, dim), u_dir0, u_take, u_bias,
    u_dir — each (ticks,))`` host-side randomness replacing the per-tick
    PRNG draws, for exact comparison with another implementation of the
    same tick semantics.
    ``collect_idx``: if set, additionally returns per-tick
    ``(cur_theta[collect_idx], completed_count)`` as a second output
    (two ``(ticks,)`` arrays — cheap static-index collection streams;
    the count stream marks trajectory-end ticks so
    each completed draw can be extracted exactly once). The string
    ``"all"`` collects the whole ``(ticks, dim)`` position history.
    """
    dim = theta0.shape[0]
    dt = theta0.dtype
    inv_mass = (jnp.ones(dim, dtype=dt) if inv_mass_diag is None
                else jnp.asarray(inv_mass_diag, dtype=dt))
    sqrt_mass = sqrt_mass_safe(inv_mass)
    eps = jnp.asarray(step_size, dtype=dt)
    B = num_sample_slots

    def vag(theta):
        # pin to the state dtype: model logps may promote (e.g. f64
        # constants under x64) and a mixed-dtype scan carry won't typecheck
        lp, g = value_and_grad(theta)
        return jnp.asarray(lp, dt), jnp.asarray(g, dt)

    logp0, grad0 = vag(theta0)

    def kinetic(r):
        return 0.5 * jnp.dot(r, inv_mass * r)

    # every state init is DERIVED from theta0 rather than a literal: under
    # shard_map, literal constants are "unvarying" over the manual axis
    # while the tick outputs vary, and the scan carry would not typecheck
    f0 = theta0[0] * 0
    i0 = f0.astype(jnp.int32)
    zeros = theta0 * 0
    state = dict(
        # chain level
        cur_theta=theta0, cur_logp=logp0, cur_grad=grad0,
        count=i0, slots=jnp.zeros((B, dim), dtype=dt) + f0,
        accept_sum=f0, depth_sum=f0, div_count=i0,
        pos_n=f0, pos_mean=zeros, pos_m2=zeros,
        fresh=(i0 == 0), key=key,
        # trajectory level
        energy0=f0,
        left_theta=theta0, left_r=zeros, left_grad=grad0,
        right_theta=theta0, right_r=zeros, right_grad=grad0,
        rho_tree=zeros, cand_theta=theta0, cand_logp=logp0, cand_grad=grad0,
        logw_tree=f0, depth=i0, alpha_sum=f0, nlf=i0,
        # subtree level
        dir_eps=f0 + eps, sub_n=i0, num_leaves=i0 + 1,
        pt_theta=theta0, pt_r=zeros, pt_grad=grad0,
        rho_sub=zeros, cand_sub=theta0, cand_sub_logp=logp0,
        cand_sub_grad=grad0, logw_sub=f0 - jnp.inf,
        r_ckpt=jnp.zeros((max_depth + 1, dim), dtype=dt) + f0,
        rsum_ckpt=jnp.zeros((max_depth + 1, dim), dtype=dt) + f0,
    )

    def sel(c, a, b):
        return jax.tree_util.tree_map(
            lambda x, y: jnp.where(c, x, y), a, b)

    def tick(s, xs):
        if injected_rng is None:
            key, k_mom, k_dir0, k_take, k_bias, k_dir = jax.random.split(
                s["key"], 6)
            z_t = jax.random.normal(k_mom, (dim,), dtype=dt)
            u_dir0 = jax.random.uniform(k_dir0, dtype=dt)
            u_take = jax.random.uniform(k_take, dtype=dt)
            u_bias = jax.random.uniform(k_bias, dtype=dt)
            u_dir = jax.random.uniform(k_dir, dtype=dt)
        else:
            key = s["key"]
            z_t, u_dir0, u_take, u_bias, u_dir = xs
        fresh = s["fresh"]

        # -- trajectory init (masked): momentum refresh at cur_theta ------
        r0 = sqrt_mass * z_t
        dir0 = jnp.where(u_dir0 < 0.5, eps, -eps)
        init = dict(
            energy0=s["cur_logp"] - kinetic(r0),
            left_theta=s["cur_theta"], left_r=r0, left_grad=s["cur_grad"],
            right_theta=s["cur_theta"], right_r=r0,
            right_grad=s["cur_grad"],
            rho_tree=r0, cand_theta=s["cur_theta"],
            cand_logp=s["cur_logp"], cand_grad=s["cur_grad"],
            logw_tree=f0, depth=jnp.int32(0), alpha_sum=f0,
            nlf=jnp.int32(0),
            dir_eps=dir0, sub_n=jnp.int32(0), num_leaves=jnp.int32(1),
            pt_theta=s["cur_theta"], pt_r=r0, pt_grad=s["cur_grad"],
            rho_sub=zeros, cand_sub=s["cur_theta"],
            cand_sub_logp=s["cur_logp"], cand_sub_grad=s["cur_grad"],
            logw_sub=-jnp.inf * jnp.ones((), dt),
        )
        for k_, v_ in init.items():
            s = dict(s, **{k_: sel(fresh, v_, s[k_])})

        n = s["sub_n"]
        # -- block-start rho checkpoints (level k when n % 2^k == 0) ------
        r_ck, rs_ck = s["r_ckpt"], s["rsum_ckpt"]
        for k in range(1, max_depth + 1):
            starts = (n % (2 ** k)) == 0
            rs_ck = rs_ck.at[k].set(jnp.where(starts,
                                              s["rho_sub"],
                                              rs_ck[k]))

        # -- ONE leapfrog (the only gradient work; never masked out) ------
        e = s["dir_eps"]
        r = s["pt_r"] + 0.5 * e * s["pt_grad"]
        theta = s["pt_theta"] + e * (inv_mass * r)
        logp, grad = vag(theta)
        r = r + 0.5 * e * grad

        # momentum checkpoint = the block's first IN-BLOCK state (post-
        # leapfrog) — the pre-block boundary momentum makes the stopping
        # rule direction-asymmetric and biases the sampler (see the
        # matching comment + measurement in nuts.py::build_subtree)
        for k in range(1, max_depth + 1):
            starts = (n % (2 ** k)) == 0
            r_ck = r_ck.at[k].set(jnp.where(starts, r, r_ck[k]))

        # Welford over every leapfrog position (dense scale statistics for
        # mass-matrix warmup — completed samples are too sparse when
        # trajectories are long)
        pos_n = s["pos_n"] + 1.0
        d_ = theta - s["pos_mean"]
        pos_mean = s["pos_mean"] + d_ / pos_n
        pos_m2 = s["pos_m2"] + d_ * (theta - pos_mean)

        delta = (logp - kinetic(r)) - s["energy0"]
        delta = jnp.where(jnp.isnan(delta), -jnp.inf, delta)
        diverging = delta < -divergence_threshold
        alpha_sum = s["alpha_sum"] + jnp.minimum(1.0, jnp.exp(delta))
        nlf = s["nlf"] + 1

        # progressive multinomial candidate within the subtree
        logw_sub = jnp.logaddexp(s["logw_sub"], delta)
        take = jnp.log(u_take) < delta - logw_sub
        cand_sub = jnp.where(take, theta, s["cand_sub"])
        cand_sub_logp = jnp.where(take, logp, s["cand_sub_logp"])
        cand_sub_grad = jnp.where(take, grad, s["cand_sub_grad"])
        rho_sub = s["rho_sub"] + r

        # block-end U-turn checks inside the subtree
        turning_sub = jnp.asarray(False)
        for k in range(1, max_depth + 1):
            ends = ((n + 1) % (2 ** k)) == 0
            block_rho = rho_sub - rs_ck[k]
            turning_sub = turning_sub | (
                ends & _uturn(block_rho, r_ck[k], r, inv_mass))

        sub_done = ((n + 1) >= s["num_leaves"]) | turning_sub | diverging

        # ---- subtree merge into the tree (masked by sub_done) -----------
        ok = ~turning_sub & ~diverging
        take_tree = (jnp.log(u_bias) < logw_sub - s["logw_tree"]) & ok
        cand_theta = jnp.where(sub_done & take_tree, cand_sub,
                               s["cand_theta"])
        cand_logp = jnp.where(sub_done & take_tree, cand_sub_logp,
                              s["cand_logp"])
        cand_grad = jnp.where(sub_done & take_tree, cand_sub_grad,
                              s["cand_grad"])
        logw_tree = jnp.where(sub_done & ok,
                              jnp.logaddexp(s["logw_tree"], logw_sub),
                              s["logw_tree"])

        went_right = s["dir_eps"] > 0
        upd_end = sub_done & ok
        right_theta = jnp.where(upd_end & went_right, theta,
                                s["right_theta"])
        right_r = jnp.where(upd_end & went_right, r, s["right_r"])
        right_grad = jnp.where(upd_end & went_right, grad, s["right_grad"])
        left_theta = jnp.where(upd_end & ~went_right, theta,
                               s["left_theta"])
        left_r = jnp.where(upd_end & ~went_right, r, s["left_r"])
        left_grad = jnp.where(upd_end & ~went_right, grad, s["left_grad"])
        rho_tree = jnp.where(upd_end, s["rho_tree"] + rho_sub,
                             s["rho_tree"])

        turning_tree = _uturn(rho_tree, left_r, right_r, inv_mass)
        traj_done = sub_done & (turning_sub | diverging
                                | (ok & turning_tree)
                                | (s["depth"] + 1 >= max_depth))

        # ---- next subtree (trajectory continues) ------------------------
        depth_next = s["depth"] + jnp.where(sub_done & ~traj_done, 1, 0)
        new_dir = jnp.where(u_dir < 0.5, eps, -eps)
        start_sub = sub_done & ~traj_done
        dir_eps = jnp.where(start_sub, new_dir, s["dir_eps"])
        go_right_next = dir_eps > 0
        pt_theta = jnp.where(
            start_sub, jnp.where(go_right_next, right_theta, left_theta),
            theta)
        pt_r = jnp.where(start_sub,
                         jnp.where(go_right_next, right_r, left_r), r)
        pt_grad = jnp.where(start_sub,
                            jnp.where(go_right_next, right_grad, left_grad),
                            grad)
        sub_n = jnp.where(sub_done, 0, n + 1)
        num_leaves = jnp.where(
            start_sub, jnp.left_shift(jnp.int32(1), depth_next),
            s["num_leaves"])
        rho_sub = jnp.where(start_sub, zeros, rho_sub)
        logw_sub = jnp.where(start_sub, -jnp.inf, logw_sub)

        # ---- trajectory finish: emit sample, schedule re-init -----------
        cur_theta = jnp.where(traj_done, cand_theta, s["cur_theta"])
        cur_logp = jnp.where(traj_done, cand_logp, s["cur_logp"])
        cur_grad = jnp.where(traj_done, cand_grad, s["cur_grad"])
        # prefix buffer, NOT a ring: writes stop at B samples. A wrapping
        # ring rotates each chain's sequence by counts % B, silently
        # corrupting downstream autocorrelation/R-hat computed on
        # slots[:m] (each chain rotated differently).
        slot = jnp.minimum(s["count"], B - 1)
        onehot = ((jnp.arange(B) == slot)[:, None] & traj_done
                  & (s["count"] < B))
        slots = jnp.where(onehot, cand_theta[None, :], s["slots"])
        count = s["count"] + jnp.where(traj_done, 1, 0)
        accept_sum = s["accept_sum"] + jnp.where(
            traj_done, alpha_sum / jnp.maximum(nlf, 1), 0.0)
        # nuts_flat counts every doubling incl. the terminating one
        depth_sum = s["depth_sum"] + jnp.where(
            traj_done, depth_next.astype(dt) + 1.0, 0.0)
        div_count = s["div_count"] + jnp.where(traj_done & diverging, 1, 0)

        new_s = dict(
            cur_theta=cur_theta, cur_logp=cur_logp, cur_grad=cur_grad,
            count=count, slots=slots, accept_sum=accept_sum,
            depth_sum=depth_sum, div_count=div_count,
            pos_n=pos_n, pos_mean=pos_mean, pos_m2=pos_m2,
            fresh=traj_done, key=key,
            energy0=s["energy0"],
            left_theta=left_theta, left_r=left_r, left_grad=left_grad,
            right_theta=right_theta, right_r=right_r,
            right_grad=right_grad,
            rho_tree=rho_tree, cand_theta=cand_theta, cand_logp=cand_logp,
            cand_grad=cand_grad, logw_tree=logw_tree, depth=depth_next,
            alpha_sum=alpha_sum, nlf=nlf,
            dir_eps=dir_eps, sub_n=sub_n, num_leaves=num_leaves,
            pt_theta=pt_theta, pt_r=pt_r, pt_grad=pt_grad,
            rho_sub=rho_sub, cand_sub=cand_sub,
            cand_sub_logp=cand_sub_logp, cand_sub_grad=cand_sub_grad,
            logw_sub=logw_sub, r_ckpt=r_ck, rsum_ckpt=rs_ck,
        )
        # (value, completed-count) per tick: the count stream marks which
        # ticks END a trajectory, so downstream can extract each completed
        # draw exactly once — the raw tick series is length-biased (a
        # sample is displayed for its successor trajectory's duration;
        # inspection paradox)
        if collect_idx is None:
            emit = None
        elif collect_idx == "all":
            emit = (cur_theta, count)
        else:
            emit = (cur_theta[collect_idx], count)
        return new_s, emit

    if injected_rng is None:
        out, ticks_hist = jax.lax.scan(tick, state, None, length=num_ticks)
    else:
        z_all, u_dir0_all, u_take_all, u_bias_all, u_dir_all = injected_rng
        out, ticks_hist = jax.lax.scan(
            tick, state,
            (jnp.asarray(z_all, dt), jnp.asarray(u_dir0_all, dt),
             jnp.asarray(u_take_all, dt), jnp.asarray(u_bias_all, dt),
             jnp.asarray(u_dir_all, dt)))
    cnt = jnp.maximum(out["count"], 1)
    # no completed trajectory (short runs / very long trajectories): report
    # the IN-FLIGHT trajectory's accept statistic instead of 0 — a 0 would
    # drive dual-averaging warmup into a shrinking-step death spiral
    inflight = out["alpha_sum"] / jnp.maximum(out["nlf"], 1)
    mean_accept = jnp.where(out["count"] > 0, out["accept_sum"] / cnt,
                            inflight)
    res = FSMResult(slots=out["slots"], counts=out["count"],
                    theta=out["cur_theta"],
                    mean_accept=mean_accept,
                    mean_depth=out["depth_sum"] / cnt,
                    num_divergent=out["div_count"],
                    pos_mean=out["pos_mean"],
                    pos_var=out["pos_m2"] / jnp.maximum(out["pos_n"] - 1,
                                                        1.0))
    if collect_idx is not None:
        return res, ticks_hist
    return res


def nuts_fsm_paired(key, value_and_grad, theta0, step_size,
                    num_pairs: int, max_depth: int = 10,
                    inv_mass_diag=None,
                    divergence_threshold: float = 1000.0,
                    injected_rng=None, collect_idx=0):
    """Pair-scheduled FSM-NUTS: TWO leapfrogs per tick, with subtree
    starts aligned to pair boundaries — the engine that
    :func:`gen_tpu.ops.nuts_fused.nuts_chains_fused` vmaps over chains.

    Why pairs: in the 1-leapfrog-per-tick FSM, the per-tick bookkeeping
    (power-of-two checkpoint writes, per-level U-turn ends-tests, merge
    logic) executes branchlessly EVERY tick and is about half of a
    tick's operations. But checkpoint writes can only matter at even in-subtree
    positions (``sub_n % 2^k == 0, k >= 1``) and ends-tests only at odd
    ones (``(sub_n+1) % 2^k == 0``) — so if every subtree START is
    aligned to a pair boundary, the first slot of a pair needs no
    ends-tests and the second no checkpoint writes, and the whole U-turn
    section runs once per TWO leapfrogs.

    Alignment invariant: ``sub_n`` is even at every pair start. A subtree
    can end at the first slot only as the 1-leapfrog first subtree of a
    trajectory or by divergence; such a chain merges immediately and
    IDLES the second slot (its next subtree, or next trajectory, starts
    at the next pair). Every multi-leapfrog subtree has even length, so
    it spans aligned pairs exactly. Cost of the idle slots: ~1.5
    leapfrog slots per trajectory (one after the first subtree, ~0.5 for
    completion parity) — a few percent at typical depths, bought back
    several times over by the halved bookkeeping.

    Per-trajectory SEMANTICS (tree building, progressive multinomial
    candidates, biased merging, checkpoint U-turn scheme incl. the
    in-block boundary-momentum fix, divergence handling) are IDENTICAL
    to :func:`nuts_fsm` — only the schedule differs, which changes
    per-chain tick accounting but not the invariant distribution
    (validated vs per-chain NUTS moments in tests/test_nuts_fused.py).

    ``injected_rng``: ``(z (pairs, dim), u_dir0, u_take1, u_bias1,
    u_dir1, u_take2, u_bias2, u_dir2 — each (pairs,))``. Returns
    ``(FSMResult-like, (hist, hist_cnt))`` with per-PAIR streams.
    """
    dim = theta0.shape[0]
    dt = theta0.dtype
    inv_mass = (jnp.ones(dim, dtype=dt) if inv_mass_diag is None
                else jnp.asarray(inv_mass_diag, dtype=dt))
    sqrt_mass = sqrt_mass_safe(inv_mass)
    eps = jnp.asarray(step_size, dtype=dt)
    thr = jnp.asarray(divergence_threshold, dt)

    def vag(theta):
        lp, g = value_and_grad(theta)
        return jnp.asarray(lp, dt), jnp.asarray(g, dt)

    logp0, grad0 = vag(theta0)

    def kinetic(r):
        return 0.5 * jnp.dot(r, inv_mass * r)

    f0 = theta0[0] * 0
    i0 = f0.astype(jnp.int32)
    zeros = theta0 * 0
    state = dict(
        cur_theta=theta0, cur_logp=logp0, cur_grad=grad0,
        count=i0, accept_sum=f0, depth_sum=f0, div_count=i0,
        fresh=(i0 == 0), key=key,
        energy0=f0,
        left_theta=theta0, left_r=zeros, left_grad=grad0,
        right_theta=theta0, right_r=zeros, right_grad=grad0,
        rho_tree=zeros, cand_theta=theta0, cand_logp=logp0,
        cand_grad=grad0,
        logw_tree=f0, depth=i0, alpha_sum=f0, nlf=i0,
        dir_eps=f0 + eps, sub_n=i0, num_leaves=i0 + 1,
        pt_theta=theta0, pt_r=zeros, pt_grad=grad0,
        rho_sub=zeros, cand_sub=theta0, cand_sub_logp=logp0,
        cand_sub_grad=grad0, logw_sub=f0 - jnp.inf,
        r_ckpt=jnp.zeros((max_depth + 1, dim), dtype=dt) + f0,
        rsum_ckpt=jnp.zeros((max_depth + 1, dim), dtype=dt) + f0,
    )

    def pair(s, xs):
        if injected_rng is None:
            key, *ks = jax.random.split(s["key"], 9)
            z_t = jax.random.normal(ks[0], (dim,), dtype=dt)
            (u_dir0, u_take1, u_bias1, u_dir1,
             u_take2, u_bias2, u_dir2) = [
                jax.random.uniform(k, dtype=dt) for k in ks[1:8]]
        else:
            key = s["key"]
            (z_t, u_dir0, u_take1, u_bias1, u_dir1,
             u_take2, u_bias2, u_dir2) = xs
        fresh = s["fresh"]

        # -- trajectory init (masked), as nuts_fsm ------------------------
        r0 = sqrt_mass * z_t
        dir0 = jnp.where(u_dir0 < 0.5, eps, -eps)
        init = dict(
            energy0=s["cur_logp"] - kinetic(r0),
            left_theta=s["cur_theta"], left_r=r0, left_grad=s["cur_grad"],
            right_theta=s["cur_theta"], right_r=r0,
            right_grad=s["cur_grad"],
            rho_tree=r0, cand_theta=s["cur_theta"],
            cand_logp=s["cur_logp"], cand_grad=s["cur_grad"],
            logw_tree=f0, depth=jnp.int32(0), alpha_sum=f0,
            nlf=jnp.int32(0),
            dir_eps=dir0, sub_n=jnp.int32(0), num_leaves=jnp.int32(1),
            pt_theta=s["cur_theta"], pt_r=r0, pt_grad=s["cur_grad"],
            rho_sub=zeros, cand_sub=s["cur_theta"],
            cand_sub_logp=s["cur_logp"], cand_sub_grad=s["cur_grad"],
            logw_sub=-jnp.inf * jnp.ones((), dt),
        )
        for k_, v_ in init.items():
            s = dict(s, **{k_: jax.tree_util.tree_map(
                lambda a, b: jnp.where(fresh, a, b), v_, s[k_])})

        # ================= slot 1 (sub_n even for every chain) ==========
        n = s["sub_n"]
        rs_pre = s["rho_sub"]
        e = s["dir_eps"]
        r1 = s["pt_r"] + 0.5 * e * s["pt_grad"]
        th1 = s["pt_theta"] + e * (inv_mass * r1)
        lp1, g1 = vag(th1)
        r1 = r1 + 0.5 * e * g1

        # checkpoint writes: block starts live only at even positions
        r_ck, rs_ck = s["r_ckpt"], s["rsum_ckpt"]
        for k in range(1, max_depth + 1):
            starts = (n % (2 ** k)) == 0
            rs_ck = rs_ck.at[k].set(jnp.where(starts, rs_pre,
                                              rs_ck[k]))
            r_ck = r_ck.at[k].set(jnp.where(starts, r1,
                                            r_ck[k]))

        delta1 = (lp1 - kinetic(r1)) - s["energy0"]
        delta1 = jnp.where(jnp.isnan(delta1), -jnp.inf, delta1)
        div1 = delta1 < -thr
        alpha_sum = s["alpha_sum"] + jnp.minimum(1.0, jnp.exp(delta1))
        nlf = s["nlf"] + 1
        lws = jnp.logaddexp(s["logw_sub"], delta1)
        take1 = jnp.log(u_take1) < delta1 - lws
        cand_sub = jnp.where(take1, th1, s["cand_sub"])
        cand_sub_logp = jnp.where(take1, lp1, s["cand_sub_logp"])
        cand_sub_grad = jnp.where(take1, g1, s["cand_sub_grad"])
        rho_sub = rs_pre + r1

        # mid-pair subtree end: only the 1-leapfrog first subtree or a
        # divergence (no ends-test can fire at an odd position; a
        # multi-leapfrog subtree cannot complete at an odd position)
        m1 = (s["num_leaves"] == 1) | div1
        ok1 = ~div1
        take_tree1 = (jnp.log(u_bias1) < lws - s["logw_tree"]) & ok1
        cand_theta = jnp.where(m1 & take_tree1, cand_sub, s["cand_theta"])
        cand_logp = jnp.where(m1 & take_tree1, cand_sub_logp,
                              s["cand_logp"])
        cand_grad = jnp.where(m1 & take_tree1, cand_sub_grad,
                              s["cand_grad"])
        logw_tree = jnp.where(m1 & ok1,
                              jnp.logaddexp(s["logw_tree"], lws),
                              s["logw_tree"])
        went_right = e > 0
        upd1 = m1 & ok1
        right_theta = jnp.where(upd1 & went_right, th1, s["right_theta"])
        right_r = jnp.where(upd1 & went_right, r1, s["right_r"])
        right_grad = jnp.where(upd1 & went_right, g1, s["right_grad"])
        left_theta = jnp.where(upd1 & ~went_right, th1, s["left_theta"])
        left_r = jnp.where(upd1 & ~went_right, r1, s["left_r"])
        left_grad = jnp.where(upd1 & ~went_right, g1, s["left_grad"])
        rho_tree = jnp.where(upd1, s["rho_tree"] + rho_sub, s["rho_tree"])
        turning_tree1 = _uturn(rho_tree, left_r, right_r, inv_mass)
        traj_done1 = m1 & (div1 | turning_tree1
                           | (s["depth"] + 1 >= max_depth))

        start1 = m1 & ~traj_done1
        depth1 = s["depth"] + jnp.where(start1, 1, 0)
        new_dir1 = jnp.where(u_dir1 < 0.5, eps, -eps)
        dir_eps = jnp.where(start1, new_dir1, e)
        gr1 = dir_eps > 0
        pt_theta = jnp.where(
            start1, jnp.where(gr1, right_theta, left_theta), th1)
        pt_r = jnp.where(start1, jnp.where(gr1, right_r, left_r), r1)
        pt_grad = jnp.where(start1, jnp.where(gr1, right_grad, left_grad),
                            g1)
        sub_n = jnp.where(m1, 0, n + 1)
        num_leaves = jnp.where(start1,
                               jnp.left_shift(jnp.int32(1), depth1),
                               s["num_leaves"])
        rho_sub = jnp.where(start1, zeros, rho_sub)
        lws = jnp.where(start1, -jnp.inf, lws)

        cur_theta = jnp.where(traj_done1, cand_theta, s["cur_theta"])
        cur_logp = jnp.where(traj_done1, cand_logp, s["cur_logp"])
        cur_grad = jnp.where(traj_done1, cand_grad, s["cur_grad"])
        count = s["count"] + jnp.where(traj_done1, 1, 0)
        accept_sum = s["accept_sum"] + jnp.where(
            traj_done1, alpha_sum / jnp.maximum(nlf, 1), 0.0)
        depth_sum = s["depth_sum"] + jnp.where(
            traj_done1, depth1.astype(dt) + 1.0, 0.0)
        div_count = s["div_count"] + jnp.where(traj_done1 & div1, 1, 0)

        # every slot-1 subtree-ender idles slot 2: its next subtree (or
        # next trajectory) starts at the next pair, preserving alignment
        idle2 = m1

        # ================= slot 2 (masked by idle2) =====================
        act = ~idle2
        e2 = dir_eps
        r2 = pt_r + 0.5 * e2 * pt_grad
        th2 = pt_theta + e2 * (inv_mass * r2)
        lp2, g2 = vag(th2)
        r2 = r2 + 0.5 * e2 * g2
        delta2 = (lp2 - kinetic(r2)) - s["energy0"]
        delta2 = jnp.where(jnp.isnan(delta2), -jnp.inf, delta2)
        div2 = act & (delta2 < -thr)
        alpha_sum = alpha_sum + jnp.where(
            act, jnp.minimum(1.0, jnp.exp(delta2)), 0.0)
        nlf = nlf + jnp.where(act, 1, 0)
        lws2 = jnp.where(act, jnp.logaddexp(lws, delta2), lws)
        take2 = act & (jnp.log(u_take2) < delta2 - lws2)
        cand_sub = jnp.where(take2, th2, cand_sub)
        cand_sub_logp = jnp.where(take2, lp2, cand_sub_logp)
        cand_sub_grad = jnp.where(take2, g2, cand_sub_grad)
        rho_sub = jnp.where(act, rho_sub + r2, rho_sub)

        # the pair-boundary U-turn section: ends-tests for every level
        n2 = sub_n                      # odd for active chains
        turning_sub = jnp.asarray(False)
        for k in range(1, max_depth + 1):
            ends = act & (((n2 + 1) % (2 ** k)) == 0)
            block_rho = rho_sub - rs_ck[k]
            turning_sub = turning_sub | (
                ends & _uturn(block_rho, r_ck[k], r2, inv_mass))

        sub_done2 = act & ((((n2 + 1) >= num_leaves)) | turning_sub
                           | div2)
        ok2 = ~turning_sub & ~div2
        take_tree2 = (jnp.log(u_bias2) < lws2 - logw_tree) & ok2
        cand_theta = jnp.where(sub_done2 & take_tree2, cand_sub,
                               cand_theta)
        cand_logp = jnp.where(sub_done2 & take_tree2, cand_sub_logp,
                              cand_logp)
        cand_grad = jnp.where(sub_done2 & take_tree2, cand_sub_grad,
                              cand_grad)
        logw_tree = jnp.where(sub_done2 & ok2,
                              jnp.logaddexp(logw_tree, lws2), logw_tree)
        went_right2 = e2 > 0
        upd2 = sub_done2 & ok2
        right_theta = jnp.where(upd2 & went_right2, th2, right_theta)
        right_r = jnp.where(upd2 & went_right2, r2, right_r)
        right_grad = jnp.where(upd2 & went_right2, g2, right_grad)
        left_theta = jnp.where(upd2 & ~went_right2, th2, left_theta)
        left_r = jnp.where(upd2 & ~went_right2, r2, left_r)
        left_grad = jnp.where(upd2 & ~went_right2, g2, left_grad)
        rho_tree = jnp.where(upd2, rho_tree + rho_sub, rho_tree)
        turning_tree2 = _uturn(rho_tree, left_r, right_r, inv_mass)
        traj_done2 = sub_done2 & (turning_sub | div2
                                  | (ok2 & turning_tree2)
                                  | (depth1 + 1 >= max_depth))

        start2 = sub_done2 & ~traj_done2
        depth2 = depth1 + jnp.where(start2, 1, 0)
        new_dir2 = jnp.where(u_dir2 < 0.5, eps, -eps)
        dir_eps = jnp.where(start2, new_dir2, dir_eps)
        gr2 = dir_eps > 0
        pt_theta = jnp.where(
            start2, jnp.where(gr2, right_theta, left_theta),
            jnp.where(act, th2, pt_theta))
        pt_r = jnp.where(start2, jnp.where(gr2, right_r, left_r),
                         jnp.where(act, r2, pt_r))
        pt_grad = jnp.where(start2, jnp.where(gr2, right_grad, left_grad),
                            jnp.where(act, g2, pt_grad))
        sub_n = jnp.where(act, jnp.where(sub_done2, 0, n2 + 1), sub_n)
        num_leaves = jnp.where(start2,
                               jnp.left_shift(jnp.int32(1), depth2),
                               num_leaves)
        rho_sub = jnp.where(start2, zeros, rho_sub)
        lws2 = jnp.where(start2, -jnp.inf, lws2)

        cur_theta = jnp.where(traj_done2, cand_theta, cur_theta)
        cur_logp = jnp.where(traj_done2, cand_logp, cur_logp)
        cur_grad = jnp.where(traj_done2, cand_grad, cur_grad)
        count = count + jnp.where(traj_done2, 1, 0)
        accept_sum = accept_sum + jnp.where(
            traj_done2, alpha_sum / jnp.maximum(nlf, 1), 0.0)
        depth_sum = depth_sum + jnp.where(
            traj_done2, depth2.astype(dt) + 1.0, 0.0)
        div_count = div_count + jnp.where(traj_done2 & div2, 1, 0)

        new_s = dict(
            cur_theta=cur_theta, cur_logp=cur_logp, cur_grad=cur_grad,
            count=count, accept_sum=accept_sum, depth_sum=depth_sum,
            div_count=div_count, fresh=traj_done1 | traj_done2, key=key,
            energy0=s["energy0"],
            left_theta=left_theta, left_r=left_r, left_grad=left_grad,
            right_theta=right_theta, right_r=right_r,
            right_grad=right_grad,
            rho_tree=rho_tree, cand_theta=cand_theta, cand_logp=cand_logp,
            cand_grad=cand_grad, logw_tree=logw_tree, depth=depth2,
            alpha_sum=alpha_sum, nlf=nlf,
            dir_eps=dir_eps, sub_n=sub_n, num_leaves=num_leaves,
            pt_theta=pt_theta, pt_r=pt_r, pt_grad=pt_grad,
            rho_sub=rho_sub, cand_sub=cand_sub,
            cand_sub_logp=cand_sub_logp, cand_sub_grad=cand_sub_grad,
            logw_sub=lws2, r_ckpt=r_ck, rsum_ckpt=rs_ck,
        )
        if collect_idx is None or collect_idx == "all":
            emit = (cur_theta, count)
        else:
            emit = (cur_theta[collect_idx], count)
        return new_s, emit

    if injected_rng is None:
        out, hist = jax.lax.scan(pair, state, None, length=num_pairs)
    else:
        out, hist = jax.lax.scan(
            pair, state, tuple(jnp.asarray(x, dt) for x in injected_rng))
    cnt = jnp.maximum(out["count"], 1)
    inflight = out["alpha_sum"] / jnp.maximum(out["nlf"], 1)
    mean_accept = jnp.where(out["count"] > 0,
                            out["accept_sum"] / cnt, inflight)
    res = FSMResult(slots=jnp.zeros((0, dim), dt), counts=out["count"],
                    theta=out["cur_theta"], mean_accept=mean_accept,
                    mean_depth=out["depth_sum"] / cnt,
                    num_divergent=out["div_count"],
                    pos_mean=zeros, pos_var=zeros)
    return res, hist


def nuts_fsm_warmup_and_sample(key, value_and_grad, theta0,
                               num_warmup_ticks: int = 1024,
                               num_ticks: int = 2048,
                               warmup_chunks: int = 16,
                               max_depth: int = 10,
                               target_accept: float = 0.8,
                               adapt_mass: bool = True,
                               num_sample_slots: int = 256,
                               free_mask=None):
    """Full FSM pipeline for one chain (vmap over (key, theta0) for many):
    dual-averaging warmup in ``warmup_chunks`` fixed-tick chunks (one DA
    update per chunk from that chunk's mean accept statistic — chunked
    adaptation, since the FSM has no per-transition boundary across
    chains), diagonal mass from the second half of warmup samples, then a
    sampling run at the adapted (step size, mass). Returns
    (FSMResult, info dict).

    ``free_mask``: optional (dim,) 0/1 mask — coordinates with mask 0 are
    FROZEN (inverse mass pinned to 0 through warmup AND the mass
    adaptation, the shared frozen-coordinate convention of
    utils.sqrt_mass_safe), which is how partial selections condition each
    chain on its own unselected values (sample_posterior engine
    parity with chees/hmc_fused/nuts_fused)."""
    from .nuts import da_init, da_update, find_reasonable_step_size

    dim = theta0.shape[0]
    dt = theta0.dtype
    mask = (jnp.ones(dim, dt) if free_mask is None
            else jnp.asarray(free_mask, dt))
    k_find1, k_w1, k_samp = jax.random.split(key, 3)
    half = max(warmup_chunks // 2, 1)
    chunk_ticks = max(num_warmup_ticks // (3 * half), 1)
    B = num_sample_slots

    def da_stage(k_stage, theta_in, eps0, inv_mass):
        """Chunked dual averaging at fixed mass; returns final theta,
        adapted eps, and the position variance of the LAST chunk."""
        def chunk(carry, k):
            theta, da = carry
            res = nuts_fsm(k, value_and_grad, theta,
                           jnp.exp(da.log_eps), chunk_ticks,
                           max_depth=max_depth, inv_mass_diag=inv_mass,
                           num_sample_slots=B)
            da = da_update(da, res.mean_accept, target_accept)
            return (res.theta, da), res.pos_var

        (theta, da), pos_vars = jax.lax.scan(
            chunk, (theta_in, da_init(eps0)),
            jax.random.split(k_stage, half))
        # scale statistics: mean position variance over the later chunks
        var = jnp.mean(pos_vars[half // 2:], axis=0)
        return theta, jnp.exp(da.log_eps_bar), var

    # Iterated stages: adapt eps under the current mass, re-measure the
    # per-coordinate scales from that stage's (better-mixing) trajectory
    # positions, update the mass, repeat. One stage badly underestimates
    # slow directions (pre-preconditioning trajectories barely traverse
    # them); iterating converges geometrically — measured on a
    # (0.05, 1, 20)-scaled Gaussian the slow-dim mass goes 0.8 -> 80 ->
    # ~300 (true 400) over three stages.
    theta = theta0
    inv_mass = mask
    eps_final = jnp.asarray(0.1, dt)
    for stage in range(3):
        k_find = jax.random.fold_in(k_find1, stage)
        k_stage = jax.random.fold_in(k_w1, stage)
        eps0 = find_reasonable_step_size(k_find, value_and_grad, theta,
                                         inv_mass)
        theta, eps_final, var = da_stage(k_stage, theta, eps0, inv_mass)
        if stage < 2:
            # frozen coordinates stay frozen through adaptation (their
            # position variance is 0 anyway, but the 1e-8 floor would
            # silently unfreeze them)
            inv_mass = jnp.where(jnp.asarray(adapt_mass),
                                 mask * jnp.maximum(var, 1e-8), inv_mass)

    res = nuts_fsm(k_samp, value_and_grad, theta, eps_final, num_ticks,
                   max_depth=max_depth, inv_mass_diag=inv_mass,
                   num_sample_slots=num_sample_slots)
    info = dict(step_size=eps_final, inv_mass_diag=inv_mass,
                mean_accept=res.mean_accept)
    return res, info

