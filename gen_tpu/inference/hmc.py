"""Hamiltonian Monte Carlo.

Reference: /root/reference/src/inference/hmc.jl (leapfrog over the
``to_array``-flattened selected choices, gradients from
``choice_gradients``, standard-normal momenta, MH-corrected accept).

Design: the potential is extracted ONCE as a flat closed-over
``logp`` (:class:`~gen_tpu.inference.target.FlatTarget`); the L-step
leapfrog is a ``lax.scan`` over value-and-grad of that potential — a single
fused XLA loop with no trace reconstruction inside (the reference re-runs
``update`` + ``choice_gradients`` on the full trace every step,
hmc.jl:42-55; the math is identical because the unselected choices are
fixed, so Δ(model score) = Δ logp). The trace is rebuilt once, at accept
time. ``vmap`` runs thousands of chains in one program."""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..gfi import Trace
from ..selection import Selection
from ..utils import sqrt_mass_safe
from .common import mh_accept, select_trace
from .target import FlatTarget

_HALF_LOG_2PI = 0.9189385332046727


def _momenta_score(m):
    return jnp.sum(-0.5 * m * m - _HALF_LOG_2PI)


def hmc(key, trace: Trace, selection: Selection, L: int = 10,
        eps: float = 0.1, inv_mass_diag=None):
    """One HMC update on the selected addresses (optionally with a diagonal
    mass matrix — an extension; the reference uses identity mass,
    hmc.jl:1-9). Returns (new_trace, accepted)."""
    target = FlatTarget(trace, selection)
    values0 = target.flat0
    logp0, grad0 = target.value_and_grad(values0)
    inv_mass = (jnp.ones_like(values0) if inv_mass_diag is None
                else jnp.asarray(inv_mass_diag))
    sqrt_mass = sqrt_mass_safe(inv_mass)

    def kinetic(m):
        return 0.5 * jnp.dot(m, inv_mass * m)

    k_mom, k_acc = jax.random.split(key)
    momenta0 = sqrt_mass * jax.random.normal(k_mom, values0.shape,
                                             dtype=values0.dtype)
    prev_kinetic = kinetic(momenta0)

    def leapfrog(carry, _):
        values, momenta, grad = carry
        momenta = momenta + (eps / 2) * grad
        values = values + eps * (inv_mass * momenta)
        logp, grad = target.value_and_grad(values)
        momenta = momenta + (eps / 2) * grad
        return (values, momenta, grad), logp

    (values, momenta, _), logps = jax.lax.scan(
        leapfrog, (values0, momenta0, grad0), None, length=L)

    alpha = (logps[-1] - logp0 - kinetic(momenta) + prev_kinetic)
    alpha = jnp.where(jnp.isnan(alpha), -jnp.inf, alpha)
    accept = mh_accept(k_acc, alpha)

    new_trace = target.rebuild(values)
    return select_trace(accept, new_trace, trace), accept


def hmc_chains(key, target: FlatTarget, values0, n_steps: int, L: int = 10,
               eps: float = 0.1, inv_mass_diag=None, collect=None,
               unroll: bool = True, eps_jitter: float = 0.2,
               teleport_after: int = 0, draws=None):
    """Many-chain HMC entirely in the flat coordinate space: ``values0`` is
    ``(chains, d)`` and every step is one vmapped full HMC update (momenta,
    L leapfrogs, MH accept) inside a ``lax.scan`` over steps.

    This is the fast path for very large chain counts: no trace
    reconstruction inside the loop, samples collected step-major
    (``(steps, chains, ...)`` — the layout a scan writes contiguously), and
    the leapfrog loop unrolled so XLA fuses across leapfrog steps.

    CAVEAT (same as the nuts_fsm engine): ``target`` closes over the
    exemplar trace's UNselECTED choices, so every chain is conditioned on
    those values — only valid when the selection covers all latent
    addresses (unselected = shared observations), which
    :func:`~gen_tpu.inference.sample.sample_posterior` enforces.

    ``eps_jitter``: per-step multiplicative jitter of the step size,
    ``eps_m = eps * U(1-j, 1+j)`` (one scalar draw per step, shared by all
    chains — free). Fixed trajectory lengths RESONATE on
    (near-)Gaussian targets: at a full oscillation period (L*eps = 2*pi*sd)
    proposals return to their start, and at a half period they are the
    antithetic reflection 2*mu - x, so chains flip between two points
    forever — the mean converges but the spread never contracts (Neal 2011
    §5.4.2.2; caught live by a verify drive on a conjugate regression).
    Jitter breaks every resonance; 0.2 is the standard choice.

    ``teleport_after`` (WARMUP ONLY — breaks reversibility, so the result is
    not a valid MCMC sample): after that many consecutive rejections, jump a
    chain to a uniformly-random other chain's position (same trick as
    :mod:`~gen_tpu.inference.chees`). This rescues chains initialized in
    regions whose curvature exceeds the leapfrog stability limit for the
    chosen ``eps`` (e.g. the low-noise tail of a regression prior: measured
    18% of 524k prior-initialized chains permanently stuck at eps=0.035 —
    they reject every proposal and no warmup length fixes it). Run a warmup
    call with ``teleport_after=10``, then a sampling call without.

    ``draws=(step_sizes (n_steps,), z (n_steps, chains, d), u (n_steps,
    chains))`` replaces the random step sizes, standard-normal momentum
    draws and accept uniforms with the given numbers (``key`` then only
    feeds ``teleport_after``) — how the fused kernel is compared exactly
    with this sampler.

    ``collect(values) -> pytree`` maps the per-step state to what is
    recorded (default: the raw ``(chains, d)`` values). Returns
    ``(values, collected, accepts)`` with ``accepts`` of shape
    ``(n_steps, chains)``. Rebuild traces afterwards with
    ``jax.vmap(target.rebuild)(values)``.
    """
    if collect is None:
        collect = lambda v: v
    vg = jax.vmap(target.value_and_grad)
    inv_mass = (jnp.ones(values0.shape[-1], values0.dtype)
                if inv_mass_diag is None else jnp.asarray(inv_mass_diag))
    sqrt_mass = sqrt_mass_safe(inv_mass)

    def step(carry, xs):
        values, logp, grad, streak = carry
        step_key, given = xs
        k_mom, k_acc, k_jit, k_tel = jax.random.split(step_key, 4)
        if given is None:
            eps_m = eps * jax.random.uniform(
                k_jit, (), values0.dtype, 1.0 - eps_jitter, 1.0 + eps_jitter)
            z = jax.random.normal(k_mom, values.shape, dtype=values.dtype)
            u = jax.random.uniform(k_acc, values.shape[:1])
        else:
            eps_m, z, u = given
        momenta0 = sqrt_mass * z

        def leapfrog(c, _):
            v, m, g, _lp = c
            m = m + (eps_m / 2) * g
            v = v + eps_m * (inv_mass * m)
            lp, g = vg(v)
            m = m + (eps_m / 2) * g
            return (v, m, g, lp), None

        (v_new, m_new, g_new, lp_final), _ = jax.lax.scan(
            leapfrog, (values, momenta0, grad, logp), None, length=L,
            unroll=L if unroll else 1)
        kin = lambda m: 0.5 * jnp.sum(m * (inv_mass * m), axis=-1)
        alpha = lp_final - logp - kin(m_new) + kin(momenta0)
        alpha = jnp.where(jnp.isnan(alpha), -jnp.inf, alpha)
        acc = jnp.log(u) < alpha
        values = jnp.where(acc[:, None], v_new, values)
        logp = jnp.where(acc, lp_final, logp)
        grad = jnp.where(acc[:, None], g_new, grad)
        if teleport_after:
            streak = jnp.where(acc, 0, streak + 1)
            stuck = streak >= teleport_after
            idx = jax.random.randint(k_tel, (values.shape[0],), 0,
                                     values.shape[0])
            values = jnp.where(stuck[:, None], values[idx], values)
            logp = jnp.where(stuck, logp[idx], logp)
            grad = jnp.where(stuck[:, None], grad[idx], grad)
            streak = jnp.where(stuck, 0, streak)
        return (values, logp, grad, streak), (collect(values), acc)

    logp0, grad0 = vg(values0)
    streak0 = jnp.zeros(values0.shape[0], jnp.int32)
    (values, _, _, _), (collected, accepts) = jax.lax.scan(
        step, (values0, logp0, grad0, streak0),
        (jax.random.split(key, n_steps), draws))
    return values, collected, accepts


def hmc_chain(key, trace: Trace, selection: Selection, n_steps: int,
              L: int = 10, eps: float = 0.1):
    """Run a whole HMC chain on the flat selected-choice vector: the scan
    carry is just (values, logp, grad) — no trace reconstruction or
    whole-trace select per step (those cost more than the leapfrogs for
    small models). Returns (final_trace, samples (n_steps, d), accepts).

    vmap over (key, trace) for many chains — though at very large chain
    counts :func:`hmc_chains` (scan-of-vmap, samples written step-major)
    is the better layout; prefer hmc_chain for single/few chains or when
    the flat dimension is large."""
    target = FlatTarget(trace, selection)
    values0 = target.flat0
    logp0, grad0 = target.value_and_grad(values0)

    def step(carry, i):
        values, logp, grad = carry
        # fold per-step keys from the chain key: O(1) key material even
        # under vmap (pre-splitting n_steps keys per chain materializes a
        # (chains, steps) key tensor in device memory)
        k_mom, k_acc = jax.random.split(jax.random.fold_in(key, i))
        momenta0 = jax.random.normal(k_mom, values.shape, dtype=values.dtype)

        def leapfrog(c, _):
            v, m, g = c
            m = m + (eps / 2) * g
            v = v + eps * m
            lp, g = target.value_and_grad(v)
            m = m + (eps / 2) * g
            return (v, m, g), lp

        (v_new, m_new, g_new), lps = jax.lax.scan(
            leapfrog, (values, momenta0, grad), None, length=L)
        alpha = (lps[-1] - logp + _momenta_score(-m_new)
                 - _momenta_score(momenta0))
        alpha = jnp.where(jnp.isnan(alpha), -jnp.inf, alpha)
        accept = mh_accept(k_acc, alpha)
        values = jnp.where(accept, v_new, values)
        logp = jnp.where(accept, lps[-1], logp)
        grad = jnp.where(accept, g_new, grad)
        return (values, logp, grad), (values, accept)

    (values, _, _), (samples, accepts) = jax.lax.scan(
        step, (values0, logp0, grad0), jnp.arange(n_steps))
    return target.rebuild(values), samples, accepts

