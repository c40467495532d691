"""Fused many-chain HMC as one Pallas kernel on the GPU (Triton route).

The XLA :func:`~gen_tpu.inference.hmc.hmc_chains` path runs several
fusions per leapfrog, and each one reads and writes the ``(chains, d)``
state in device memory. This kernel gives every chain one lane of a block
and keeps its whole state (position, momentum, gradient, logp) in
registers for ALL ``n_steps x L`` leapfrogs: device-memory traffic is one
state read, the per-step collected row, and one final write. Momenta,
step-size jitter and accept draws come from a counter-based Threefry-2x32
generator inside the kernel, keyed on (seed, global chain index, step,
stream), so nothing random is read from memory either.

Layout: the state is ``(d, n_pad)`` with ``n_pad`` a multiple of the
block ``B``; program ``i`` owns chains ``[i*B, (i+1)*B)`` and holds each
coordinate as a ``(B,)`` vector. No shared memory is used.

The target ``logp: (d,) -> scalar`` is any traceable JAX function — in
particular ``FlatTarget(trace, selection).logp``, i.e. the full
generative-function ``assess`` — staged into the kernel by the
scalarization pass in :mod:`gen_tpu.ops.scalarize`: the data-only
subgraph is partial-evaluated OUTSIDE the kernel (one XLA computation per
call; for the benchmark regression model the 50-point dataset reduces to
13 staged scalars, which arrive as one small f32 input), and the
x-dependent residual is unrolled into per-coordinate elementwise ops on
the ``(B,)`` lane vectors. A per-point likelihood that does not collapse
streams its data table from device memory (L2-resident) inside the
kernel. A logp that does not stage (``while_loop``, traced gathers) runs
on the XLA path.

Reference lineage: inference/hmc.jl:25-73 is the semantic ancestor
(leapfrog + MH accept over to_array-flattened selected choices); the
many-chain, jittered, register-resident formulation has no reference
analogue.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np

# chains per program and warps per program (measured on one H100; see
# CHANGES.md)
_BLOCK = 256
_NUM_WARPS = 4

_TINY = 1.1754944e-38
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 (20 rounds) on uint32 words — the same block cipher
    as ``jax.random``'s default generator, written with add / rotate / xor
    only so that it lowers inside a Triton kernel. Broadcasts like
    ``jnp`` arithmetic; returns the two output words."""
    u32 = jnp.uint32
    k0, k1 = jnp.asarray(k0, u32), jnp.asarray(k1, u32)
    ks = (k0, k1, k0 ^ k1 ^ u32(0x1BD11BDA))
    x = [jnp.asarray(x0, u32) + ks[0], jnp.asarray(x1, u32) + ks[1]]
    for i in range(5):                     # 5 key injections x 4 rounds
        for r in _ROTATIONS[i % 2]:
            x[0] = x[0] + x[1]
            x[1] = (x[1] << u32(r)) | (x[1] >> u32(32 - r))
            x[1] = x[1] ^ x[0]
        x[0] = x[0] + ks[(i + 1) % 3]
        x[1] = x[1] + ks[(i + 2) % 3] + u32(i + 1)
    return x[0], x[1]


def _uniform(bits):
    """uint32 bits -> f32 uniform in [0, 1) (``jax.random``'s mantissa
    construction)."""
    mant = (bits >> jnp.uint32(9)) | jnp.uint32(0x3F800000)
    return jax.lax.bitcast_convert_type(mant, jnp.float32) - 1.0


def step_draws(k0, k1, lane, step, d: int):
    """The kernel's randomness for one HMC step: ``(eps_u, z, u)`` with
    ``eps_u`` the step-size jitter uniform shared by every chain, ``z`` a
    list of ``d`` standard-normal ``lane``-shaped vectors (Box-Muller on
    counter pairs) and ``u`` the accept uniform in (0, 1].

    Counters: word 0 is the global chain index ``lane``; word 1 is
    ``step * S + stream`` with ``S = ceil(d/2) + 1`` streams per step (the
    normal pairs, then the accept draw). The jitter draw uses chain index
    ``0xFFFFFFFF``, so it is the same for every chain. The same function
    reproduces the kernel's draws outside it (``lane = arange(n)``)."""
    u32 = jnp.uint32
    pairs = (d + 1) // 2
    base = jnp.asarray(step).astype(u32) * u32(pairs + 1)
    j0, _ = threefry2x32(k0, k1, u32(0xFFFFFFFF), jnp.asarray(step).astype(u32))
    z = []
    for j in range(pairs):
        b0, b1 = threefry2x32(k0, k1, lane, base + u32(j))
        r = jnp.sqrt(-2.0 * jnp.log(1.0 - _uniform(b0)))
        theta = jnp.float32(2.0 * np.pi) * _uniform(b1)
        z += [r * jnp.cos(theta), r * jnp.sin(theta)]
    a0, _ = threefry2x32(k0, k1, lane, base + u32(pairs))
    return _uniform(j0), z[:d], 1.0 - _uniform(a0)


def _kernel(n_steps, L, eps, eps_jitter, collect_idx, d, block, n_res,
            staged, injected, has_stream, *refs):
    import jax.experimental.pallas as pl
    from ..utils import sqrt_mass_safe

    refs = list(refs)
    x_ref, seed_ref, res_ref, mass_ref = refs[:4]
    refs = refs[4:]
    data_ref = refs.pop(0) if has_stream else None
    if injected:
        # testing hook: per-step step sizes / momentum normals / accept
        # uniforms as inputs, so the kernel can be compared exactly with a
        # reference consuming the same numbers
        eps_ref, z_ref, u_ref = refs[:3]
        refs = refs[3:]
    out_ref, vout_ref, acc_ref = refs

    start = pl.program_id(0) * block
    cols = pl.ds(start, block)
    res = [res_ref[i] for i in range(n_res)]
    load = None
    if has_stream:
        def load(row, first, size):
            return data_ref[row, pl.ds(first, size)]

    def vag(v):
        lp, g = staged.plane_vag(v, res, load)
        return lp, tuple(g)

    k0, k1 = seed_ref[0], seed_ref[1]
    lane = (start + jax.lax.iota(jnp.int32, block)).astype(jnp.uint32)
    inv = [mass_ref[k] for k in range(d)]
    mom_scale = [sqrt_mass_safe(m) for m in inv]

    def kin(m):
        return 0.5 * sum(inv[k] * m[k] * m[k] for k in range(d))

    v0 = tuple(x_ref[k, cols] for k in range(d))
    lp0, g0 = vag(v0)
    acc0 = jnp.zeros_like(lp0)

    def step(i, carry):
        v, lp, g, acc = carry
        if injected:
            eps_i = eps_ref[i]
            z = [z_ref[i, k, cols] for k in range(d)]
            u = u_ref[i, cols]
        else:
            eps_u, z, u = step_draws(k0, k1, lane, i, d)
            eps_i = eps * (1.0 - eps_jitter + 2.0 * eps_jitter * eps_u)
        mom0 = tuple(mom_scale[k] * z[k] for k in range(d))

        def leap(_, c):
            v, m, g, lp = c
            m = tuple(m[k] + (eps_i * 0.5) * g[k] for k in range(d))
            v = tuple(v[k] + eps_i * (inv[k] * m[k]) for k in range(d))
            lp, g = vag(v)
            m = tuple(m[k] + (eps_i * 0.5) * g[k] for k in range(d))
            return v, m, g, lp

        v_new, m_new, g_new, lp_new = jax.lax.fori_loop(
            0, L, leap, (v, mom0, g, lp))
        alpha = lp_new - lp - kin(m_new) + kin(mom0)
        alpha = jnp.where(jnp.isnan(alpha), -jnp.inf, alpha)
        accept = jnp.log(jnp.maximum(u, _TINY)) < alpha
        v = tuple(jnp.where(accept, v_new[k], v[k]) for k in range(d))
        g = tuple(jnp.where(accept, g_new[k], g[k]) for k in range(d))
        lp = jnp.where(accept, lp_new, lp)
        acc = acc + accept.astype(jnp.float32)
        if collect_idx is None:
            for k in range(d):
                out_ref[i, k, cols] = v[k]
        else:
            out_ref[i, cols] = v[collect_idx]
        return v, lp, g, acc

    v, _, _, acc = jax.lax.fori_loop(0, n_steps, step, (v0, lp0, g0, acc0))
    for k in range(d):
        vout_ref[k, cols] = v[k]
    acc_ref[cols] = acc


def stage_for_kernel(logp: Callable, d: int):
    """``(staged, None)`` when ``logp`` stages into the kernel, else
    ``(None, reason)``. Staging refuses oversized or non-float residuals
    up front; unsupported residual primitives (``while_loop``, traced
    gathers, non-additive data sums) refuse when the plane function is
    traced, so both the value and the gradient path are probed here."""
    from .scalarize import stage_scalarized
    try:
        staged = stage_scalarized(logp, d)
        res = [staged.res_consts[i]
               for i in range(int(staged.res_consts.shape[0]))]
        data = staged.stream_data
        jax.eval_shape(
            lambda v: staged.plane_vag(v, res, data),
            jax.ShapeDtypeStruct((d, 8), jnp.float32))
    except (NotImplementedError, ValueError) as e:
        return None, f"{type(e).__name__}: {str(e).splitlines()[0]}"
    return staged, None


def _pad_lanes(x, n_pad, axis):
    """Pad ``axis`` to ``n_pad`` with copies of index 0 (finite logp)."""
    n = x.shape[axis]
    if n == n_pad:
        return x
    first = jax.lax.slice_in_dim(x, 0, 1, axis=axis)
    shape = list(x.shape)
    shape[axis] = n_pad - n
    return jnp.concatenate([x, jnp.broadcast_to(first, shape)], axis=axis)


def _kernel_call(key, staged, values0, n_steps, L, eps, eps_jitter,
                 collect_idx, inv_mass, injected_rng, interpret):
    import jax.experimental.pallas as pl
    from jax.experimental.pallas import triton as plt

    n, d = values0.shape
    block = _BLOCK
    n_pad = -(-n // block) * block
    planes = _pad_lanes(values0.T, n_pad, 1)                 # (d, n_pad)
    has_stream = staged.stream_data is not None
    seed = jax.random.key_data(key).astype(jnp.uint32).reshape(-1)[:2]
    inputs = [planes, seed, staged.res_consts, inv_mass]
    if has_stream:
        inputs.append(staged.stream_data)
    if injected_rng is not None:
        eps_steps, z_all, u_all = injected_rng
        inputs += [jnp.asarray(eps_steps, jnp.float32).reshape(n_steps),
                   _pad_lanes(jnp.moveaxis(jnp.asarray(z_all, jnp.float32),
                                           2, 1), n_pad, 2),
                   _pad_lanes(jnp.asarray(u_all, jnp.float32), n_pad, 1)]
    hist_shape = ((n_steps, n_pad) if collect_idx is not None
                  else (n_steps, d, n_pad))
    out, vout, acc = pl.pallas_call(
        functools.partial(_kernel, n_steps, L, float(eps), float(eps_jitter),
                          collect_idx, d, block,
                          int(staged.res_consts.shape[0]), staged,
                          injected_rng is not None, has_stream),
        grid=(n_pad // block,),
        out_shape=(jax.ShapeDtypeStruct(hist_shape, jnp.float32),
                   jax.ShapeDtypeStruct((d, n_pad), jnp.float32),
                   jax.ShapeDtypeStruct((n_pad,), jnp.float32)),
        input_output_aliases={0: 1},
        backend="triton",
        compiler_params=plt.CompilerParams(num_warps=_NUM_WARPS,
                                           num_stages=1),
        interpret=interpret,
        name="hmc_fused",
    )(*inputs)
    values = vout[:, :n].T
    if collect_idx is None:
        collected = jnp.moveaxis(out[:, :, :n], 1, 2)
    else:
        collected = out[:, :n]
    return values, collected, acc[:n]


@functools.partial(jax.jit, static_argnames=(
    "logp", "n_steps", "L", "eps", "eps_jitter", "collect_idx",
    "interpret"))
def hmc_chains_fused(key, logp: Callable, values0, n_steps: int,
                     L: int = 10, eps: float = 0.1,
                     eps_jitter: float = 0.2,
                     collect_idx: Optional[int] = 0,
                     inv_mass_diag=None,
                     injected_rng=None, interpret: bool = False):
    """Run ``n_steps`` full HMC updates on (n_chains, d) ``values0``.

    Returns ``(values (n, d), collected, accept_counts (n,))`` where
    ``collected`` is ``(n_steps, n)`` holding coordinate ``collect_idx``
    after each step, or ``(n_steps, n, d)`` (all coordinates) when
    ``collect_idx=None`` — size device memory accordingly at large chain
    counts. ``logp`` must be a hashable traceable callable (a plain
    function or e.g. ``FlatTarget(...).logp``; it is a static argument).
    ``inv_mass_diag``: optional (d,) inverse-mass diagonal (may be traced).

    Where it runs is decided by :func:`gen_tpu.ops.backend.hmc_kernel_route`:
    the kernel on the GPU for ``d`` up to the measured crossover when the
    logp stages, the XLA sampler (:func:`~gen_tpu.inference.hmc.hmc_chains`,
    same semantics, another random stream) otherwise.

    Testing hooks: ``interpret=True`` runs the kernel in Pallas' interpret
    mode (how the CPU tests exercise its logic); ``injected_rng=(step_sizes
    (n_steps,), z (n_steps, n, d), u (n_steps, n))`` replaces the kernel's
    generator with precomputed step sizes / momentum normals / accept
    uniforms, for exact comparison with a reference."""
    from .backend import hmc_kernel_route
    values0 = jnp.asarray(values0, jnp.float32)
    n, d = values0.shape
    inv_mass = (jnp.ones((d,), jnp.float32) if inv_mass_diag is None
                else jnp.asarray(inv_mass_diag, jnp.float32))
    staged = None
    if interpret or hmc_kernel_route(d):
        staged, reason = stage_for_kernel(logp, d)
        if staged is None and (interpret or injected_rng is not None):
            raise ValueError(f"logp does not stage into the kernel: {reason}")
    if injected_rng is not None and staged is None:
        raise ValueError("injected_rng drives the kernel, which does not run "
                         "here (pass interpret=True off the GPU)")
    if staged is not None:
        return _kernel_call(key, staged, values0, n_steps, L, eps,
                            eps_jitter, collect_idx, inv_mass, injected_rng,
                            interpret)

    from types import SimpleNamespace
    from ..inference.hmc import hmc_chains
    target = SimpleNamespace(value_and_grad=jax.value_and_grad(logp))
    collect = ((lambda v: v) if collect_idx is None
               else (lambda v: v[:, collect_idx]))
    values, collected, accepts = hmc_chains(
        key, target, values0, n_steps=n_steps, L=L, eps=eps,
        eps_jitter=eps_jitter, inv_mass_diag=inv_mass, collect=collect)
    return values, collected, jnp.sum(accepts, axis=0).astype(jnp.float32)
