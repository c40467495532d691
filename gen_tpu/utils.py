"""Small pytree utilities shared across the framework."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def is_inexact(x) -> bool:
    try:
        return jnp.issubdtype(jnp.asarray(x).dtype, jnp.inexact)
    except (TypeError, ValueError):
        return False


def partition_inexact(tree):
    """Split a pytree into (differentiable, static) halves.

    Differentiable = leaves with inexact (float/complex) dtype; everything
    else (ints, bools, non-arrays) goes to the static half. ``None`` fills
    the holes (None is an empty pytree node, so ``jax.grad`` w.r.t. the
    differentiable half just works)."""
    dyn = jax.tree_util.tree_map(lambda x: x if is_inexact(x) else None, tree)
    static = jax.tree_util.tree_map(lambda x: None if is_inexact(x) else x, tree)
    return dyn, static


def combine(dyn, static):
    """Inverse of :func:`partition_inexact`."""
    return jax.tree_util.tree_map(
        lambda a, b: b if a is None else a, dyn, static,
        is_leaf=lambda x: x is None)


def tree_vdot(a, b):
    """Sum of elementwise products over matching leaves; ``a`` may be None
    (→ 0). Used for the <retgrad, retval> term of gradient methods."""
    if a is None:
        return jnp.asarray(0.0)
    leaves_a = jax.tree_util.tree_leaves(a)
    leaves_b = jax.tree_util.tree_leaves(b)
    total = jnp.asarray(0.0)
    for x, y in zip(leaves_a, leaves_b):
        total = total + jnp.sum(jnp.asarray(x) * jnp.asarray(y))
    return total


def is_static_scalar(x) -> bool:
    """Shape-determining scalars stay static across jit/vmap/scan boundaries
    (JAX convention): plain Python/numpy ints, bools, strings, None. Arrays
    and floats are traced."""
    import numpy as _np
    if x is None or isinstance(x, str):
        return True
    if isinstance(x, jnp.ndarray):
        return False
    return isinstance(x, (bool, int, _np.bool_, _np.integer))


def split_static(tree):
    """Partition a pytree's leaves into traced children and hashable static
    aux, for trace pytree registrations. Returns (dyn_children, aux)."""
    flat, treedef = jax.tree_util.tree_flatten(tree)
    mask = tuple(is_static_scalar(x) for x in flat)
    dyn = tuple(x for x, s in zip(flat, mask) if not s)
    static = tuple(x for x, s in zip(flat, mask) if s)
    return dyn, (treedef, mask, static)


def join_static(dyn, aux):
    treedef, mask, static = aux
    dyn_iter = iter(dyn)
    static_iter = iter(static)
    flat = [next(static_iter) if s else next(dyn_iter) for s in mask]
    return jax.tree_util.tree_unflatten(treedef, flat)


def logsumexp(x, axis=None):
    """Numerically stable logsumexp (reference:
    /root/reference/src/inference/inference.jl:3-7)."""
    return jax.scipy.special.logsumexp(jnp.asarray(x), axis=axis)


def sqrt_mass_safe(inv_mass):
    """Momentum scale with frozen-coordinate support: inv_mass == 0 means
    infinite mass (the coordinate is frozen for Gibbs-within-HMC/NUTS
    blocks or per-chain conditioning); its momentum draw is zero and every
    other momentum use is inv_mass-weighted, so it never moves. Works on
    arrays and (in-kernel) scalars — the ONE definition every engine and
    kernel shares (divergence here would silently change which
    coordinates count as frozen)."""
    import jax.numpy as jnp
    return jnp.where(inv_mass > 0,
                     1.0 / jnp.sqrt(jnp.maximum(inv_mass, 1e-30)), 0.0)


def use_compile_cache() -> str:
    """Keep JAX's persistent compilation cache in one fixed place and
    return it. Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already
    uses that directory and nothing else is set; otherwise the cache is
    ``<checkout>/.jax_cache``. Called by the programs' mains (never at
    import), so a library user's own cache setting is left alone."""
    import os
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path
