"""Distribution interface.

Analogue of Gen.jl's ``Distribution{T}`` interface
(/root/reference/src/modeling_library/modeling_library.jl:8-54):
``random``→``sample`` (with explicit PRNG key), ``logpdf``, ``logpdf_grad``,
``has_output_grad``, ``has_argument_grads``, ``is_discrete``.

Design notes:

* ``logpdf`` must be pure jnp code — it is traced under jit/vmap/grad and is
  the per-choice hot op; XLA fuses the whole model's logpdf sum into a few
  kernels.
* ``logpdf_grad`` defaults to ``jax.grad`` of ``logpdf`` (the reference
  hand-writes analytic gradients; XLA autodiff produces the same math).
  Distributions may override when autodiff is numerically inferior.
* Every distribution is also a :class:`~gen_tpu.gfi.GenerativeFunction`
  with a single choice at the root, so ``dist(args) @ "x"`` works inside
  models and ``choice_at``/combinators can wrap them uniformly.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from ..gfi import GenerativeFunction


class Distribution(GenerativeFunction):
    """Base class for primitive probability distributions."""

    is_discrete: bool = False
    has_output_grad: bool = True
    arg_grads: Tuple[bool, ...] = ()

    def sample(self, key, *args):
        raise NotImplementedError

    def logpdf(self, v, *args):
        raise NotImplementedError

    def has_argument_grads(self) -> Tuple[bool, ...]:
        return self.arg_grads

    def enumerate_support(self, *args):
        """Finite support of the distribution (1-D array of candidate
        values), for exact enumerative moves (gibbs / mixed-model
        sample_posterior). Only finite discrete distributions implement
        this; the default raises with advice.

        Must be computable from STATIC information (Python scalars /
        array shapes) — it is called at trace time, where array contents
        may be tracers. Reference: Gen.jl has no support metadata; its
        examples hand-enumerate (e.g. regression/
        dynamic_map_optimize_gibbs.jl scores {true,false} by hand)."""
        raise NotImplementedError(
            f"{type(self).__name__} has no finite enumerable support; "
            "addresses drawn from it cannot be moved by exact Gibbs — "
            "pass explicit discrete_supports= (if a finite truncation is "
            "acceptable) or marginalize the address out of the model")

    def logpdf_grad(self, v, *args):
        """(output_grad_or_None, *arg_grads_or_None).

        Default: autodiff of ``logpdf`` (reference writes these analytically,
        e.g. normal at distributions/normal.jl:73-81; XLA computes the same
        derivative graph).
        """
        if self.has_output_grad:
            v = _f(v)
        args = tuple(args)
        diff_wrt = []
        if self.has_output_grad:
            diff_wrt.append(0)
        diff_wrt.extend(i + 1 for i, g in enumerate(self.arg_grads) if g)

        if not diff_wrt:
            return (None,) + (None,) * len(args)

        def f(*all_args):
            return jnp.sum(self.logpdf(all_args[0], *all_args[1:]))

        fargs = (v,) + tuple(_f(a) if _inexact_ok(a) else a for a in args)
        grads = jax.grad(f, argnums=tuple(diff_wrt))(*fargs)
        out = [None] * (len(args) + 1)
        for idx, g in zip(diff_wrt, grads):
            out[idx] = g
        return tuple(out)

    def get_return_type(self):
        return jnp.float32 if not self.is_discrete else jnp.int32

    def __repr__(self):
        return f"{type(self).__name__.lower()}"


def _f(x):
    """Promote to a float array for differentiation."""
    x = jnp.asarray(x)
    if not jnp.issubdtype(x.dtype, jnp.inexact):
        x = x.astype(jnp.result_type(float))
    return x


def _inexact_ok(a):
    a = jnp.asarray(a)
    return jnp.issubdtype(a.dtype, jnp.inexact) or jnp.issubdtype(a.dtype, jnp.integer)


def logsumexp2(a, b):
    """Pairwise logsumexp (reference: src/inference/inference.jl:9-13)."""
    m = jnp.maximum(a, b)
    m_safe = jnp.where(jnp.isfinite(m), m, 0.0)
    out = m_safe + jnp.log(jnp.exp(a - m_safe) + jnp.exp(b - m_safe))
    return jnp.where(jnp.isfinite(m), out, m)
