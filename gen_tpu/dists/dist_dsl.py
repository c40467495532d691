"""Derived distributions — the analogue of Gen.jl's ``@dist`` DSL.

Reference: /root/reference/src/modeling_library/dist_dsl/ (dist_dsl.jl 235
LoC + transformed_distribution.jl + relabeled_distribution.jl): derived
distributions built from argument transformations, bijective output
transformations (affine, exp, log), and relabeling of discrete outputs.

Here the same algebra is ordinary Python composition:

* arithmetic sugar on distributions — ``normal(...) * 2 + 3``,
  ``exp_dist(normal)`` — builds :class:`TransformedDistribution` with the
  change-of-variables logpdf correction;
* ``RelabeledDistribution(labels, base)`` maps a discrete index
  distribution through a label array (duplicate labels sum their mass, as
  in the reference's WithLabelArg);
* argument transformations are just Python callables closing over args.
"""

from __future__ import annotations

from typing import Callable, Optional

import jax
import jax.numpy as jnp

from .distribution import Distribution, _f


class Bijection:
    """A scalar (elementwise) bijection y = f(x) with log|dy/dx|."""

    def __init__(self, forward: Callable, inverse: Callable,
                 log_abs_deriv: Callable, name: str = "bijection"):
        self.forward = forward
        self.inverse = inverse
        self.log_abs_deriv = log_abs_deriv  # log|f'(x)| as a function of x
        self.name = name


def affine_bijection(a, b):
    """y = a*x + b."""
    a = jnp.asarray(a)
    return Bijection(
        forward=lambda x: a * x + b,
        inverse=lambda y: (y - b) / a,
        log_abs_deriv=lambda x: jnp.broadcast_to(jnp.log(jnp.abs(a)),
                                                 jnp.shape(x)),
        name=f"affine({a}, {b})")


exp_bijection = Bijection(jnp.exp, jnp.log, lambda x: x, "exp")
log_bijection = Bijection(
    jnp.log, jnp.exp, lambda x: -jnp.log(x), "log")


class TransformedDistribution(Distribution):
    """y = f(x), x ~ base. For continuous base: logpdf(y) = base.logpdf(
    f^-1(y)) - log|f'(f^-1(y))| (reference transformed_distribution.jl).
    For discrete base the transform is a relabeling with no correction."""

    def __init__(self, base: Distribution, bij: Bijection):
        self.base = base
        self.bij = bij
        self.is_discrete = base.is_discrete
        self.has_output_grad = base.has_output_grad
        self.arg_grads = base.arg_grads

    def __repr__(self):
        return f"{self.bij.name}({self.base!r})"

    def sample(self, key, *args):
        return self.bij.forward(self.base.sample(key, *args))

    def logpdf(self, v, *args):
        v = _f(v) if not self.is_discrete else v
        x = self.bij.inverse(v)
        lp = self.base.logpdf(x, *args)
        if self.is_discrete:
            return lp
        return lp - jnp.sum(self.bij.log_abs_deriv(x))


class RelabeledDistribution(Distribution):
    """v = labels[i], i ~ base index distribution.

    Reference: dist_dsl/relabeled_distribution.jl — the logpdf sums the
    index probability over every index whose label equals v, so duplicate
    labels behave correctly."""

    def __init__(self, labels, base: Distribution):
        self.labels = jnp.asarray(labels)
        self.base = base
        self.is_discrete = True
        self.has_output_grad = False
        self.arg_grads = base.arg_grads

    def __repr__(self):
        return f"relabeled({self.base!r})"

    def sample(self, key, *args):
        idx = self.base.sample(key, *args)
        return self.labels[idx]

    def logpdf(self, v, *args):
        idxs = jnp.arange(self.labels.shape[0])
        match = self.labels == jnp.asarray(v)
        lps = jax.vmap(lambda i: self.base.logpdf(i, *args))(idxs)
        return jax.scipy.special.logsumexp(jnp.where(match, lps, -jnp.inf))


class ArgMappedDistribution(Distribution):
    """Distribution with transformed arguments: ``d(args*) = base(g(args*))``
    (the reference's TransformedArg machinery, dist_dsl.jl:33-90)."""

    def __init__(self, base: Distribution, arg_fn: Callable,
                 num_args: Optional[int] = None, is_discrete=None):
        self.base = base
        self.arg_fn = arg_fn
        self.is_discrete = (base.is_discrete if is_discrete is None
                            else is_discrete)
        self.has_output_grad = base.has_output_grad
        self.arg_grads = (True,) * (num_args or 0)

    def __repr__(self):
        return f"arg_mapped({self.base!r})"

    def sample(self, key, *args):
        return self.base.sample(key, *self.arg_fn(*args))

    def logpdf(self, v, *args):
        return self.base.logpdf(v, *self.arg_fn(*args))


def dist(fn: Callable, num_args: int = None, base: Distribution = None,
         **kwargs):
    """Closest analogue of ``@dist``: wrap an argument-transforming callable
    around a base distribution. ``fn(*user_args) -> base_args_tuple``."""
    if base is None:
        raise ValueError("dist(...) requires base=<Distribution>")
    return ArgMappedDistribution(base, fn, num_args=num_args, **kwargs)


# -- operator sugar on Distribution ---------------------------------------

def _add(self, c):
    return TransformedDistribution(self, affine_bijection(1.0, c))


def _mul(self, c):
    return TransformedDistribution(self, affine_bijection(c, 0.0))


def _sub(self, c):
    return TransformedDistribution(self, affine_bijection(1.0, -c))


def _rsub(self, c):
    return TransformedDistribution(self, affine_bijection(-1.0, c))


def _div(self, c):
    return TransformedDistribution(self, affine_bijection(1.0 / c, 0.0))


def _neg(self):
    return TransformedDistribution(self, affine_bijection(-1.0, 0.0))


Distribution.__add__ = _add
Distribution.__radd__ = _add
Distribution.__mul__ = _mul
Distribution.__rmul__ = _mul
Distribution.__sub__ = _sub
Distribution.__rsub__ = _rsub
Distribution.__truediv__ = _div
Distribution.__neg__ = _neg


def exp_of(base: Distribution) -> TransformedDistribution:
    return TransformedDistribution(base, exp_bijection)


def log_of(base: Distribution) -> TransformedDistribution:
    return TransformedDistribution(base, log_bijection)


def enum_dist(enum_cls, base: Distribution) -> RelabeledDistribution:
    """``@dist`` Enum-construction sugar (reference dist_dsl/dist_dsl.jl:
    229-235: an Enum type applied to a DistWithArgs relabels through the
    Int(instance) lookup). Here ``base`` is an index distribution over
    positions 0..len(enum_cls)-1 in definition order, and samples are the
    members' ``.value`` as int arrays (traced-safe — Python Enum objects
    cannot be traced values on an accelerator); recover the member host-side with
    ``enum_cls(int(v))``. Duplicate values sum their index mass, as in the
    reference's RelabeledDistribution."""
    labels = jnp.asarray([m.value for m in enum_cls])
    return RelabeledDistribution(labels, base)
