"""Mixture distributions.

Reference: /root/reference/src/modeling_library/mixture.jl (278 LoC).
``HomogeneousMixture(dist, dims)``: K components of one distribution family,
args = (weights, *stacked_args) with each stacked arg carrying a leading K
axis. ``HeterogeneousMixture(dists)``: one component per distribution, args
= (weights, *flat_args...).

accelerator-native: the K component logpdfs are one ``vmap`` + ``logsumexp``;
gradients come from XLA autodiff of that expression (the reference
hand-derives the same posterior-responsibility formulas at
mixture.jl:84-140)."""

from __future__ import annotations

from typing import Sequence

import jax
import jax.numpy as jnp

from ..utils import logsumexp
from .distribution import Distribution, _f


class HomogeneousMixture(Distribution):
    """Mixture of K components from one distribution family."""

    def __init__(self, dist: Distribution, dims: Sequence[int]):
        self.dist = dist
        self.dims = tuple(dims)
        self.is_discrete = dist.is_discrete
        self.has_output_grad = dist.has_output_grad
        self.arg_grads = (True,) + tuple(dist.arg_grads)

    def __repr__(self):
        return f"HomogeneousMixture({self.dist!r})"

    def _component_logpdfs(self, v, args):
        def one(*component_args):
            return self.dist.logpdf(v, *component_args)
        return jax.vmap(one)(*[jnp.asarray(a) for a in args])

    def sample(self, key, weights, *args):
        kc, ks = jax.random.split(key)
        weights = _f(weights)
        idx = jax.random.categorical(kc, jnp.log(weights))
        component_args = tuple(jnp.asarray(a)[idx] for a in args)
        return self.dist.sample(ks, *component_args)

    def logpdf(self, v, weights, *args):
        weights = _f(weights)
        lps = self._component_logpdfs(v, args)
        return logsumexp(jnp.log(weights) + lps)


class HeterogeneousMixture(Distribution):
    """Mixture of distinct component distributions with flat-packed args
    (reference: mixture.jl:208-278): args = (weights, *args_of_dist1,
    *args_of_dist2, ...)."""

    def __init__(self, dists: Sequence[Distribution]):
        self.dists = tuple(dists)
        self.num_args = tuple(len(d.arg_grads) for d in self.dists)
        self.is_discrete = all(d.is_discrete for d in self.dists)
        self.has_output_grad = all(d.has_output_grad for d in self.dists)
        grads = [True]
        for d in self.dists:
            grads.extend(d.arg_grads)
        self.arg_grads = tuple(grads)

    def __repr__(self):
        return f"HeterogeneousMixture({self.dists!r})"

    def _unpack(self, args):
        out, i = [], 0
        for n in self.num_args:
            out.append(tuple(args[i:i + n]))
            i += n
        if i != len(args):
            raise ValueError(
                f"HeterogeneousMixture expects {i} component args, got {len(args)}")
        return out

    def sample(self, key, weights, *args):
        kc, ks = jax.random.split(key)
        weights = _f(weights)
        per = self._unpack(args)
        idx = jax.random.categorical(kc, jnp.log(weights))
        # components may have different output shapes only if the user made
        # them so; sample all (K is small) and select — branchless under jit
        samples = [d.sample(k, *a) for d, a, k in
                   zip(self.dists, per, jax.random.split(ks, len(self.dists)))]
        stacked = jnp.stack([jnp.asarray(s, dtype=jnp.result_type(*samples))
                             for s in samples])
        return stacked[idx]

    def logpdf(self, v, weights, *args):
        weights = _f(weights)
        per = self._unpack(args)
        lps = jnp.stack([d.logpdf(v, *a) for d, a in zip(self.dists, per)])
        return logsumexp(jnp.log(weights) + lps)
