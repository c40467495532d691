"""Map combinator: independent application of a kernel over vectors of
arguments.

Reference: /root/reference/src/modeling_library/map/ (510 LoC of per-method
Julia loops). Design: every GFI method is ONE ``jax.vmap`` of the
kernel's method over the element axis — simulate/generate/update/regenerate
for N elements compile to a single batched XLA program, and the trace is a
single pytree with a leading element axis (no per-element objects).

Addresses: element i's choices live under integer key i, as in the
reference. Dense constraints (:class:`VectorChoiceMap`, or an int-keyed map
covering every element with one structure) take the vmapped fast path;
ragged constraints fall back to a trace-time per-element loop with stacking
(same semantics, slower to trace — shapes are still static)."""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from ..choice_map import ChoiceMap
from ..diff import UnknownChange, all_unknown_change
from ..gfi import GenerativeFunction, Trace
from ..selection import AllSelection, EmptySelection, Selection
from .vector import (VectorChoiceMap, densify_masked, sparsify_masked,
                     try_densify, tree_index, tree_stack)


class MapTrace(Trace):
    __slots__ = ("gen_fn", "args", "subtraces", "score", "retval", "length")

    def __init__(self, gen_fn, args, subtraces, score, retval, length):
        self.gen_fn = gen_fn
        self.args = args
        self.subtraces = subtraces  # ONE batched subtrace pytree
        self.score = score
        self.retval = retval
        self.length = length

    def get_args(self):
        return self.args

    def get_retval(self):
        return self.retval

    def get_score(self):
        return self.score

    def get_gen_fn(self):
        return self.gen_fn

    def get_choices(self) -> VectorChoiceMap:
        # get_choices is pure pytree restructuring, so applying it to the
        # batched subtrace yields batched leaves directly.
        return VectorChoiceMap(self.subtraces.get_choices(), self.length)

    def get_subtrace(self, i):
        return tree_index(self.subtraces, i)

    def __getitem__(self, addr):
        """Element access: trace[(i, ...)] descends into element i; trace[i]
        alone gives element i's return value (Gen vector-trace semantics)."""
        from ..address import addr_path
        path = addr_path(addr)
        head, rest = path[0], path[1:]
        sub = self.get_subtrace(head)
        if not rest:
            return sub.get_retval()
        return sub[rest if len(rest) > 1 else rest[0]]

    def project(self, selection: Selection):
        if isinstance(selection, EmptySelection):
            return jnp.sum(jax.vmap(lambda t: t.project(selection))(
                self.subtraces))
        if isinstance(selection, AllSelection):
            return jnp.sum(jax.vmap(lambda t: t.project(selection))(
                self.subtraces))
        from ..selection import batch_selections
        try:
            shared, masked = batch_selections(
                [selection.subselection(i) for i in range(self.length)])
        except NotImplementedError:
            shared = masked = None
        if shared is not None:
            return jnp.sum(jax.vmap(lambda t: t.project(shared))(
                self.subtraces))
        if masked is not None:
            return jnp.sum(jax.vmap(lambda t, s: t.project(s))(
                self.subtraces, masked))
        total = jnp.asarray(0.0)
        for i in range(self.length):
            total = total + self.get_subtrace(i).project(
                selection.subselection(i))
        return total


def _maptrace_flatten(tr: MapTrace):
    from ..utils import split_static
    args_dyn, args_aux = split_static(tr.args)
    return ((args_dyn, tr.subtraces, tr.score, tr.retval),
            (tr.gen_fn, tr.length, args_aux))


def _maptrace_unflatten(aux, children):
    from ..utils import join_static
    gen_fn, length, args_aux = aux
    args_dyn, subtraces, score, retval = children
    return MapTrace(gen_fn, join_static(args_dyn, args_aux), subtraces,
                    score, retval, length)


jax.tree_util.register_pytree_node(
    MapTrace, _maptrace_flatten, _maptrace_unflatten)


def _length_of(args: Tuple) -> int:
    leaves = jax.tree_util.tree_leaves(args)
    if not leaves:
        raise ValueError("Map requires at least one vectorized argument")
    return int(jnp.shape(leaves[0])[0])


class MapCombinator(GenerativeFunction):
    """``MapCombinator(kernel)``: args are pytrees whose leaves have a
    leading element axis; the kernel is applied independently per element."""

    def __init__(self, kernel: GenerativeFunction):
        self.kernel = kernel

    # structural equality: ``Map(f)`` built inline in a model body creates
    # a fresh instance on every body replay, and the instance rides in
    # trace treedef aux — identity equality would make two traces of the
    # SAME model structurally different pytrees (breaks scan carries,
    # jit cache, tree_map over traces)
    def __eq__(self, other):
        return type(other) is type(self) and other.kernel == self.kernel

    def __hash__(self):
        return hash((type(self), self.kernel))

    def __repr__(self):
        return f"Map({self.kernel!r})"

    def has_argument_grads(self):
        return self.kernel.has_argument_grads()

    def accepts_output_grad(self) -> bool:
        return True

    # -- helpers ----------------------------------------------------------

    def _make_trace(self, args, subtraces, length):
        score = jnp.sum(subtraces.get_score())
        retval = subtraces.get_retval()
        return MapTrace(self, args, subtraces, score, retval, length)

    # -- GFI --------------------------------------------------------------

    def simulate(self, key, args: Tuple) -> MapTrace:
        n = _length_of(args)
        keys = jax.random.split(key, n)
        subtraces = jax.vmap(lambda k, a: self.kernel.simulate(k, a))(
            keys, args)
        return self._make_trace(args, subtraces, n)

    def generate(self, key, args: Tuple, constraints: ChoiceMap = None):
        n = _length_of(args)
        kind, payload = try_densify(constraints, n)
        if kind == "sparse":
            # lower onto ONE masked-dense vmapped generate when stackable
            dense = densify_masked(payload, n)
            if dense is not None:
                kind, payload = "dense", dense
        keys = jax.random.split(key, n)
        if kind == "empty":
            subtraces = jax.vmap(lambda k, a: self.kernel.simulate(k, a))(
                keys, args)
            return self._make_trace(args, subtraces, n), jnp.asarray(0.0)
        if kind == "dense":
            subtraces, weights = jax.vmap(
                lambda k, a, c: self.kernel.generate(k, a, c))(
                    keys, args, payload.inner)
            return self._make_trace(args, subtraces, n), jnp.sum(weights)
        # sparse: per-element loop at trace time, stack results
        subs, weights = [], []
        for i in range(n):
            sub, w = self.kernel.generate(
                keys[i], tree_index(args, i), payload.get(i, ChoiceMap()))
            subs.append(sub)
            weights.append(w)
        subtraces = tree_stack(subs)
        return self._make_trace(args, subtraces, n), sum(weights)

    def assess(self, args: Tuple, choices: ChoiceMap):
        n = _length_of(args)
        kind, payload = try_densify(choices, n)
        if kind != "dense":
            raise ValueError("Map.assess requires choices for every element")
        weights, retvals = jax.vmap(
            lambda a, c: self.kernel.assess(a, c))(args, payload.inner)
        return jnp.sum(weights), retvals

    def project(self, trace: MapTrace, selection: Selection):
        return trace.project(selection)

    def update(self, key, trace: MapTrace, args: Tuple, argdiffs: Tuple,
               constraints: ChoiceMap):
        n = _length_of(args)
        keys = jax.random.split(key, n) if key is not None else [None] * n
        kind, payload = try_densify(constraints, n)
        lowered = False
        if kind == "sparse" and n == trace.length:
            dense = densify_masked(payload, n)
            if dense is not None:
                kind, payload, lowered = "dense", dense, True
        if n == trace.length and kind in ("empty", "dense"):
            cons_inner = (payload.inner if kind == "dense"
                          else ChoiceMap())
            in_axes = (None if key is None else 0, 0, 0,
                       0 if kind == "dense" else None)

            def one(k, prev, a, c):
                new_sub, w, _, d = self.kernel.update(
                    k, prev, a, all_unknown_change(a), c)
                return new_sub, w, d

            key_arg = None if key is None else jnp.asarray(keys)
            new_subs, weights, discards = jax.vmap(one, in_axes=in_axes)(
                key_arg, trace.subtraces, args, cons_inner)
            discard = (VectorChoiceMap(discards, n)
                       if not discards.is_empty() else ChoiceMap())
            if lowered and not discards.is_empty():
                # unmask the discard back to sparse plain values (reference
                # discard semantics) — flags are concrete at trace time
                sparse_d = sparsify_masked(discards, n)
                if sparse_d is not None:
                    discard = sparse_d
            return (self._make_trace(args, new_subs, n), jnp.sum(weights),
                    UnknownChange, discard)
        # sparse or length-changing path: trace-time loop
        new_subs, weights = [], []
        discard = ChoiceMap()
        weight = jnp.asarray(0.0)
        for i in range(n):
            a_i = tree_index(args, i)
            c_i = (payload.get(i, ChoiceMap()) if kind == "sparse"
                   else (payload.get_submap(i) if kind == "dense"
                         else ChoiceMap()))
            if i < trace.length:
                sub, w, _, d = self.kernel.update(
                    keys[i], trace.get_subtrace(i), a_i,
                    all_unknown_change(a_i), c_i)
                if not d.is_empty():
                    discard.set_submap(i, d)
            else:
                sub, w = self.kernel.generate(keys[i], a_i, c_i)
            new_subs.append(sub)
            weight = weight + w
        # deleted elements (n < prev length): subtract scores, discard choices
        for i in range(n, trace.length):
            old = trace.get_subtrace(i)
            weight = weight - old.get_score()
            ch = old.get_choices()
            if not ch.is_empty():
                discard.set_submap(i, ch)
        subtraces = tree_stack(new_subs)
        return (self._make_trace(args, subtraces, n), weight, UnknownChange,
                discard)

    def regenerate(self, key, trace: MapTrace, args: Tuple, argdiffs: Tuple,
                   selection: Selection):
        n = _length_of(args)
        if n != trace.length:
            raise NotImplementedError(
                "Map.regenerate with length change: use update")
        keys = jax.random.split(key, n)
        if isinstance(selection, (AllSelection, EmptySelection)):
            shared, masked = selection, None
        else:
            # lower per-element subselections onto one vmappable form:
            # a shared closed-over subselection when uniform, a batched
            # MaskedSelection when element-varying (gen_tpu.selection)
            from ..selection import batch_selections
            try:
                shared, masked = batch_selections(
                    [selection.subselection(i) for i in range(n)])
            except NotImplementedError:
                shared = masked = None
        if shared is not None:
            def one(k, prev, a):
                new_sub, w, _ = self.kernel.regenerate(
                    k, prev, a, all_unknown_change(a), shared)
                return new_sub, w
            new_subs, weights = jax.vmap(one)(keys, trace.subtraces, args)
            return (self._make_trace(args, new_subs, n), jnp.sum(weights),
                    UnknownChange)
        if masked is not None:
            def one_m(k, prev, a, s):
                new_sub, w, _ = self.kernel.regenerate(
                    k, prev, a, all_unknown_change(a), s)
                return new_sub, w
            new_subs, weights = jax.vmap(one_m)(keys, trace.subtraces, args,
                                                masked)
            return (self._make_trace(args, new_subs, n), jnp.sum(weights),
                    UnknownChange)
        # dynamic-membership selections: per-element fallback
        new_subs, weight = [], jnp.asarray(0.0)
        for i in range(n):
            sub, w, _ = self.kernel.regenerate(
                keys[i], trace.get_subtrace(i), tree_index(args, i),
                all_unknown_change(tree_index(args, i)),
                selection.subselection(i))
            new_subs.append(sub)
            weight = weight + w
        return (self._make_trace(args, tree_stack(new_subs), n), weight,
                UnknownChange)


def Map(kernel: GenerativeFunction) -> MapCombinator:
    return MapCombinator(kernel)
