"""Unfold combinator: a Markov chain of kernel applications.

Reference: /root/reference/src/modeling_library/unfold/ (530 LoC; kernel
signature ``(t, state, params...) -> state``, args ``(T, init_state,
params...)``, choices of step t under integer key t).

Design: the chain is ONE ``lax.scan`` — simulate/generate/
update/assess for T steps compile to a single fused XLA loop with the trace
stored time-major (leaves shaped (T, ...)). The reference's incremental
"only revisit dirty steps" logic (unfold/update.jl:22-113) is replaced by
re-running the scan under `update` semantics: per-step weights are
score-differences, so retained steps with unchanged inputs contribute
exactly 0, preserving the weight formula while staying a dense,
recompilation-free program. The O(1) trace-extension fast path for particle
filtering (argdiff = IntDiff on T, constraints only at new steps) runs the
kernel only on the appended steps."""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from ..choice_map import ChoiceMap
from ..diff import IntDiff, NoChange, UnknownChange
from ..gfi import GenerativeFunction, Trace
from ..selection import AllSelection, EmptySelection, Selection
from .vector import (VectorChoiceMap, densify_masked, sparsify_masked,
                     try_densify, tree_index, tree_stack)


class UnfoldTrace(Trace):
    __slots__ = ("gen_fn", "args", "subtraces", "score", "retval", "length")

    def __init__(self, gen_fn, args, subtraces, score, retval, length):
        self.gen_fn = gen_fn
        self.args = args
        self.subtraces = subtraces  # batched over the time axis
        self.score = score
        self.retval = retval        # stacked states, leaves (T, ...)
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
        return VectorChoiceMap(self.subtraces.get_choices(), self.length)

    def get_subtrace(self, t):
        return tree_index(self.subtraces, t)

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
        if isinstance(selection, (EmptySelection, AllSelection)):
            return jnp.sum(jax.vmap(lambda tr: tr.project(selection))(
                self.subtraces))
        from ..selection import batch_selections
        try:
            shared, masked = batch_selections(
                [selection.subselection(t) for t in range(self.length)])
        except NotImplementedError:
            shared = masked = None
        if shared is not None:
            return jnp.sum(jax.vmap(lambda tr: tr.project(shared))(
                self.subtraces))
        if masked is not None:
            return jnp.sum(jax.vmap(lambda tr, s: tr.project(s))(
                self.subtraces, masked))
        total = jnp.asarray(0.0)
        for t in range(self.length):
            total = total + self.get_subtrace(t).project(
                selection.subselection(t))
        return total


def _unfoldtrace_flatten(tr: UnfoldTrace):
    from ..utils import split_static
    args_dyn, args_aux = split_static(tr.args)
    return ((args_dyn, tr.subtraces, tr.score, tr.retval),
            (tr.gen_fn, tr.length, args_aux))


def _unfoldtrace_unflatten(aux, children):
    from ..utils import join_static
    gen_fn, length, args_aux = aux
    args_dyn, subtraces, score, retval = children
    return UnfoldTrace(gen_fn, join_static(args_dyn, args_aux), subtraces,
                    score, retval, length)


jax.tree_util.register_pytree_node(
    UnfoldTrace, _unfoldtrace_flatten, _unfoldtrace_unflatten)


class UnfoldCombinator(GenerativeFunction):
    """``UnfoldCombinator(kernel)``; args = (T, init_state, *params)."""

    def __init__(self, kernel: GenerativeFunction):
        self.kernel = kernel

    # structural equality (see MapCombinator.__eq__): inline-constructed
    # combinators must compare equal across model-body replays
    def __eq__(self, other):
        return type(other) is type(self) and other.kernel == self.kernel

    def __hash__(self):
        return hash((type(self), self.kernel))

    def __repr__(self):
        return f"Unfold({self.kernel!r})"

    def accepts_output_grad(self) -> bool:
        return True

    def has_argument_grads(self):
        return None

    # -- helpers ----------------------------------------------------------

    @staticmethod
    def _split_args(args: Tuple):
        length = args[0]
        if not isinstance(length, int):
            raise TypeError(
                "Unfold length must be a static Python int (it fixes the "
                "scan length / trace shape)")
        return length, args[1], tuple(args[2:])

    def _make_trace(self, args, subtraces, length):
        score = jnp.sum(subtraces.get_score())
        retval = subtraces.get_retval()
        return UnfoldTrace(self, args, subtraces, score, retval, length)

    def _scan_steps(self, init_state, params, length, body):
        """Run `body(t, state, xs_t) -> (subtrace_like, new_state, y)` as one
        lax.scan over t = 0..length-1."""
        ts = jnp.arange(length)

        def scan_body(state, inp):
            t, xs_t = inp
            sub, new_state, y = body(t, state, xs_t)
            return new_state, (sub, y)

        _, (subs, ys) = jax.lax.scan(scan_body, init_state, (ts, None))
        return subs, ys

    # -- GFI --------------------------------------------------------------

    def simulate(self, key, args: Tuple) -> UnfoldTrace:
        length, init_state, params = self._split_args(args)
        keys = jax.random.split(key, length)
        ts = jnp.arange(length)

        def body(state, inp):
            t, k = inp
            sub = self.kernel.simulate(k, (t, state) + params)
            return sub.get_retval(), sub

        _, subtraces = jax.lax.scan(body, init_state, (ts, keys))
        return self._make_trace(args, subtraces, length)

    def generate(self, key, args: Tuple, constraints: ChoiceMap = None):
        length, init_state, params = self._split_args(args)
        kind, payload = try_densify(constraints, length)
        if kind == "sparse":
            # lower onto ONE masked-dense scanned generate when stackable
            dense = densify_masked(payload, length)
            if dense is not None:
                kind, payload = "dense", dense
        keys = jax.random.split(key, length)
        ts = jnp.arange(length)

        if kind == "empty":
            trace = self.simulate(key, args)
            return trace, jnp.asarray(0.0)

        if kind == "dense":
            def body(state, inp):
                t, k, cons = inp
                sub, w = self.kernel.generate(k, (t, state) + params, cons)
                return sub.get_retval(), (sub, w)

            _, (subtraces, weights) = jax.lax.scan(
                body, init_state, (ts, keys, payload.inner))
            return self._make_trace(args, subtraces, length), jnp.sum(weights)

        # sparse: trace-time loop threading state
        subs, weight, state = [], jnp.asarray(0.0), init_state
        for t in range(length):
            sub, w = self.kernel.generate(
                keys[t], (jnp.asarray(t), state) + params,
                payload.get(t, ChoiceMap()))
            subs.append(sub)
            weight = weight + w
            state = sub.get_retval()
        return (self._make_trace(args, tree_stack(subs), length), weight)

    def assess(self, args: Tuple, choices: ChoiceMap):
        length, init_state, params = self._split_args(args)
        kind, payload = try_densify(choices, length)
        if kind != "dense":
            raise ValueError("Unfold.assess requires choices at every step")
        ts = jnp.arange(length)

        def body(state, inp):
            t, cons = inp
            w, retval = self.kernel.assess((t, state) + params, cons)
            return retval, (w, retval)

        _, (weights, retvals) = jax.lax.scan(
            body, init_state, (ts, payload.inner))
        return jnp.sum(weights), retvals

    def project(self, trace: UnfoldTrace, selection: Selection):
        return trace.project(selection)

    def update(self, key, trace: UnfoldTrace, args: Tuple, argdiffs: Tuple,
               constraints: ChoiceMap):
        length, init_state, params = self._split_args(args)
        prev_length = trace.length
        kind, payload = try_densify(constraints, length)
        keys = (jax.random.split(key, max(length, 1)) if key is not None
                else None)

        # O(1) extension fast path (particle filtering): same prefix args,
        # constraints only at the appended steps
        # (reference: unfold/update.jl extension handling +
        #  particle_filter.jl:162-180).
        if (length > prev_length and kind in ("sparse", "dense", "empty")
                and isinstance(argdiffs[0], IntDiff)
                and all(isinstance(d, type(NoChange)) for d in argdiffs[1:])):
            touched_old = (set(payload.keys()) if kind == "sparse" else
                           set(range(length)) if kind == "dense" else set())
            if not any(t < prev_length for t in touched_old):
                return self._extend(keys, trace, args, payload, kind)

        # general path: re-run everything under update semantics.
        # Sparse same-length constraints lower onto one masked-dense scan
        # (AFTER the extension check above — densifying first would hide
        # the O(1) extension pattern).
        lowered = False
        if kind == "sparse" and length == prev_length:
            dense = densify_masked(payload, length)
            if dense is not None:
                kind, payload, lowered = "dense", dense, True
        sub_argdiffs_tail = tuple(UnknownChange for _ in params)
        if kind in ("empty", "dense") and length == prev_length:
            ts = jnp.arange(length)

            def body(state, inp):
                t, k, prev_sub, cons = inp
                sub, w, _, d = self.kernel.update(
                    k, prev_sub, (t, state) + params,
                    (NoChange, UnknownChange) + sub_argdiffs_tail, cons)
                return sub.get_retval(), (sub, w, d)

            cons_xs = payload.inner if kind == "dense" else None
            if kind == "empty":
                def body_nc(state, inp):
                    t, k, prev_sub = inp
                    sub, w, _, d = self.kernel.update(
                        k, prev_sub, (t, state) + params,
                        (NoChange, UnknownChange) + sub_argdiffs_tail,
                        ChoiceMap())
                    return sub.get_retval(), (sub, w, d)
                _, (subs, weights, discards) = jax.lax.scan(
                    body_nc, init_state, (ts, keys, trace.subtraces))
            else:
                _, (subs, weights, discards) = jax.lax.scan(
                    body, init_state, (ts, keys, trace.subtraces, cons_xs))
            discard = (VectorChoiceMap(discards, length)
                       if not discards.is_empty() else ChoiceMap())
            if lowered and not discards.is_empty():
                sparse_d = sparsify_masked(discards, length)
                if sparse_d is not None:
                    discard = sparse_d
            return (self._make_trace(args, subs, length), jnp.sum(weights),
                    UnknownChange, discard)

        # trace-time loop (sparse constraints and/or length change)
        subs, weight, state = [], jnp.asarray(0.0), init_state
        discard = ChoiceMap()
        for t in range(length):
            c_t = (payload.get(t, ChoiceMap()) if kind == "sparse"
                   else payload.get_submap(t) if kind == "dense"
                   else ChoiceMap())
            k_t = keys[t] if keys is not None else None
            if t < prev_length:
                sub, w, _, d = self.kernel.update(
                    k_t, trace.get_subtrace(t), (jnp.asarray(t), state) + params,
                    (NoChange, UnknownChange) + sub_argdiffs_tail, c_t)
                if not d.is_empty():
                    discard.set_submap(t, d)
            else:
                sub, w = self.kernel.generate(
                    k_t, (jnp.asarray(t), state) + params, c_t)
            subs.append(sub)
            weight = weight + w
            state = sub.get_retval()
        for t in range(length, prev_length):
            old = trace.get_subtrace(t)
            weight = weight - old.get_score()
            ch = old.get_choices()
            if not ch.is_empty():
                discard.set_submap(t, ch)
        return (self._make_trace(args, tree_stack(subs), length), weight,
                UnknownChange, discard)

    def _extend(self, keys, trace: UnfoldTrace, args, payload, kind):
        """Append steps prev_length..length-1 without touching the prefix."""
        length, init_state, params = self._split_args(args)
        prev_length = trace.length
        state = (tree_index(trace.retval, prev_length - 1)
                 if prev_length > 0 else init_state)
        new_subs, weight = [], jnp.asarray(0.0)
        for t in range(prev_length, length):
            c_t = (payload.get(t, ChoiceMap()) if kind == "sparse"
                   else payload.get_submap(t) if kind == "dense"
                   else ChoiceMap())
            sub, w = self.kernel.generate(keys[t - prev_length],
                                          (jnp.asarray(t), state) + params, c_t)
            new_subs.append(sub)
            weight = weight + w
            state = sub.get_retval()
        appended = tree_stack(new_subs)
        subtraces = jax.tree_util.tree_map(
            lambda a, b: jnp.concatenate([jnp.asarray(a), jnp.asarray(b)]),
            trace.subtraces, appended)
        return (self._make_trace(args, subtraces, length), weight,
                UnknownChange, ChoiceMap())

    def regenerate(self, key, trace: UnfoldTrace, args: Tuple,
                   argdiffs: Tuple, selection: Selection):
        length, init_state, params = self._split_args(args)
        if length != trace.length:
            raise NotImplementedError(
                "Unfold.regenerate with length change: use update")
        keys = jax.random.split(key, length)
        sub_argdiffs = (NoChange, UnknownChange) + tuple(
            UnknownChange for _ in params)

        if isinstance(selection, (AllSelection, EmptySelection)):
            shared, masked = selection, None
        else:
            # lower per-step subselections onto one scannable form (shared
            # closed-over / batched MaskedSelection — gen_tpu.selection)
            from ..selection import batch_selections
            try:
                shared, masked = batch_selections(
                    [selection.subselection(t) for t in range(length)])
            except NotImplementedError:
                shared = masked = None
        if shared is not None or masked is not None:
            ts = jnp.arange(length)

            def body(state, inp):
                if masked is None:
                    t, k, prev_sub = inp
                    sel_t = shared
                else:
                    t, k, prev_sub, sel_t = inp
                sub, w, _ = self.kernel.regenerate(
                    k, prev_sub, (t, state) + params, sub_argdiffs, sel_t)
                return sub.get_retval(), (sub, w)

            xs = ((ts, keys, trace.subtraces) if masked is None
                  else (ts, keys, trace.subtraces, masked))
            _, (subs, weights) = jax.lax.scan(body, init_state, xs)
            return (self._make_trace(args, subs, length), jnp.sum(weights),
                    UnknownChange)

        subs, weight, state = [], jnp.asarray(0.0), init_state
        for t in range(length):
            sub, w, _ = self.kernel.regenerate(
                keys[t], trace.get_subtrace(t), (jnp.asarray(t), state) + params,
                sub_argdiffs, selection.subselection(t))
            subs.append(sub)
            weight = weight + w
            state = sub.get_retval()
        return (self._make_trace(args, tree_stack(subs), length), weight,
                UnknownChange)


def Unfold(kernel: GenerativeFunction) -> UnfoldCombinator:
    return UnfoldCombinator(kernel)
