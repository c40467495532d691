"""Effect handlers: one per GFI operation.

The accelerator-native replacement for Gen.jl's handler-state interpreter
(/root/reference/src/dynamic/dynamic.jl:69-158 and the per-operation
``traceat`` methods in simulate.jl/generate.jl/update.jl/regenerate.jl/
assess.jl). A model body is plain Python + jnp code; every ``dist(args) @
"addr"`` or ``trace(addr, fn, *args)`` call dispatches to the innermost
active handler. Because handlers only read/write traced *values* (never
traced control flow), running any GFI method under ``jax.jit`` stages the
entire model into one XLA computation — the interpreter overhead exists only
at trace time, which is the analogue of Gen's static-IR code generation
happening "for free".

Randomness: each handler threads an explicit ``jax.random`` key, split once
per traced call in execution order.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import jax
import jax.numpy as jnp

from ..address import Address, addr_path
from ..choice_map import ChoiceMap
from ..diff import all_unknown_change
from ..dists.distribution import Distribution
from ..selection import NONE, Selection
from .trace import CallRecord, ChoiceRecord

_STACK: List["Handler"] = []

# -- distribution-call recorder (support discovery for mixed-model
#    inference, gen_tpu/inference/mixed.py). When active, every dist call
#    anywhere in the execution (including inside combinators' vmapped
#    inner calls — the inner dynamic fn builds its own handler while the
#    recorder's prefix stack still holds the outer call path) is recorded
#    as (full-known-path, dist, args). Combinator-inserted integer keys
#    are absent from the recorded path; consumers match on int-stripped
#    paths. ------------------------------------------------------------


class _DistRecorder:
    __slots__ = ("prefix", "records")

    def __init__(self):
        self.prefix: List[Tuple] = []
        self.records: List[Tuple[Tuple, Distribution, Tuple]] = []

    def full(self, path: Tuple) -> Tuple:
        out: Tuple = ()
        for p in self.prefix:
            out = out + p
        return out + path


_RECORDER: List[_DistRecorder] = []   # at most one active


class record_dist_calls:
    """Context manager: record every distribution call executed inside.
    ``.records`` afterwards holds (path, dist, args) triples; paths omit
    combinator-inserted integer keys."""

    def __enter__(self):
        self._rec = _DistRecorder()
        _RECORDER.append(self._rec)
        return self._rec

    def __exit__(self, *exc):
        assert _RECORDER[-1] is self._rec
        _RECORDER.pop()
        return False


def active_handler() -> "Handler":
    if not _STACK:
        raise RuntimeError(
            "No active handler: traced calls like `dist(args) @ \"addr\"` are "
            "only legal inside a generative function body being executed by a "
            "GFI method (simulate/generate/...).")
    return _STACK[-1]


def trace_at(addr: Address, fn, *args):
    """Trace a call to a distribution or generative function at an address —
    the explicit form of ``fn(args) @ addr``."""
    return active_handler().handle(addr_path(addr), fn, args)


class Call:
    """The object returned by ``fn(*args)`` inside a model body; ``@ addr``
    performs the traced call (tilde-sugar analogue, reference
    src/dsl/dsl.jl:86-104)."""

    __slots__ = ("fn", "args")

    def __init__(self, fn, args):
        self.fn = fn
        self.args = args

    def __matmul__(self, addr: Address):
        return trace_at(addr, self.fn, *self.args)

    def __repr__(self):
        return f"Call({self.fn!r}, {self.args!r}) — did you forget `@ \"addr\"`?"


class AddressVisitor:
    """Duplicate/conflicting-address detection (reference
    src/dynamic/dynamic.jl:116-127)."""

    __slots__ = ("paths", "_prefixes")

    def __init__(self):
        self.paths = set()
        self._prefixes = set()

    def visit(self, path: Tuple):
        if path in self.paths:
            raise ValueError(f"address {path!r} visited twice")
        if path in self._prefixes:
            raise ValueError(
                f"address {path!r} conflicts with a longer address already traced")
        for i in range(1, len(path)):
            if path[:i] in self.paths:
                raise ValueError(
                    f"address {path!r} conflicts with shorter address {path[:i]!r}")
        self.paths.add(path)
        for i in range(1, len(path)):
            self._prefixes.add(path[:i])

    def covers(self, path: Tuple) -> bool:
        """True if `path` was visited exactly or lies under a visited call."""
        if path in self.paths:
            return True
        return any(path[:i] in self.paths for i in range(1, len(path)))


def _sel_at_path(sel: Selection, path: Tuple) -> Selection:
    for k in path:
        sel = sel.subselection(k)
    return sel


class Handler:
    """Base handler: key threading, param resolution, dispatch."""

    def __init__(self, key, params: Dict[str, Any]):
        self.key = key
        self.visitor = AddressVisitor()
        self.params_stack: List[Dict[str, Any]] = [params]

    def __enter__(self):
        _STACK.append(self)
        return self

    def __exit__(self, *exc):
        assert _STACK[-1] is self
        _STACK.pop()
        return False

    def _next_key(self):
        if self.key is None:
            raise RuntimeError(
                f"{type(self).__name__} has no PRNG key but the model tried to "
                "sample (an address was neither constrained nor retained)")
        self.key, sub = jax.random.split(self.key)
        return sub

    def _maybe_key(self):
        """Key for a nested GFI call: None propagates (the callee raises
        only if it actually needs to sample)."""
        return None if self.key is None else self._next_key()

    def get_param(self, name: str):
        params = self.params_stack[-1]
        if name not in params:
            raise KeyError(
                f"trainable parameter {name!r} not initialized; call "
                f"init_param(fn, {name!r}, value) first")
        return params[name]

    def splice(self, fn, args):
        """Run another gen fn's body inline, splicing its choices into this
        handler's address space (reference src/dynamic/dynamic.jl:90-103)."""
        from .params import current_params
        self.params_stack.append(current_params(fn))
        try:
            return fn.run_body(args)
        finally:
            self.params_stack.pop()

    def handle(self, path: Tuple, fn, args):
        self.visitor.visit(path)
        if isinstance(fn, Distribution):
            if _RECORDER:
                rec = _RECORDER[-1]
                rec.records.append((rec.full(path), fn, args))
            return self.handle_dist(path, fn, args)
        if _RECORDER:
            rec = _RECORDER[-1]
            rec.prefix.append(path)
            try:
                return self.handle_call(path, fn, args)
            finally:
                rec.prefix.pop()
        return self.handle_call(path, fn, args)

    def handle_dist(self, path, dist, args):
        raise NotImplementedError

    def handle_call(self, path, fn, args):
        raise NotImplementedError


class SimulateHandler(Handler):
    """Reference: src/dynamic/simulate.jl."""

    def __init__(self, key, params):
        super().__init__(key, params)
        self.records: Dict[Tuple, Any] = {}
        self.score = jnp.asarray(0.0)
        self.noise = jnp.asarray(0.0)

    def handle_dist(self, path, dist, args):
        v = dist.sample(self._next_key(), *args)
        s = dist.logpdf(v, *args)
        self.records[path] = ChoiceRecord(v, s)
        self.score = self.score + s
        return v

    def handle_call(self, path, fn, args):
        sub = fn.simulate(self._next_key(), args)
        noise = sub.project(NONE)
        self.records[path] = CallRecord(sub, noise)
        self.score = self.score + sub.get_score()
        self.noise = self.noise + noise
        return sub.get_retval()


class GenerateHandler(Handler):
    """Reference: src/dynamic/generate.jl (weight accumulates the scores of
    constrained choices and sub-generate weights)."""

    def __init__(self, key, constraints: ChoiceMap, params):
        super().__init__(key, params)
        self.constraints = constraints
        self.records: Dict[Tuple, Any] = {}
        self.score = jnp.asarray(0.0)
        self.noise = jnp.asarray(0.0)
        self.weight = jnp.asarray(0.0)

    def handle_dist(self, path, dist, args):
        from ..masked import MaskedValue
        constrained = self.constraints.has_value(path)
        if not constrained and self.constraints.has_submap(path):
            raise ValueError(
                f"constraints hold a submap at choice address {path!r}")
        if constrained:
            v = self.constraints.get_value(path)
            if isinstance(v, MaskedValue):
                # dynamically-present constraint: sample where absent,
                # weight only where present (gen_tpu.masked)
                flag = v.flag
                sampled = dist.sample(self._next_key(), *args)
                v = jnp.where(flag, jnp.asarray(v.value), sampled)
                s = dist.logpdf(v, *args)
                self.records[path] = ChoiceRecord(v, s)
                self.score = self.score + s
                self.weight = self.weight + jnp.where(flag, s, 0.0)
                return v
        else:
            v = dist.sample(self._next_key(), *args)
        s = dist.logpdf(v, *args)
        self.records[path] = ChoiceRecord(v, s)
        self.score = self.score + s
        if constrained:
            self.weight = self.weight + s
        return v

    def handle_call(self, path, fn, args):
        if self.constraints.has_value(path):
            raise ValueError(
                f"constraints hold a value at call address {path!r}")
        sub_constraints = self.constraints.get_submap(path)
        sub, w = fn.generate(self._maybe_key(), args, sub_constraints)
        noise = sub.project(NONE)
        self.records[path] = CallRecord(sub, noise)
        self.score = self.score + sub.get_score()
        self.noise = self.noise + noise
        self.weight = self.weight + w
        return sub.get_retval()


class AssessHandler(Handler):
    """Reference: src/dynamic/assess.jl — every addressed choice must be
    given; weight is the full joint logpdf. Key-free and differentiable;
    this is the workhorse for choice/param gradients (the analogue of the
    reference's ReverseDiff tape replay, src/dynamic/backprop.jl)."""

    def __init__(self, choices: ChoiceMap, params):
        super().__init__(None, params)
        self.choices = choices
        self.weight = jnp.asarray(0.0)

    def handle_dist(self, path, dist, args):
        if not self.choices.has_value(path):
            raise ValueError(
                f"assess: no value provided for choice at {path!r}")
        v = self.choices.get_value(path)
        self.weight = self.weight + dist.logpdf(v, *args)
        return v

    def handle_call(self, path, fn, args):
        w, retval = fn.assess(args, self.choices.get_submap(path))
        self.weight = self.weight + w
        return retval


class UpdateHandler(Handler):
    """Reference: src/dynamic/update.jl:19-120 (per-choice weight
    bookkeeping) — the deletion term and discard completion happen in
    ``GenFn.update``."""

    def __init__(self, key, prev_trace, constraints: ChoiceMap, params):
        super().__init__(key, params)
        self.prev = prev_trace
        self.constraints = constraints
        self.records: Dict[Tuple, Any] = {}
        self.discard = ChoiceMap()
        self.score = jnp.asarray(0.0)
        self.noise = jnp.asarray(0.0)
        self.weight = jnp.asarray(0.0)

    def handle_dist(self, path, dist, args):
        from ..masked import MaskedValue
        has_prev = self.prev.has_choice(path)
        constrained = self.constraints.has_value(path)
        if not constrained and self.constraints.has_submap(path):
            raise ValueError(
                f"constraints hold a submap at choice address {path!r}")
        if has_prev:
            prev_rec = self.prev.get_choice(path)
        cons_v = self.constraints.get_value(path) if constrained else None
        if isinstance(cons_v, MaskedValue):
            flag = cons_v.flag
            if has_prev:
                v = jnp.where(flag, jnp.asarray(cons_v.value), prev_rec.value)
                self.discard.set_value(path, MaskedValue(prev_rec.value,
                                                         flag))
                s = dist.logpdf(v, *args)
                self.weight = self.weight + s - prev_rec.score
            else:
                sampled = dist.sample(self._next_key(), *args)
                v = jnp.where(flag, jnp.asarray(cons_v.value), sampled)
                s = dist.logpdf(v, *args)
                self.weight = self.weight + jnp.where(flag, s, 0.0)
            self.records[path] = ChoiceRecord(v, s)
            self.score = self.score + s
            return v
        if constrained and has_prev:
            self.discard.set_value(path, prev_rec.value)
        if constrained:
            v = cons_v
        elif has_prev:
            v = prev_rec.value
        else:
            v = dist.sample(self._next_key(), *args)
        s = dist.logpdf(v, *args)
        if has_prev:
            self.weight = self.weight + s - prev_rec.score
        elif constrained:
            self.weight = self.weight + s
        self.records[path] = ChoiceRecord(v, s)
        self.score = self.score + s
        return v

    def handle_call(self, path, fn, args):
        if self.constraints.has_value(path):
            raise ValueError(
                f"constraints hold a value at call address {path!r}")
        sub_constraints = self.constraints.get_submap(path)
        if self.prev.has_call(path):
            prev_sub = self.prev.get_call(path).subtrace
            sub, w, _, sub_discard = fn.update(
                self._maybe_key(), prev_sub, args, all_unknown_change(args),
                sub_constraints)
            if not sub_discard.is_empty():
                self.discard.set_submap(path, sub_discard)
        else:
            sub, w = fn.generate(self._maybe_key(), args, sub_constraints)
        noise = sub.project(NONE)
        self.records[path] = CallRecord(sub, noise)
        self.score = self.score + sub.get_score()
        self.noise = self.noise + noise
        self.weight = self.weight + w
        return sub.get_retval()


class RegenerateHandler(Handler):
    """Reference: src/dynamic/regenerate.jl:17-93 — selected choices are
    resampled from the prior (weight contribution cancels); unselected
    retained choices contribute score − prev_score."""

    def __init__(self, key, prev_trace, selection: Selection, params):
        super().__init__(key, params)
        self.prev = prev_trace
        self.selection = selection
        self.records: Dict[Tuple, Any] = {}
        self.score = jnp.asarray(0.0)
        self.noise = jnp.asarray(0.0)
        self.weight = jnp.asarray(0.0)

    def handle_dist(self, path, dist, args):
        from ..masked import MaskedSelection
        has_prev = self.prev.has_choice(path)
        if isinstance(self.selection, MaskedSelection):
            # traced membership: resample where the flag is true, keep and
            # re-score otherwise — one branchless pass (gen_tpu.masked)
            flag = self.selection.flag_at(path)
            if has_prev:
                prev_rec = self.prev.get_choice(path)
                sampled = dist.sample(self._next_key(), *args)
                v = jnp.where(flag, sampled, prev_rec.value)
                s = dist.logpdf(v, *args)
                self.weight = self.weight + jnp.where(
                    flag, 0.0, s - prev_rec.score)
            else:
                v = dist.sample(self._next_key(), *args)
                s = dist.logpdf(v, *args)
            self.records[path] = ChoiceRecord(v, s)
            self.score = self.score + s
            return v
        in_sel = path in self.selection
        if has_prev and not in_sel:
            prev_rec = self.prev.get_choice(path)
            v = prev_rec.value
        else:
            v = dist.sample(self._next_key(), *args)
        s = dist.logpdf(v, *args)
        if has_prev and not in_sel:
            self.weight = self.weight + s - prev_rec.score
        self.records[path] = ChoiceRecord(v, s)
        self.score = self.score + s
        return v

    def handle_call(self, path, fn, args):
        subsel = _sel_at_path(self.selection, path)
        if self.prev.has_call(path):
            prev_sub = self.prev.get_call(path).subtrace
            sub, w, _ = fn.regenerate(
                self._maybe_key(), prev_sub, args, all_unknown_change(args),
                subsel)
        else:
            sub, w = fn.generate(self._maybe_key(), args, ChoiceMap())
        noise = sub.project(NONE)
        self.records[path] = CallRecord(sub, noise)
        self.score = self.score + sub.get_score()
        self.noise = self.noise + noise
        self.weight = self.weight + w
        return sub.get_retval()
