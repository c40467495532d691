"""Change metadata ("diffs") threaded through incremental GFI operations.

Analogue of Gen.jl's diff system (/root/reference/src/diff.jl:32-417). In the
JAX rebuild diffs play a smaller role: under ``jit`` XLA's common
subexpression elimination and dead-code elimination recover most of what
Gen's Julia-side incremental recomputation buys. Diffs still matter as
*static* signals to combinators — e.g. Unfold's O(1) extension fast path
keys on an ``IntDiff`` of the length argument, and ``NoChange`` on args lets
``update`` skip re-scoring unaffected subtraces at Python trace time.
"""

from __future__ import annotations


class Diff:
    """Abstract change hint for a value between two GFI calls."""


class _NoChange(Diff):
    def __repr__(self):
        return "NoChange()"


class _UnknownChange(Diff):
    def __repr__(self):
        return "UnknownChange()"


NoChange = _NoChange()
UnknownChange = _UnknownChange()


class IntDiff(Diff):
    """An integer changed by a known amount (Gen: diff.jl ``IntDiff``)."""

    def __init__(self, difference: int):
        self.difference = difference

    def __repr__(self):
        return f"IntDiff({self.difference})"


class VectorDiff(Diff):
    """A vector changed length and/or some elements changed
    (Gen: /root/reference/src/diff.jl VectorDiff)."""

    def __init__(self, new_length: int, prev_length: int, updated: dict):
        self.new_length = new_length
        self.prev_length = prev_length
        self.updated = updated  # index -> element Diff

    def __repr__(self):
        return (f"VectorDiff(new={self.new_length}, prev={self.prev_length}, "
                f"updated={self.updated})")


class SetDiff(Diff):
    def __init__(self, added, deleted):
        self.added = added
        self.deleted = deleted


class DictDiff(Diff):
    def __init__(self, added, deleted, updated):
        self.added = added
        self.deleted = deleted
        self.updated = updated


class Diffed:
    """A value paired with its diff (Gen's ``Diffed{V,DV}``), with the
    reference's arithmetic/indexing propagation rules (diff.jl:160-417):
    any operation on a Diffed whose diff is not NoChange yields
    UnknownChange; NoChange inputs propagate NoChange."""

    def __init__(self, value, diff: Diff):
        self.value = value
        self.diff = diff

    def __repr__(self):
        return f"Diffed({self.value!r}, {self.diff!r})"

    @staticmethod
    def _combine(*xs) -> Diff:
        ds = [get_diff(x) for x in xs]
        if all(isinstance(d, _NoChange) for d in ds):
            return NoChange
        return UnknownChange

    def _binop(self, other, op):
        return Diffed(op(self.value, strip_diff(other)),
                      Diffed._combine(self, other))

    def __add__(self, o):
        return self._binop(o, lambda a, b: a + b)

    def __radd__(self, o):
        return self._binop(o, lambda a, b: b + a)

    def __sub__(self, o):
        return self._binop(o, lambda a, b: a - b)

    def __rsub__(self, o):
        return self._binop(o, lambda a, b: b - a)

    def __mul__(self, o):
        return self._binop(o, lambda a, b: a * b)

    def __rmul__(self, o):
        return self._binop(o, lambda a, b: b * a)

    def __truediv__(self, o):
        return self._binop(o, lambda a, b: a / b)

    def __getitem__(self, idx):
        return Diffed(self.value[strip_diff(idx)],
                      Diffed._combine(self, idx))

    def __len__(self):
        return len(self.value)


def strip_diff(x):
    return x.value if isinstance(x, Diffed) else x


def get_diff(x) -> Diff:
    return x.diff if isinstance(x, Diffed) else NoChange


def no_change(argdiffs) -> bool:
    """True when every argdiff is NoChange."""
    return all(isinstance(d, _NoChange) for d in argdiffs)


def all_no_change(args) -> tuple:
    return tuple(NoChange for _ in args)


def all_unknown_change(args) -> tuple:
    return tuple(UnknownChange for _ in args)
