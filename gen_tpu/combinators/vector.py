"""Vectorized choice maps: integer-keyed hierarchies stored as batched
arrays.

array-native analogue of Gen.jl's ``InternalVectorChoiceMap``
(/root/reference/src/choice_map.jl:820-877) and ``VectorTrace``
(/root/reference/src/modeling_library/vector.jl). Instead of N per-element
tries, a :class:`VectorChoiceMap` holds ONE inner choice map whose leaves
carry a leading length-N axis — the representation ``vmap``/``scan``
produce and consume natively, so Map/Unfold constraints and discards never
materialize per-element Python structures on the hot path."""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..address import addr_head_rest
from ..choice_map import ChoiceMap


class VectorChoiceMap(ChoiceMap):
    """Top-level integer keys 0..length-1; element i's submap is the inner
    map with every leaf indexed at i."""

    __slots__ = ("inner", "length")

    def __init__(self, inner: ChoiceMap, length: int):
        super().__init__()
        self.inner = inner
        self.length = int(length)

    # -- queries ----------------------------------------------------------

    def is_empty(self) -> bool:
        return self.length == 0 or self.inner.is_empty()

    def _check_head(self, head) -> bool:
        return isinstance(head, (int, jnp.integer)) and 0 <= head < self.length

    def has_value(self, addr) -> bool:
        head, rest = addr_head_rest(addr)
        if not self._check_head(head) or rest == ():
            return False
        return self.inner.has_value(rest)

    def get_value(self, addr):
        head, rest = addr_head_rest(addr)
        if not self._check_head(head) or rest == ():
            raise KeyError(f"no value at {addr!r}")
        v = self.inner.get_value(rest)
        return jax.tree_util.tree_map(lambda x: x[head], v)

    def get_submap(self, addr) -> ChoiceMap:
        head, rest = addr_head_rest(addr)
        if not self._check_head(head):
            return ChoiceMap()
        sub = jax.tree_util.tree_map(lambda x: x[head], self.inner)
        if rest == ():
            return sub
        return sub.get_submap(rest)

    def get_values_shallow(self):
        return {}

    def get_submaps_shallow(self):
        return {i: self.get_submap(i) for i in range(self.length)}

    def addresses(self):
        for i in range(self.length):
            for rest in self.inner.addresses():
                yield (i,) + rest

    def leaf_items(self):
        for path in self.addresses():
            yield path, self.get_value(path)

    def set_value(self, addr, value):
        raise TypeError("VectorChoiceMap is immutable; build via vector_choicemap()")

    def set_submap(self, addr, submap):
        raise TypeError("VectorChoiceMap is immutable; build via vector_choicemap()")

    def copy(self):
        return VectorChoiceMap(self.inner.copy(), self.length)

    def filter(self, selection):
        # Fast paths; address-wise selections fall back to materialization.
        from ..selection import AllSelection, EmptySelection
        if isinstance(selection, AllSelection):
            return self
        if isinstance(selection, EmptySelection):
            return ChoiceMap()
        return self.to_choicemap().filter(selection)

    def merge(self, other: ChoiceMap, overwrite: bool = False) -> ChoiceMap:
        return self.to_choicemap().merge(other, overwrite=overwrite)

    def to_choicemap(self) -> ChoiceMap:
        """Materialize as an ordinary int-keyed ChoiceMap (host-side view)."""
        out = ChoiceMap()
        for i in range(self.length):
            sub = self.get_submap(i)
            if not sub.is_empty():
                out.set_submap(i, sub)
        return out

    def __repr__(self):
        return f"VectorChoiceMap(length={self.length}, inner={self.inner!r})"


def _vchm_flatten(v: VectorChoiceMap):
    return (v.inner,), (v.length,)


def _vchm_unflatten(aux, children):
    return VectorChoiceMap(children[0], aux[0])


jax.tree_util.register_pytree_node(
    VectorChoiceMap, _vchm_flatten, _vchm_unflatten)


def vector_choicemap(length: int, inner: ChoiceMap = None, **kwargs
                     ) -> VectorChoiceMap:
    """Build a dense vectorized constraint: ``vector_choicemap(T, y=obs)``
    constrains address (t, "y") to obs[t] for every t."""
    if inner is None:
        inner = ChoiceMap()
    for k, val in kwargs.items():
        inner.set_value(k, jnp.asarray(val))
    return VectorChoiceMap(inner, length)


def try_densify(constraints: ChoiceMap, length: int):
    """Classify constraints for a vector combinator.

    Returns one of:
      ("empty", None)            — no constraints
      ("dense", VectorChoiceMap) — same structure at every index 0..N-1
      ("sparse", dict)           — {index: ChoiceMap} (host-side slow path)
    """
    if isinstance(constraints, VectorChoiceMap):
        if constraints.length != length:
            raise ValueError(
                f"constraint length {constraints.length} != combinator length {length}")
        return ("dense", constraints)
    if constraints is None or constraints.is_empty():
        return ("empty", None)
    if constraints.get_values_shallow():
        raise ValueError(
            "vector combinator constraints must use integer-keyed submaps")
    subs = constraints.get_submaps_shallow()
    for k in subs:
        if not isinstance(k, (int, jnp.integer)) or not 0 <= k < length:
            raise ValueError(
                f"vector combinator constraint key {k!r} out of range [0, {length})")
    if len(subs) == length:
        structures = {
            jax.tree_util.tree_structure(subs[i]) for i in range(length)}
        if len(structures) == 1:
            stacked = jax.tree_util.tree_map(
                lambda *xs: jnp.stack([jnp.asarray(x) for x in xs]),
                *[subs[i] for i in range(length)])
            return ("dense", VectorChoiceMap(stacked, length))
    return ("sparse", dict(subs))


def densify_masked(subs: dict, length: int):
    """Lower sparse per-index constraints ``{index: ChoiceMap}`` onto ONE
    dense VectorChoiceMap whose leaves are :class:`gen_tpu.masked
    .MaskedValue` stacks over the union of constrained paths — presence
    becomes a per-lane flag vector, so a vector combinator can run a single
    vmapped/scanned generate/update instead of an O(N)-body trace-time
    loop. Returns None when the per-index maps are not stackable
    (heterogeneous shapes/dtypes, nested submaps, or already-masked
    values) — callers fall back to their loop."""
    import numpy as np
    from ..masked import MaskedValue
    maps = [subs.get(i, ChoiceMap()) for i in range(length)]
    paths, seen = [], set()
    try:
        for m in maps:
            for p, v in m.leaf_items():
                if isinstance(v, MaskedValue):
                    return None
                if p not in seen:
                    seen.add(p)
                    paths.append(p)
        if not paths:
            return None
        inner = ChoiceMap()
        for p in paths:
            donors = [i for i in range(length) if maps[i].has_value(p)]
            proto = jnp.asarray(maps[donors[0]].get_value(p))
            vals = jnp.stack([
                jnp.asarray(maps[i].get_value(p)) if maps[i].has_value(p)
                else jnp.zeros_like(proto) for i in range(length)])
            flags = jnp.asarray(np.asarray(
                [maps[i].has_value(p) for i in range(length)]))
            inner.set_value(p, MaskedValue(vals, flags))
    except (ValueError, TypeError):
        return None
    return VectorChoiceMap(inner, length)


def sparsify_masked(inner: ChoiceMap, length: int):
    """Inverse of :func:`densify_masked` for trace time: a stacked discard
    map whose leaves are MaskedValue((N,)+shape, (N,) flags) (or plain
    stacked values) becomes an int-keyed ChoiceMap holding plain values at
    exactly the flagged indices — reference discard semantics. Requires
    concrete flags; returns None under tracing (caller keeps the masked
    form)."""
    import numpy as np
    from ..masked import MaskedValue
    out = ChoiceMap()
    try:
        for p, v in inner.leaf_items():
            if isinstance(v, MaskedValue):
                flags = np.asarray(v.flag)
                vals = v.value
            else:
                flags = np.ones(length, bool)
                vals = v
            for i in range(length):
                if flags[i]:
                    out.set_value((i,) + p, vals[i])
    except (jax.errors.TracerArrayConversionError,
            jax.errors.ConcretizationTypeError):
        return None
    return out


def tree_stack(items):
    """Stack a list of identically-structured pytrees along a new axis 0."""
    return jax.tree_util.tree_map(
        lambda *xs: jnp.stack([jnp.asarray(x) for x in xs]), *items)


def tree_index(tree, i):
    """Element i of a batched pytree."""
    return jax.tree_util.tree_map(lambda x: x[i], tree)
