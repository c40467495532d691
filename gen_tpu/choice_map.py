"""ChoiceMap: hierarchical address → value maps.

The universal currency for observations, constraints, proposed values, and
discards — the array-native analogue of Gen.jl's ``ChoiceMap``
(/root/reference/src/choice_map.jl). Two deliberate departures from the
reference:

* A ``ChoiceMap`` is a registered JAX pytree whose *structure* (the set of
  addresses) is static metadata and whose *leaf values* are traced arrays.
  Passing a choice map through ``jax.jit`` / ``jax.vmap`` therefore just
  works, and jit caches compile per address-structure automatically (the
  analogue of Gen's per-address-schema generated code,
  /root/reference/src/static_ir/generate.jl:30-37).

* ``to_array`` / ``from_array`` flatten leaves in deterministic sorted-key
  order (reference: /root/reference/src/choice_map.jl:163-225); this is how
  HMC/MALA/MAP see selected choices as flat vectors.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .address import Address, Key, addr_head_rest, sorted_keys


class ChoiceMap:
    """A mutable hierarchical map from addresses to values.

    Like Gen's ``Trie``-backed choice maps, each node has *leaves* (values at
    single keys) and *submaps* (nested choice maps). A key may hold a leaf or
    a submap, never both.
    """

    __slots__ = ("_leaves", "_subs")

    def __init__(self):
        self._leaves: Dict[Key, Any] = {}
        self._subs: Dict[Key, "ChoiceMap"] = {}

    # -- construction -----------------------------------------------------

    @staticmethod
    def from_dict(d: Dict) -> "ChoiceMap":
        """Build from a (possibly nested) dict. Nested dicts become submaps."""
        out = ChoiceMap()
        for k, v in d.items():
            if isinstance(v, dict):
                out.set_submap(k, ChoiceMap.from_dict(v))
            else:
                out.set_value(k, v)
        return out

    def copy(self) -> "ChoiceMap":
        out = ChoiceMap()
        out._leaves = dict(self._leaves)
        out._subs = {k: v.copy() for k, v in self._subs.items()}
        return out

    # -- queries ----------------------------------------------------------

    def is_empty(self) -> bool:
        return not self._leaves and all(s.is_empty() for s in self._subs.values())

    def has_value(self, addr: Address) -> bool:
        head, rest = addr_head_rest(addr)
        if rest == ():
            return head in self._leaves
        sub = self._subs.get(head)
        return sub is not None and sub.has_value(rest)

    def get_value(self, addr: Address):
        head, rest = addr_head_rest(addr)
        if rest == ():
            if head not in self._leaves:
                raise KeyError(f"no value at address {addr!r}")
            return self._leaves[head]
        sub = self._subs.get(head)
        if sub is None:
            raise KeyError(f"no value at address {addr!r}")
        return sub.get_value(rest)

    def get_submap(self, addr: Address) -> "ChoiceMap":
        head, rest = addr_head_rest(addr)
        if rest == ():
            return self._subs.get(head, _EMPTY)
        sub = self._subs.get(head)
        if sub is None:
            return _EMPTY
        return sub.get_submap(rest)

    def has_submap(self, addr: Address) -> bool:
        return not self.get_submap(addr).is_empty()

    def get_values_shallow(self) -> Dict[Key, Any]:
        return dict(self._leaves)

    def get_submaps_shallow(self) -> Dict[Key, "ChoiceMap"]:
        return {k: v for k, v in self._subs.items() if not v.is_empty()}

    def __getitem__(self, addr: Address):
        """Value access; descends through submaps like Gen's ``choices[addr]``."""
        return self.get_value(addr)

    def __contains__(self, addr: Address) -> bool:
        return self.has_value(addr)

    # -- mutation (host-side construction only) ---------------------------

    def set_value(self, addr: Address, value) -> "ChoiceMap":
        head, rest = addr_head_rest(addr)
        if rest == ():
            if head in self._subs:
                raise ValueError(f"address {addr!r} already holds a submap")
            self._leaves[head] = value
        else:
            if head in self._leaves:
                raise ValueError(f"address {head!r} already holds a value")
            sub = self._subs.get(head)
            if sub is None:
                sub = ChoiceMap()
                self._subs[head] = sub
            sub.set_value(rest, value)
        return self

    def set_submap(self, addr: Address, submap: "ChoiceMap") -> "ChoiceMap":
        head, rest = addr_head_rest(addr)
        if rest == ():
            if head in self._leaves:
                raise ValueError(f"address {addr!r} already holds a value")
            self._subs[head] = submap
        else:
            sub = self._subs.get(head)
            if sub is None:
                sub = ChoiceMap()
                self._subs[head] = sub
            sub.set_submap(rest, submap)
        return self

    # -- algebra ----------------------------------------------------------

    def merge(self, other: "ChoiceMap", overwrite: bool = False) -> "ChoiceMap":
        """Functional merge. With ``overwrite=False`` (Gen's ``merge``,
        /root/reference/src/choice_map.jl:237-266) duplicate leaf addresses
        raise; with ``overwrite=True`` (the ``t + u`` of the ``update``
        weight formula) ``other`` takes precedence."""
        if type(self) is ChoiceMap and self.is_empty():
            return other.copy()
        if type(other) is not ChoiceMap and hasattr(other, "to_choicemap"):
            other = other.to_choicemap()
        out = self.copy()
        for k, v in other._leaves.items():
            if k in out._leaves and not overwrite:
                raise ValueError(f"duplicate value at key {k!r} in merge")
            if k in out._subs:
                raise ValueError(f"key {k!r} holds a submap in one map, value in other")
            out._leaves[k] = v
        for k, sub in other._subs.items():
            if k in out._leaves:
                raise ValueError(f"key {k!r} holds a value in one map, submap in other")
            if k in out._subs:
                out._subs[k] = out._subs[k].merge(sub, overwrite=overwrite)
            else:
                out._subs[k] = sub.copy()
        return out

    def __add__(self, other: "ChoiceMap") -> "ChoiceMap":
        return self.merge(other)

    def __eq__(self, other) -> bool:
        if not isinstance(other, ChoiceMap):
            return NotImplemented
        if sorted_keys(self._leaves) != sorted_keys(other._leaves):
            return False
        for k, v in self._leaves.items():
            if not np.array_equal(np.asarray(v), np.asarray(other._leaves[k])):
                return False
        mine = self.get_submaps_shallow()
        theirs = other.get_submaps_shallow()
        if sorted_keys(mine) != sorted_keys(theirs):
            return False
        return all(mine[k] == theirs[k] for k in mine)

    def __hash__(self):
        raise TypeError("ChoiceMap is unhashable")

    def allclose(self, other: "ChoiceMap", rtol=1e-5, atol=1e-8) -> bool:
        """Approximate equality on values, exact on structure (Gen's
        ``isapprox`` on choice maps)."""
        if sorted_keys(self._leaves) != sorted_keys(other._leaves):
            return False
        for k, v in self._leaves.items():
            if not np.allclose(np.asarray(v), np.asarray(other._leaves[k]),
                               rtol=rtol, atol=atol):
                return False
        mine = self.get_submaps_shallow()
        theirs = other.get_submaps_shallow()
        if sorted_keys(mine) != sorted_keys(theirs):
            return False
        return all(mine[k].allclose(theirs[k], rtol=rtol, atol=atol) for k in mine)

    # -- iteration & flattening -------------------------------------------

    def addresses(self) -> Iterator[Tuple[Key, ...]]:
        """All full leaf addresses, in deterministic sorted order."""
        for k in sorted_keys(self._leaves):
            yield (k,)
        for k in sorted_keys(self._subs):
            for rest in self._subs[k].addresses():
                yield (k,) + rest

    def leaf_items(self) -> Iterator[Tuple[Tuple[Key, ...], Any]]:
        for path in self.addresses():
            yield path, self.get_value(path)

    def __len__(self) -> int:
        return sum(1 for _ in self.addresses())

    def to_array(self, dtype=None) -> jnp.ndarray:
        """Flatten all leaves into one vector in sorted-address order.

        Reference: /root/reference/src/choice_map.jl:163-186.
        """
        parts = [jnp.ravel(jnp.asarray(v)) for _, v in self.leaf_items()]
        if not parts:
            return jnp.zeros((0,), dtype=dtype or jnp.float32)
        flat = jnp.concatenate(parts)
        return flat.astype(dtype) if dtype is not None else flat

    def from_array(self, arr) -> "ChoiceMap":
        """Rebuild a choice map with this map's structure from a flat vector.

        Reference: /root/reference/src/choice_map.jl:210-225.
        """
        arr = jnp.asarray(arr)
        items = list(self.leaf_items())
        needed = sum(jnp.asarray(v).size for _, v in items)
        if needed != arr.shape[0]:
            raise ValueError(
                f"from_array: array has {arr.shape[0]} elements, structure needs {needed}")
        out = ChoiceMap()
        offset = 0
        for path, v in items:
            proto = jnp.asarray(v)
            n = proto.size
            piece = arr[offset:offset + n]
            out.set_value(path, piece.reshape(proto.shape).astype(proto.dtype))
            offset += n
        return out

    def as_dict(self) -> Dict:
        """Nested plain-dict view (Gen's ``nested_view``,
        /root/reference/src/choice_map.jl:900-989)."""
        d: Dict = {k: self._leaves[k] for k in self._leaves}
        for k, sub in self.get_submaps_shallow().items():
            d[k] = sub.as_dict()
        return d

    def filter(self, selection) -> "ChoiceMap":
        """Restrict to the addresses in ``selection`` (Gen's
        ``get_selected``, /root/reference/src/choice_map.jl:998-1013)."""
        out = ChoiceMap()
        for k, v in self._leaves.items():
            if (k,) in selection:
                out.set_value(k, v)
        for k, sub in self._subs.items():
            subsel = selection.subselection(k)
            fsub = sub.filter(subsel)
            if not fsub.is_empty():
                out.set_submap(k, fsub)
        return out

    def __repr__(self):
        items = ", ".join(f"{'.'.join(map(str, p))}={v!r}" for p, v in self.leaf_items())
        return f"ChoiceMap({items})"


_EMPTY = ChoiceMap()


def choicemap(*args, **kwargs) -> ChoiceMap:
    """Construct a choice map.

    ``choicemap(("x", 1.0), (("a","b"), 2.0))`` — (address, value) pairs, or
    ``choicemap(x=1.0, y=2.0)`` — keyword leaves, or
    ``choicemap({"x": 1.0, "sub": {"y": 2.0}})`` — nested dict.
    """
    out = ChoiceMap()
    for a in args:
        if isinstance(a, dict):
            for k, v in ChoiceMap.from_dict(a).leaf_items():
                out.set_value(k, v)
        else:
            addr, value = a
            out.set_value(addr, value)
    for k, v in kwargs.items():
        out.set_value(k, v)
    return out


# -- pytree registration --------------------------------------------------

def _chm_flatten(chm: ChoiceMap):
    leaf_keys = tuple(sorted_keys(chm._leaves))
    sub_keys = tuple(sorted_keys(chm._subs))
    children = tuple(chm._leaves[k] for k in leaf_keys) + tuple(
        chm._subs[k] for k in sub_keys)
    return children, (leaf_keys, sub_keys)


def _chm_flatten_with_keys(chm: ChoiceMap):
    children, aux = _chm_flatten(chm)
    leaf_keys, sub_keys = aux
    keys = tuple(jax.tree_util.DictKey(k) for k in leaf_keys + sub_keys)
    return tuple(zip(keys, children)), aux


def _chm_unflatten(aux, children) -> ChoiceMap:
    leaf_keys, sub_keys = aux
    out = ChoiceMap()
    n = len(leaf_keys)
    out._leaves = dict(zip(leaf_keys, children[:n]))
    out._subs = dict(zip(sub_keys, children[n:]))
    return out


jax.tree_util.register_pytree_with_keys(
    ChoiceMap, _chm_flatten_with_keys, _chm_unflatten, _chm_flatten)


EmptyChoiceMap = ChoiceMap  # alias: `ChoiceMap()` is the empty map
