"""Masked values: dynamically-present constraints.

Not in the reference (whose constraint structure is always host-concrete);
required accelerator-side whenever constraint *presence* varies per element of a
vmapped/scanned axis — e.g. particles with missing observations at some
timesteps, or per-element partial constraints in Map. A
:class:`MaskedValue` wraps ``(value, flag)``: structurally the address is
always constrained (static trace shape), but with ``flag=False`` the
handler samples instead and the weight contribution is zeroed — exactly
``generate``/``update`` semantics marginalized over the flag.

Usage::

    c = ChoiceMap().set_value("y", MaskedValue(obs, present))
    trace, w = model.generate(key, args, c)   # w includes logpdf(obs) only
                                              # where present is True
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


class MaskedValue:
    """A constraint value with a (possibly traced) presence flag."""

    __slots__ = ("value", "flag")

    def __init__(self, value, flag):
        self.value = value
        self.flag = flag

    def __repr__(self):
        return f"MaskedValue({self.value!r}, flag={self.flag!r})"


jax.tree_util.register_pytree_node(
    MaskedValue,
    lambda m: ((m.value, m.flag), None),
    lambda _, c: MaskedValue(c[0], c[1]))


def mask(value, flag) -> MaskedValue:
    return MaskedValue(value, jnp.asarray(flag))


def is_masked(x) -> bool:
    return isinstance(x, MaskedValue)


class MaskedSelection:
    """A selection whose membership flags are traced booleans.

    Enables branchless random-scan moves: ``regenerate`` with a
    MaskedSelection resamples address a iff its flag is true — ONE compiled
    pass regardless of which coordinate was chosen, instead of a K-way
    kernel mixture that runs every component under jit.

    Construct with a dict mapping addresses (single keys or tuple paths) to
    traced bool scalars: ``MaskedSelection({"x": flags[0], "y": flags[1]})``.
    """

    def __init__(self, flags: dict):
        from .address import addr_path
        self._flags = {addr_path(a): f for a, f in flags.items()}

    def flag_at(self, path):
        """Traced membership flag for a full path (False if absent)."""
        if path in self._flags:
            return self._flags[path]
        return False

    def subselection(self, key):
        sub = {p[1:]: f for p, f in self._flags.items()
               if len(p) > 1 and p[0] == key}
        return MaskedSelection(sub) if sub else MaskedSelection({})

    def is_empty_set(self) -> bool:
        return not self._flags

    def complement(self):
        raise NotImplementedError(
            "MaskedSelection complement is not defined (flags are traced)")

    def __contains__(self, addr) -> bool:
        raise TypeError(
            "MaskedSelection membership is traced; only `regenerate` "
            "supports it (handlers read flag_at)")


jax.tree_util.register_pytree_node(
    MaskedSelection,
    lambda m: (tuple(m._flags[k] for k in sorted(m._flags)),
               tuple(sorted(m._flags))),
    lambda keys, flags: MaskedSelection(dict(zip(keys, flags))))


def masked_select(**flags) -> MaskedSelection:
    """``masked_select(x=f0, y=f1)`` — addresses with traced flags."""
    return MaskedSelection(flags)
