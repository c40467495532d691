"""Switch combinator: branch selection by the first argument.

Reference: /root/reference/src/modeling_library/switch/ + cond.jl (420 LoC).
Args are ``(index, *branch_args)``; the selected branch's choices live
directly in the trace (no extra address level), and an index *change* under
``update`` inherits shared addresses from the previous branch
(update_recurse_merge, switch/update.jl:13-60) with
weight = generate_weight − prev_score (switch/update.jl:86-107).

Design — two execution modes:

* **concrete index** (Python int): dispatch to one branch; trace wraps that
  branch's trace. Full reference semantics including index-change update/
  regenerate and discards.
* **traced index** (jit/vmap — e.g. per-particle mixture components): run
  ALL branches and select score/retval/weight by index (`lax.switch`-style
  select). Branch count is small and static, so this is the XLA-friendly
  formulation: no data-dependent control flow, vmap just works. Choice-map
  views require a concrete index.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..choice_map import ChoiceMap
from ..diff import UnknownChange, all_unknown_change
from ..gfi import GenerativeFunction, Trace
from ..selection import Selection


def _is_concrete_index(index) -> bool:
    if isinstance(index, (int, np.integer)):
        return True
    if isinstance(index, jnp.ndarray) and not isinstance(
            index, jax.core.Tracer):
        return index.ndim == 0
    return False


class SwitchTrace(Trace):
    """Concrete-index mode: wraps the active branch's trace."""

    __slots__ = ("gen_fn", "index", "branch_trace", "args")

    def __init__(self, gen_fn, index, branch_trace, args):
        self.gen_fn = gen_fn
        self.index = index
        self.branch_trace = branch_trace
        self.args = args

    def get_args(self):
        return self.args

    def get_retval(self):
        return self.branch_trace.get_retval()

    def get_score(self):
        return self.branch_trace.get_score()

    def get_gen_fn(self):
        return self.gen_fn

    def get_choices(self):
        return self.branch_trace.get_choices()

    def project(self, selection: Selection):
        return self.branch_trace.project(selection)

    def __getitem__(self, addr):
        return self.branch_trace[addr]


jax.tree_util.register_pytree_node(
    SwitchTrace,
    lambda t: ((t.branch_trace, t.args), (t.gen_fn, t.index)),
    lambda aux, c: SwitchTrace(aux[0], aux[1], c[0], c[1]))


class AllBranchesSwitchTrace(Trace):
    """Traced-index mode: holds every branch's trace plus the index."""

    __slots__ = ("gen_fn", "index", "branch_traces", "args")

    def __init__(self, gen_fn, index, branch_traces, args):
        self.gen_fn = gen_fn
        self.index = index
        self.branch_traces = branch_traces
        self.args = args

    def get_args(self):
        return self.args

    def get_retval(self):
        vals = [t.get_retval() for t in self.branch_traces]
        return jax.tree_util.tree_map(
            lambda *xs: jnp.select(
                [self.index == i for i in range(len(xs))], list(xs)), *vals)

    def get_score(self):
        scores = jnp.stack([t.get_score() for t in self.branch_traces])
        return scores[self.index]

    def get_gen_fn(self):
        return self.gen_fn

    def get_choices(self):
        if _is_concrete_index(self.index):
            return self.branch_traces[int(self.index)].get_choices()
        raise ValueError(
            "Switch with a traced index has no single choice-map view; "
            "use GFI operations, or a concrete index")

    def project(self, selection: Selection):
        ps = jnp.stack([t.project(selection) for t in self.branch_traces])
        return ps[self.index]


jax.tree_util.register_pytree_node(
    AllBranchesSwitchTrace,
    lambda t: ((t.index, tuple(t.branch_traces), t.args), (t.gen_fn,)),
    lambda aux, c: AllBranchesSwitchTrace(aux[0], c[0], list(c[1]), c[2]))


class SwitchCombinator(GenerativeFunction):
    """``Switch(b0, b1, ...)``: args = (index, *shared_branch_args)."""

    def __init__(self, *branches: GenerativeFunction):
        if len(branches) == 1 and isinstance(branches[0], (list, tuple)):
            branches = tuple(branches[0])
        self.branches = tuple(branches)

    # structural equality (see MapCombinator.__eq__): inline-constructed
    # combinators must compare equal across model-body replays
    def __eq__(self, other):
        return type(other) is type(self) and other.branches == self.branches

    def __hash__(self):
        return hash((type(self), self.branches))

    def __repr__(self):
        return f"Switch({self.branches!r})"

    def accepts_output_grad(self) -> bool:
        return True

    def has_argument_grads(self):
        return None

    def _promote(self, key, trace: "SwitchTrace") -> "AllBranchesSwitchTrace":
        """Lift a concrete-index trace into the all-branches universe (needed
        when update/regenerate is called with a traced index). The fresh
        sibling universes never contribute to selected outputs: every
        prev-dependent quantity selects by the STATIC previous index."""
        bargs = tuple(trace.args[1:])
        keys = jax.random.split(key, len(self.branches))
        subs = [trace.branch_trace if i == trace.index
                else b.simulate(keys[i], bargs)
                for i, b in enumerate(self.branches)]
        return AllBranchesSwitchTrace(self, trace.index, subs, trace.args)

    # -- GFI --------------------------------------------------------------

    def simulate(self, key, args: Tuple):
        index, bargs = args[0], tuple(args[1:])
        if _is_concrete_index(index):
            sub = self.branches[int(index)].simulate(key, bargs)
            return SwitchTrace(self, int(index), sub, args)
        keys = jax.random.split(key, len(self.branches))
        subs = [b.simulate(k, bargs) for b, k in zip(self.branches, keys)]
        return AllBranchesSwitchTrace(self, index, subs, args)

    def generate(self, key, args: Tuple, constraints: ChoiceMap = None):
        index, bargs = args[0], tuple(args[1:])
        constraints = constraints if constraints is not None else ChoiceMap()
        if _is_concrete_index(index):
            sub, w = self.branches[int(index)].generate(key, bargs,
                                                        constraints)
            return SwitchTrace(self, int(index), sub, args), w
        keys = jax.random.split(key, len(self.branches))
        pairs = [b.generate(k, bargs, constraints)
                 for b, k in zip(self.branches, keys)]
        subs = [p[0] for p in pairs]
        ws = jnp.stack([p[1] for p in pairs])
        return AllBranchesSwitchTrace(self, index, subs, args), ws[index]

    def assess(self, args: Tuple, choices: ChoiceMap):
        index, bargs = args[0], tuple(args[1:])
        if _is_concrete_index(index):
            return self.branches[int(index)].assess(bargs, choices)
        outs = [b.assess(bargs, choices) for b in self.branches]
        ws = jnp.stack([o[0] for o in outs])
        retval = jax.tree_util.tree_map(
            lambda *xs: jnp.select([index == i for i in range(len(xs))],
                                   list(xs)), *[o[1] for o in outs])
        return ws[index], retval

    def project(self, trace, selection: Selection):
        return trace.project(selection)

    def update(self, key, trace, args: Tuple, argdiffs: Tuple,
               constraints: ChoiceMap):
        index, bargs = args[0], tuple(args[1:])
        bdiffs = tuple(argdiffs[1:]) if len(argdiffs) > 1 else \
            all_unknown_change(bargs)
        constraints = constraints if constraints is not None else ChoiceMap()

        if isinstance(trace, SwitchTrace) and _is_concrete_index(index):
            if int(index) == trace.index:
                sub, w, rd, disc = self.branches[int(index)].update(
                    key, trace.branch_trace, bargs, bdiffs, constraints)
                return SwitchTrace(self, int(index), sub, args), w, rd, disc
            # index change: inherit shared addresses from the old branch
            # (reference update_recurse_merge + weight = gen_w - prev_score)
            prev_choices = trace.get_choices()
            merged = prev_choices.merge(constraints, overwrite=True)
            sub, gen_w = self.branches[int(index)].generate(key, bargs,
                                                            merged)
            weight = gen_w - trace.get_score()
            discard = _switch_discard(prev_choices, constraints,
                                      sub.get_choices())
            return (SwitchTrace(self, int(index), sub, args), weight,
                    UnknownChange, discard)

        if isinstance(trace, SwitchTrace):  # traced index, concrete prev
            if key is None:
                raise ValueError(
                    "Switch.update with a traced index on a concrete-index "
                    "trace requires a key: promoting to the all-branches "
                    "universe samples the sibling branches. Build the "
                    "initial trace under jit (traced index) or pass a key.")
            key, k_promote = jax.random.split(key)
            trace = self._promote(k_promote, trace)

        # traced-index mode (masked universe): run BOTH the same-index
        # update and the changed-index generate-with-inherited-choices for
        # every branch, then select per branch by (index == b) & ~same.
        # Semantics per branch match the concrete-index path exactly
        # (reference update_recurse_merge, switch/update.jl:13-60), with
        # presence expressed as MaskedValue flags instead of host branching.
        if isinstance(trace, AllBranchesSwitchTrace):
            from ..masked import MaskedValue
            nb = len(self.branches)
            prev_index = trace.index
            prev_maps = [t.get_choices() for t in trace.branch_traces]
            same = jnp.asarray(index == prev_index)
            keys = jax.random.split(key, 2 * nb) if key is not None \
                else [None] * (2 * nb)
            # branches consume only the constraints they can address (a
            # masked discard legitimately holds other branches' addresses);
            # a path no branch can consume is still an error
            per_branch_cons = [
                _filter_for_branch(constraints, prev_maps[i])
                for i in range(nb)]
            _check_some_branch_consumes(constraints, prev_maps)
            outs = [b.update(k, t, bargs, bdiffs, c)
                    for b, t, k, c in zip(self.branches, trace.branch_traces,
                                          keys[:nb], per_branch_cons)]
            ws = jnp.stack([o[1] for o in outs])
            discard = _masked_switch_discard(
                self.branches, prev_maps, prev_index, index, same,
                constraints)

            if key is None:
                # key-free fast path (Gibbs-style updates): no sampling is
                # allowed, so the changed-index generate-with-inheritance
                # leg cannot run. Each universe retains its OWN unconstrained
                # values; the index-change weight new_score − prev_score is
                # exact when constraints cover every changed address (the
                # key=None contract).
                new_scores = jnp.stack([o[0].get_score() for o in outs])
                weight = jnp.where(same, ws[index],
                                   new_scores[index] - trace.get_score())
                return (AllBranchesSwitchTrace(self, index,
                                               [o[0] for o in outs], args),
                        weight, UnknownChange, discard)

            # changed-index: generate branch b constrained by the (traced)
            # previous branch's compatible choices under explicit constraints
            gens = []
            for b_idx, branch in enumerate(self.branches):
                merged = per_branch_cons[b_idx].copy()
                for path, tval in prev_maps[b_idx].leaf_items():
                    cv = merged.get_value(path) \
                        if merged.has_value(path) else None
                    if cv is not None and not isinstance(cv, MaskedValue):
                        continue  # hard constraint wins outright
                    mv = _masked_prev_value(prev_maps, prev_index, path,
                                            template=tval)
                    if mv is None:
                        continue
                    if cv is None:
                        merged.set_value(path, MaskedValue(*mv))
                    else:
                        # masked constraint: constrain where its flag is on,
                        # inherit the prev branch's value where it is off
                        merged.set_value(path, MaskedValue(
                            jnp.where(cv.flag, jnp.asarray(cv.value), mv[0]),
                            cv.flag | mv[1]))
                gens.append(branch.generate(keys[nb + b_idx], bargs, merged))
            gen_ws = jnp.stack([g[1] for g in gens])

            subs = [jax.tree_util.tree_map(
                        lambda g, u: jnp.where((index == b_idx) & ~same,
                                               g, u),
                        gens[b_idx][0], outs[b_idx][0])
                    for b_idx in range(nb)]
            weight = jnp.where(same, ws[index],
                               gen_ws[index] - trace.get_score())
            return (AllBranchesSwitchTrace(self, index, subs, args), weight,
                    UnknownChange, discard)
        raise TypeError(f"unexpected trace type {type(trace).__name__}")

    def regenerate(self, key, trace, args: Tuple, argdiffs: Tuple,
                   selection: Selection):
        index, bargs = args[0], tuple(args[1:])
        bdiffs = tuple(argdiffs[1:]) if len(argdiffs) > 1 else \
            all_unknown_change(bargs)

        if isinstance(trace, SwitchTrace) and _is_concrete_index(index):
            if int(index) == trace.index:
                sub, w, rd = self.branches[int(index)].regenerate(
                    key, trace.branch_trace, bargs, bdiffs, selection)
                return SwitchTrace(self, int(index), sub, args), w, rd
            # index change: constrain the new branch with the retained
            # (unselected) choices; weight = gen_w − Σ prev scores of the
            # retained choices the new branch actually consumed. This is
            # the GFI contract weight log q(t;u',x) − log q(t';u,x')
            # (gen_fn_interface.jl:292-334): selected and dropped terms
            # cancel against the internal forward/backward proposals.
            # DELIBERATE DEVIATION from reference switch/regenerate.jl:20-24,
            # whose ±project(selection) / full-complement terms double-count
            # the selected choices (verified biased by the mixture-posterior
            # MH test in tests/test_switch_distdsl.py).
            retained = trace.get_choices().filter(selection.complement())
            sub, gen_w = self.branches[int(index)].generate(key, bargs,
                                                            retained)
            from ..selection import select as select_addrs
            new_choices = sub.get_choices()
            consumed = [p for p, _ in retained.leaf_items()
                        if new_choices.has_value(p)]
            back = trace.project(select_addrs(*consumed)) if consumed \
                else jnp.asarray(0.0)
            return (SwitchTrace(self, int(index), sub, args), gen_w - back,
                    UnknownChange)

        if isinstance(trace, SwitchTrace):  # traced index, concrete prev
            key, k_promote = jax.random.split(key)
            trace = self._promote(k_promote, trace)

        if isinstance(trace, AllBranchesSwitchTrace):
            from ..masked import MaskedValue
            nb = len(self.branches)
            prev_index = trace.index
            prev_maps = [t.get_choices() for t in trace.branch_traces]
            same = jnp.asarray(index == prev_index)
            keys = jax.random.split(key, 2 * nb)
            outs = [b.regenerate(k, t, bargs, bdiffs, selection)
                    for b, t, k in zip(self.branches, trace.branch_traces,
                                       keys[:nb])]
            ws = jnp.stack([o[1] for o in outs])

            # changed-index: generate branch b constrained with the prev
            # branch's retained (unselected, shape-compatible) choices;
            # weight = gen_w − Σ prev scores of the retained choices the new
            # branch consumed (the GFI contract weight — see the concrete-
            # index path above for why this deviates from the reference).
            from ..selection import select as select_addrs
            gens = []
            back_terms = []
            for b_idx, branch in enumerate(self.branches):
                retained = ChoiceMap()
                back = jnp.asarray(0.0)
                for path, tval in prev_maps[b_idx].leaf_items():
                    sflag = _sel_membership(selection, path)
                    if sflag is True:
                        continue  # statically selected — never retained
                    mv = _masked_prev_value(prev_maps, prev_index, path,
                                            template=tval)
                    if mv is None:
                        continue
                    val, dflag = mv
                    # MaskedSelection: membership is a traced flag — retain
                    # exactly where the address is NOT selected
                    flag = dflag if sflag is False else dflag & ~sflag
                    retained.set_value(path, MaskedValue(val, flag))
                    back = back + jnp.where(
                        flag, trace.project(select_addrs(path)), 0.0)
                gens.append(branch.generate(keys[nb + b_idx], bargs,
                                            retained))
                back_terms.append(back)
            gen_ws = jnp.stack([g[1] for g in gens])
            changed_w = gen_ws[index] - jnp.stack(back_terms)[index]

            subs = [jax.tree_util.tree_map(
                        lambda g, u: jnp.where((index == b_idx) & ~same,
                                               g, u),
                        gens[b_idx][0], outs[b_idx][0])
                    for b_idx in range(nb)]
            weight = jnp.where(same, ws[index], changed_w)
            return (AllBranchesSwitchTrace(self, index, subs, args),
                    weight, UnknownChange)
        raise TypeError(f"unexpected trace type {type(trace).__name__}")


class _MixedAvalError(NotImplementedError):
    """A shared address stores different shapes/dtypes across branches."""


def _aval(x):
    x = jnp.asarray(x)
    return (jnp.shape(x), x.dtype)


def _filter_for_branch(constraints: ChoiceMap, template: ChoiceMap):
    """Constraints restricted to addresses the branch actually has."""
    out = ChoiceMap()
    for path, v in constraints.leaf_items():
        if template.has_value(path):
            out.set_value(path, v)
    return out


def _check_some_branch_consumes(constraints: ChoiceMap, prev_maps):
    orphans = [p for p, _ in constraints.leaf_items()
               if not any(m.has_value(p) for m in prev_maps)]
    if orphans:
        raise ValueError(
            f"Switch.update: no branch has addresses {orphans!r} "
            "(reference: src/dynamic/update.jl:191-193)")


def _sel_membership(selection, path):
    """Membership of ``path`` in a selection: a Python bool for static
    selections, a traced flag for MaskedSelection."""
    from ..masked import MaskedSelection
    if isinstance(selection, MaskedSelection):
        return selection.flag_at(path)  # traced flag, or literal False
    return path in selection


def _masked_prev_value(prev_maps, prev_index, path, template=None):
    """(value, flag) for ``path`` under the traced previous branch index.

    Only branches storing a value shape/dtype-compatible with ``template``
    can donate; ``flag`` is False when the prev branch has no compatible
    value (so a MaskedValue constraint built from this samples fresh).
    Returns None when no branch can donate at all."""
    donors = [i for i, m in enumerate(prev_maps) if m.has_value(path)]
    if template is not None:
        t = _aval(template)
        donors = [i for i in donors
                  if _aval(prev_maps[i].get_value(path)) == t]
    else:
        avals = {_aval(prev_maps[i].get_value(path)) for i in donors}
        if len(avals) > 1:
            raise _MixedAvalError(
                f"Switch with a traced index: address {path!r} has "
                f"different shapes/dtypes across branches ({avals}); a "
                "single select-able value cannot represent it. Pad the "
                "branches to a common shape, or use a concrete index.")
    if not donors:
        return None
    vals = [jnp.asarray(prev_maps[i].get_value(path)) for i in donors]
    conds = [prev_index == i for i in donors]
    value = vals[0] if len(vals) == 1 else jnp.select(conds, vals, vals[0])
    flag = conds[0]
    for c in conds[1:]:
        flag = flag | c
    return value, flag


def _masked_switch_discard(branches, prev_maps, prev_index, index, same,
                           constraints: ChoiceMap) -> ChoiceMap:
    """Traced-index discard: previous-branch choices overwritten by
    constraints, or (on an index change) absent from the new branch —
    presence expressed as MaskedValue flags (reference
    switch/update.jl:59-79 marginalized over the traced indices)."""
    from ..masked import MaskedValue
    paths = []
    seen = set()
    for m in prev_maps:
        for path, _ in m.leaf_items():
            if path not in seen:
                seen.add(path)
                paths.append(path)
    discard = ChoiceMap()
    for path in paths:
        try:
            value, has_prev = _masked_prev_value(prev_maps, prev_index, path)
        except _MixedAvalError:
            # unrepresentable: branches disagree on this address's
            # shape/dtype. Degrade to omitting it (the discard is
            # best-effort in traced mode, like the concrete path's
            # try/except) rather than failing updates that never consume
            # the discard.
            import warnings
            warnings.warn(
                f"Switch traced-index discard omits address {path!r}: "
                "branches store different shapes/dtypes there. "
                "Custom-proposal MH over this address will mis-weight; pad "
                "the branches to a common shape to fix.", RuntimeWarning,
                stacklevel=2)
            continue
        if constraints.has_value(path):
            cv = constraints.get_value(path)
            const_flag = cv.flag if isinstance(cv, MaskedValue) \
                else jnp.asarray(True)
        else:
            const_flag = jnp.asarray(False)
        # which NEW branches lack a compatible slot for this path (static)
        aval = _aval(value)
        lacking = [b for b, m in enumerate(prev_maps)
                   if not (m.has_value(path)
                           and _aval(m.get_value(path)) == aval)]
        lacks_new = jnp.asarray(False)
        for b in lacking:
            lacks_new = lacks_new | (index == b)
        flag = has_prev & (const_flag | (~same & lacks_new))
        if not isinstance(flag, jax.core.Tracer) and not bool(flag):
            continue  # statically never discarded — keep the map empty
        discard.set_value(path, MaskedValue(value, flag))
    return discard


def _switch_discard(prev_choices: ChoiceMap, constraints: ChoiceMap,
                    new_choices: ChoiceMap) -> ChoiceMap:
    """Choices of the previous branch that were overwritten by constraints
    or do not appear in the new branch (reference switch/update.jl:59-79)."""
    discard = ChoiceMap()
    for path, value in prev_choices.leaf_items():
        if constraints.has_value(path) or not new_choices.has_value(path):
            discard.set_value(path, value)
    return discard


def Switch(*branches) -> SwitchCombinator:
    return SwitchCombinator(*branches)
