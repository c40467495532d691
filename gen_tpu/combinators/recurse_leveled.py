"""Leveled Recurse: the per-level-vmap fast path for stochastic recursion.

Reference semantics: /root/reference/src/modeling_library/recurse/recurse.jl
(same contract as combinators/recurse.py). The per-node arena in recurse.py
inlines 2·N kernel applications into the XLA graph (N = (B^D−1)/(B−1) heap
slots) — compile time explodes for deep trees. This variant processes each
tree LEVEL as one ``vmap`` batch: level d is a single batched production
(resp. aggregation) application over its B^d slots, so the compiled graph is
O(D) kernel bodies and the per-level work lands on the vector and matrix units as one fused
batch. Score/weight bookkeeping is identical, expressed with per-lane active
masks; constraints with node-varying presence become MaskedValue lanes
(gen_tpu.masked) so one compiled program serves every constraint pattern of
the same address structure.

Trace layout: per-level batched subtraces (leading axis B^d) instead of
per-node tuples — the natural array representation (one array per address per
level).

Measured compile time (CPU backend, binary-branch gaussian tree):
per-node 8.5s/20.7s at D=5/6 (doubling per level; D=8 exceeds 9 minutes),
leveled 3.5s/4.8s there and 13s at D=14 (16383 nodes).

``regenerate`` handles BOTH uniform per-level selections (one vmapped
static subselection — the fast path) and node-varying selections: the
level's per-node static subselections are lowered onto ONE batched
:class:`gen_tpu.masked.MaskedSelection` whose per-lane flags say which
nodes resample which addresses, so the level still runs as a single vmap
(the branchless-random-scan machinery reused at combinator scale).
Node-varying selections must name choice addresses explicitly (a whole-
subtree ``AllSelection`` at a nested-call address can't be expanded
without knowing the callee's address universe — use the per-node Recurse
combinator for that).

Limitations vs the per-node arena: the choices/discard views require
concrete active masks, same as the per-node version.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from ..choice_map import ChoiceMap
from ..diff import UnknownChange, all_unknown_change
from ..gfi import GenerativeFunction, Trace
from ..selection import Selection
from .recurse import PROD, AGG, num_nodes
from .vector import tree_index, tree_stack

__all__ = ["LeveledRecurseCombinator", "RecurseLeveled"]


def _level_offsets(max_branch: int, max_depth: int):
    offs, sizes = [], []
    off, size = 0, 1
    for _ in range(max_depth):
        offs.append(off)
        sizes.append(size)
        off += size
        size *= max_branch
    return offs, sizes


def _bcast(x, n):
    x = jnp.asarray(x)
    return jnp.broadcast_to(x, (n,) + x.shape)


def _sel_signature(sel):
    """Structural signature of a static selection (shared helper in
    gen_tpu.selection; raises NotImplementedError for traced-membership
    selection types — use the per-node Recurse combinator there)."""
    from ..selection import selection_signature
    return selection_signature(sel)


def _uniform_level_subsel(selection, offs, sizes, d):
    """The level's shared subselection if every node of level d is selected
    identically, else None."""
    rep = selection.subselection(offs[d])
    sig = _sel_signature(rep)
    for j in range(1, sizes[d]):
        if _sel_signature(selection.subselection(offs[d] + j)) != sig:
            return None
    return rep


def _static_leaf_paths(sel, prefix=()):
    """Shared helper in gen_tpu.selection (see there for the lowering
    contract and its AllSelection limitation)."""
    from ..selection import static_leaf_paths
    return static_leaf_paths(sel, prefix)


class LeveledRecurseTrace(Trace):
    __slots__ = ("gen_fn", "args", "prod_levels", "agg_levels", "active",
                 "retval", "score", "noise")

    def __init__(self, gen_fn, args, prod_levels, agg_levels, active, retval,
                 score, noise):
        self.gen_fn = gen_fn
        self.args = args
        self.prod_levels = tuple(prod_levels)  # per-level batched subtraces
        self.agg_levels = tuple(agg_levels)
        self.active = tuple(active)            # per-level (B^d,) bool
        self.retval = retval
        self.score = score
        self.noise = noise

    def get_args(self):
        return self.args

    def get_retval(self):
        return self.retval

    def get_score(self):
        return self.score

    def get_gen_fn(self):
        return self.gen_fn

    def _locate(self, i: int):
        offs, sizes = _level_offsets(self.gen_fn.max_branch,
                                     self.gen_fn.max_depth)
        for d in reversed(range(len(offs))):
            if i >= offs[d]:
                return d, i - offs[d]
        raise KeyError(i)

    def _node_sub(self, i: int, kind: str):
        d, local = self._locate(i)
        levels = self.prod_levels if kind == PROD else self.agg_levels
        return tree_index(levels[d], local)

    def get_choices(self) -> ChoiceMap:
        import numpy as np
        if any(isinstance(a, jax.core.Tracer) for a in self.active):
            raise ValueError(
                "Recurse choices view requires a concrete active mask")
        offs, _ = _level_offsets(self.gen_fn.max_branch,
                                 self.gen_fn.max_depth)
        out = ChoiceMap()
        for d, act in enumerate(self.active):
            for local, is_act in enumerate(np.asarray(act)):
                if not is_act:
                    continue
                i = offs[d] + local
                p = tree_index(self.prod_levels[d], local).get_choices()
                if not p.is_empty():
                    out.set_submap((i, PROD), p)
                a = tree_index(self.agg_levels[d], local).get_choices()
                if not a.is_empty():
                    out.set_submap((i, AGG), a)
        return out

    def project(self, selection: Selection):
        if hasattr(selection, "is_empty_set") and selection.is_empty_set():
            return self.noise
        offs, sizes = _level_offsets(self.gen_fn.max_branch,
                                     self.gen_fn.max_depth)
        total = jnp.asarray(0.0)
        for d in range(len(offs)):
            sub = _uniform_level_subsel(selection, offs, sizes, d)
            if sub is not None:
                # fast path: one vmapped project per level (O(D) graph)
                psel = sub.subselection(PROD)
                asel = sub.subselection(AGG)
                p = jax.vmap(lambda t: t.project(psel))(self.prod_levels[d])
                a = jax.vmap(lambda t: t.project(asel))(self.agg_levels[d])
                total = total + jnp.sum(
                    jnp.where(self.active[d], p + a, 0.0))
                continue
            for local in range(sizes[d]):  # node-varying selection
                i = offs[d] + local
                psel = selection.subselection(i).subselection(PROD)
                asel = selection.subselection(i).subselection(AGG)
                p = tree_index(self.prod_levels[d], local).project(psel)
                a = tree_index(self.agg_levels[d], local).project(asel)
                total = total + jnp.where(self.active[d][local], p + a, 0.0)
        return total

    def __getitem__(self, addr):
        from ..address import addr_path
        path = addr_path(addr)
        i, kind = path[0], path[1]
        sub = self._node_sub(i, kind)
        rest = path[2:]
        if not rest:
            return sub.get_retval()
        return sub[rest if len(rest) > 1 else rest[0]]


jax.tree_util.register_pytree_node(
    LeveledRecurseTrace,
    lambda t: ((t.args, t.prod_levels, t.agg_levels, t.active, t.retval,
                t.score, t.noise), (t.gen_fn,)),
    lambda aux, c: LeveledRecurseTrace(aux[0], c[0], c[1], c[2], c[3], c[4],
                                       c[5], c[6]))


class LeveledRecurseCombinator(GenerativeFunction):
    """``RecurseLeveled(production, aggregation, max_branch, max_depth,
    w_example)`` — same contract as :class:`RecurseCombinator`, O(D)-size
    compiled graph."""

    def __init__(self, production: GenerativeFunction,
                 aggregation: GenerativeFunction, max_branch: int,
                 max_depth: int, w_example):
        self.production = production
        self.aggregation = aggregation
        self.max_branch = max_branch
        self.max_depth = max_depth
        self.n_nodes = num_nodes(max_branch, max_depth)
        self.w_zero = jax.tree_util.tree_map(
            lambda x: jnp.zeros(jnp.shape(x), jnp.asarray(x).dtype),
            w_example)

    def __repr__(self):
        return (f"RecurseLeveled({self.production!r}, {self.aggregation!r}, "
                f"B={self.max_branch}, D={self.max_depth})")

    def accepts_output_grad(self) -> bool:
        return True

    def has_argument_grads(self):
        return None

    # -- shared leveled walk ------------------------------------------------

    def _walk(self, key, root_input, prod_op, agg_op):
        """prod_op(d, keys, active, batched_inputs) -> (batched_subs, extra);
        agg_op(d, keys, active, v, child_ws, nchild) -> (batched_subs,
        extra). Returns (prod_levels, agg_levels, active_levels, retval,
        prod_extras, agg_extras)."""
        B, D = self.max_branch, self.max_depth
        offs, sizes = _level_offsets(B, D)
        k_prod, k_agg = (jax.random.split(key) if key is not None
                         else (None, None))

        inputs = jax.tree_util.tree_map(lambda x: _bcast(x, 1), root_input)
        active = [jnp.ones((1,), bool)]
        prod_levels, prod_extras, vs, nchilds = [], [], [], []
        for d in range(D):
            n = sizes[d]
            keys = (jax.random.split(jax.random.fold_in(k_prod, d), n)
                    if k_prod is not None else None)
            subs, extra = prod_op(d, keys, active[d], inputs)
            prod_levels.append(subs)
            prod_extras.append(extra)
            v, nchild, child_inputs = subs.get_retval()
            nchild = jnp.where(d >= D - 1, jnp.zeros_like(nchild), nchild)
            vs.append(v)
            nchilds.append(nchild)
            if d < D - 1:
                inputs = jax.tree_util.tree_map(
                    lambda x: x.reshape((n * B,) + x.shape[2:]),
                    child_inputs)
                act_next = (active[d][:, None]
                            & (jnp.arange(B)[None, :] < nchild[:, None]))
                active.append(act_next.reshape(-1))

        agg_levels = [None] * D
        agg_extras = [None] * D
        ws = None
        for d in reversed(range(D)):
            n = sizes[d]
            if ws is None:
                child_ws = jax.tree_util.tree_map(
                    lambda x: jnp.zeros((n, B) + jnp.shape(x),
                                        jnp.asarray(x).dtype), self.w_zero)
            else:
                child_ws = jax.tree_util.tree_map(
                    lambda x: x.reshape((n, B) + x.shape[1:]), ws)
            keys = (jax.random.split(jax.random.fold_in(k_agg, d), n)
                    if k_agg is not None else None)
            subs, extra = agg_op(d, keys, active[d], vs[d], child_ws,
                                 nchilds[d])
            agg_levels[d] = subs
            agg_extras[d] = extra
            ws = subs.get_retval()

        retval = tree_index(ws, 0)
        return (prod_levels, agg_levels, active, retval, prod_extras,
                agg_extras)

    def _scores(self, prod_levels, agg_levels, active):
        s_act = jnp.asarray(0.0)
        s_noise = jnp.asarray(0.0)
        for d in range(self.max_depth):
            node = prod_levels[d].get_score() + agg_levels[d].get_score()
            s_act = s_act + jnp.sum(jnp.where(active[d], node, 0.0))
            s_noise = s_noise + jnp.sum(jnp.where(active[d], 0.0, node))
        return s_act, s_noise

    def _make_trace(self, args, prod_levels, agg_levels, active, retval):
        score, noise = self._scores(prod_levels, agg_levels, active)
        return LeveledRecurseTrace(self, args, prod_levels, agg_levels,
                                   active, retval, score, noise)

    def _level_constraints(self, constraints: ChoiceMap, d: int, kind: str):
        """Stack the per-node constraint maps of one level into a single
        batched (masked) constraint map for vmap. Presence varies per node →
        MaskedValue with a concrete per-lane flag vector."""
        from ..masked import MaskedValue
        offs, sizes = _level_offsets(self.max_branch, self.max_depth)
        n = sizes[d]
        maps = [constraints.get_submap((offs[d] + j, kind))
                for j in range(n)]
        if all(m.is_empty() for m in maps):
            return None
        paths = []
        seen = set()
        for m in maps:
            for p, _ in m.leaf_items():
                if p not in seen:
                    seen.add(p)
                    paths.append(p)
        out = ChoiceMap()
        for p in paths:
            donors = [j for j in range(n) if maps[j].has_value(p)]
            proto = jnp.asarray(maps[donors[0]].get_value(p))
            vals = jnp.stack([
                jnp.asarray(maps[j].get_value(p)) if maps[j].has_value(p)
                else jnp.zeros_like(proto) for j in range(n)])
            flags = jnp.asarray([maps[j].has_value(p) for j in range(n)])
            out.set_value(p, MaskedValue(vals, flags))
        return out

    # -- GFI ------------------------------------------------------------

    def simulate(self, key, args: Tuple):
        (root_input,) = args

        def prod(d, keys, act, inputs):
            return jax.vmap(
                lambda k, inp: self.production.simulate(k, (inp,)))(
                    keys, inputs), None

        def agg(d, keys, act, v, child_ws, nchild):
            return jax.vmap(
                lambda k, a, cw, nc: self.aggregation.simulate(
                    k, (a, cw, nc)))(keys, v, child_ws, nchild), None

        p, a, act, retval, _, _ = self._walk(key, root_input, prod, agg)
        return self._make_trace(args, p, a, act, retval)

    def generate(self, key, args: Tuple, constraints: ChoiceMap = None):
        constraints = constraints if constraints is not None else ChoiceMap()
        (root_input,) = args
        weights = []

        def prod(d, keys, act, inputs):
            cons = self._level_constraints(constraints, d, PROD)
            if cons is None:
                subs = jax.vmap(
                    lambda k, inp: self.production.simulate(k, (inp,)))(
                        keys, inputs)
                return subs, None
            subs, w = jax.vmap(
                lambda k, inp, c: self.production.generate(k, (inp,), c),
                in_axes=(0, 0, 0))(keys, inputs, cons)
            weights.append(jnp.sum(jnp.where(act, w, 0.0)))
            return subs, None

        def agg(d, keys, act, v, child_ws, nchild):
            cons = self._level_constraints(constraints, d, AGG)
            if cons is None:
                subs = jax.vmap(
                    lambda k, a, cw, nc: self.aggregation.simulate(
                        k, (a, cw, nc)))(keys, v, child_ws, nchild)
                return subs, None
            subs, w = jax.vmap(
                lambda k, a, cw, nc, c: self.aggregation.generate(
                    k, (a, cw, nc), c))(keys, v, child_ws, nchild, cons)
            weights.append(jnp.sum(jnp.where(act, w, 0.0)))
            return subs, None

        p, a, act, retval, _, _ = self._walk(key, root_input, prod, agg)
        trace = self._make_trace(args, p, a, act, retval)
        return trace, sum(weights) if weights else jnp.asarray(0.0)

    def assess(self, args: Tuple, choices: ChoiceMap):
        """Key-free full-choices density; the active structure is static
        (which node addresses appear). Levels run as packed vmaps over their
        statically-active slots."""
        (root_input,) = args
        B, D = self.max_branch, self.max_depth
        offs, sizes = _level_offsets(B, D)
        level_act = [[choices.has_submap((offs[d] + j, PROD))
                      for j in range(sizes[d])] for d in range(D)]
        if not level_act[0][0]:
            raise ValueError("Recurse.assess: missing root production")

        weight = jnp.asarray(0.0)
        inputs = jax.tree_util.tree_map(lambda x: _bcast(x, 1), root_input)
        vs, nchilds, packed_idx = [], [], []
        for d in range(D):
            idx = [j for j in range(sizes[d]) if level_act[d][j]]
            if not idx:
                packed_idx.append(idx)
                vs.append(None)
                nchilds.append(None)
                continue
            packed_idx.append(idx)
            stacked = tree_stack(
                [choices.get_submap((offs[d] + j, PROD)) for j in idx])
            inp = jax.tree_util.tree_map(
                lambda x: x[jnp.asarray(idx)], inputs)
            w, retval = jax.vmap(
                lambda i, c: self.production.assess((i,), c))(inp, stacked)
            weight = weight + jnp.sum(w)
            v, nchild, child_inputs = retval
            if d >= D - 1:
                # depth cap: match _walk — the aggregation density must see
                # the same nchild the trace was built with
                nchild = jnp.zeros_like(nchild)
            vs.append(v)
            nchilds.append(nchild)
            if d < D - 1:
                # scatter packed child inputs back to the full level width
                full = jax.tree_util.tree_map(
                    lambda x: jnp.zeros((sizes[d], B) + x.shape[2:],
                                        x.dtype), child_inputs)
                full = jax.tree_util.tree_map(
                    lambda f, x: f.at[jnp.asarray(idx)].set(x), full,
                    child_inputs)
                inputs = jax.tree_util.tree_map(
                    lambda x: x.reshape((sizes[d] * B,) + x.shape[2:]), full)

        ws_full = None
        root_w = None
        for d in reversed(range(D)):
            idx = packed_idx[d]
            if not idx:
                ws_full = None
                continue
            if ws_full is None:
                child_ws = jax.tree_util.tree_map(
                    lambda x: jnp.zeros((len(idx), B) + jnp.shape(x),
                                        jnp.asarray(x).dtype), self.w_zero)
            else:
                gathered = jax.tree_util.tree_map(
                    lambda x: x.reshape((sizes[d], B) + x.shape[1:])[
                        jnp.asarray(idx)], ws_full)
                child_ws = gathered
            stacked = tree_stack(
                [choices.get_submap((offs[d] + j, AGG)) for j in idx])
            w, retw = jax.vmap(
                lambda v, cw, nc, c: self.aggregation.assess((v, cw, nc), c)
            )(vs[d], child_ws, nchilds[d], stacked)
            weight = weight + jnp.sum(w)
            # scatter outputs to full width for the parent's gather
            full = jax.tree_util.tree_map(
                lambda x: jnp.zeros((sizes[d],) + x.shape[1:], x.dtype),
                retw)
            ws_full = jax.tree_util.tree_map(
                lambda f, x: f.at[jnp.asarray(idx)].set(x), full, retw)
            root_w = tree_index(retw, 0) if d == 0 else root_w
        return weight, root_w

    def project(self, trace, selection: Selection):
        return trace.project(selection)

    def update(self, key, trace: LeveledRecurseTrace, args: Tuple,
               argdiffs: Tuple, constraints: ChoiceMap):
        constraints = constraints if constraints is not None else ChoiceMap()
        (root_input,) = args
        weights = []
        prev_active = trace.active

        def case_select(act, was, upd, gen, prev_score):
            new_u, w_u = upd
            new_g, w_g = gen
            w = jnp.where(act & was, w_u,
                          jnp.where(act & ~was, w_g,
                                    jnp.where(~act & was, -prev_score, 0.0)))
            keep = act & was
            new = jax.tree_util.tree_map(
                lambda a, b: jnp.where(
                    keep.reshape((-1,) + (1,) * (jnp.ndim(a) - 1)), a, b),
                new_u, new_g)
            return new, w

        def prod(d, keys, act, inputs):
            cons = self._level_constraints(constraints, d, PROD)
            cons = cons if cons is not None else ChoiceMap()
            prev = trace.prod_levels[d]
            upd = jax.vmap(lambda k, t, inp, c: self.production.update(
                k, t, (inp,), (UnknownChange,), c)[:2])(
                    keys, prev, inputs, cons)
            gen = jax.vmap(lambda k, inp, c: self.production.generate(
                k, (inp,), c))(keys, inputs, cons)
            new, w = case_select(act, prev_active[d], upd, gen,
                                 prev.get_score())
            weights.append(jnp.sum(w))
            return new, None

        def agg(d, keys, act, v, child_ws, nchild):
            cons = self._level_constraints(constraints, d, AGG)
            cons = cons if cons is not None else ChoiceMap()
            prev = trace.agg_levels[d]
            upd = jax.vmap(lambda k, t, a, cw, nc, c: self.aggregation.update(
                k, t, (a, cw, nc), all_unknown_change((a, cw, nc)), c)[:2])(
                    keys, prev, v, child_ws, nchild,
                    cons)
            gen = jax.vmap(lambda k, a, cw, nc, c: self.aggregation.generate(
                k, (a, cw, nc), c))(keys, v, child_ws, nchild,
                                    cons)
            new, w = case_select(act, prev_active[d], upd, gen,
                                 prev.get_score())
            weights.append(jnp.sum(w))
            return new, None

        p, a, act, retval, _, _ = self._walk(key, root_input, prod, agg)
        new_trace = self._make_trace(args, p, a, act, retval)
        discard = self._concrete_discard(trace, act, constraints)
        return new_trace, sum(weights), UnknownChange, discard

    def _concrete_discard(self, trace, new_active, constraints):
        import numpy as np
        discard = ChoiceMap()
        offs, sizes = _level_offsets(self.max_branch, self.max_depth)
        try:
            for d in range(self.max_depth):
                pa = np.asarray(trace.active[d])
                na = np.asarray(new_active[d])
                for j in range(sizes[d]):
                    i = offs[d] + j
                    if pa[j] and not na[j]:
                        for kind in (PROD, AGG):
                            ch = trace._node_sub(i, kind).get_choices()
                            if not ch.is_empty():
                                discard.set_submap((i, kind), ch)
                    elif pa[j] and na[j]:
                        for kind in (PROD, AGG):
                            cons = constraints.get_submap((i, kind))
                            if cons.is_empty():
                                continue
                            old = trace._node_sub(i, kind).get_choices()
                            kept = ChoiceMap()
                            for path, val in old.leaf_items():
                                if cons.has_value(path):
                                    kept.set_value(path, val)
                            if not kept.is_empty():
                                discard.set_submap((i, kind), kept)
        except jax.errors.TracerArrayConversionError:
            return ChoiceMap()
        return discard

    def _level_selection(self, selection: Selection, d: int, kind: str):
        """Lower the per-node subselections of one level onto a vmappable
        form: ``(static_sel, None)`` when every node is selected identically
        (fast path — one closed-over subselection), else ``(None,
        batched_masked)`` — a MaskedSelection whose flag leaves are (B^d,)
        arrays, mapped lane-wise by the level vmap."""
        from ..masked import MaskedSelection
        offs, sizes = _level_offsets(self.max_branch, self.max_depth)
        rep = _uniform_level_subsel(selection, offs, sizes, d)
        if rep is not None:
            return rep.subselection(kind), None
        n = sizes[d]
        per_node = [set(_static_leaf_paths(
            selection.subselection(offs[d] + j).subselection(kind)))
            for j in range(n)]
        union = sorted(set().union(*per_node), key=repr)
        flags = {p: jnp.asarray([p in per_node[j] for j in range(n)])
                 for p in union}
        return None, MaskedSelection(flags)

    def regenerate(self, key, trace: LeveledRecurseTrace, args: Tuple,
                   argdiffs: Tuple, selection: Selection):
        (root_input,) = args
        weights = []
        prev_active = trace.active
        from ..selection import NONE

        def mask_tree(keep, a, b):
            return jax.tree_util.tree_map(
                lambda x, y: jnp.where(
                    keep.reshape((-1,) + (1,) * (jnp.ndim(x) - 1)), x, y),
                a, b)

        def prod(d, keys, act, inputs):
            prev = trace.prod_levels[d]
            sel_static, sel_masked = self._level_selection(selection, d,
                                                           PROD)
            if sel_masked is None:
                reg = jax.vmap(lambda k, t, inp: self.production.regenerate(
                    k, t, (inp,), (UnknownChange,), sel_static)[:2])(
                        keys, prev, inputs)
            else:
                # node-varying: one batched MaskedSelection, still one vmap
                reg = jax.vmap(
                    lambda k, t, inp, s: self.production.regenerate(
                        k, t, (inp,), (UnknownChange,), s)[:2])(
                            keys, prev, inputs, sel_masked)
            gen = jax.vmap(lambda k, inp: self.production.generate(
                k, (inp,), ChoiceMap()))(keys, inputs)
            keep = act & prev_active[d]
            new = mask_tree(keep, reg[0], gen[0])
            w = jnp.where(keep, reg[1],
                          jnp.where(~act & prev_active[d],
                                    -jax.vmap(
                                        lambda t: t.project(NONE))(prev),
                                    0.0))
            weights.append(jnp.sum(w))
            return new, None

        def agg(d, keys, act, v, child_ws, nchild):
            prev = trace.agg_levels[d]
            sel_static, sel_masked = self._level_selection(selection, d, AGG)
            if sel_masked is None:
                reg = jax.vmap(
                    lambda k, t, a, cw, nc: self.aggregation.regenerate(
                        k, t, (a, cw, nc), all_unknown_change((a, cw, nc)),
                        sel_static)[:2])(keys, prev, v, child_ws, nchild)
            else:
                reg = jax.vmap(
                    lambda k, t, a, cw, nc, s: self.aggregation.regenerate(
                        k, t, (a, cw, nc), all_unknown_change((a, cw, nc)),
                        s)[:2])(keys, prev, v, child_ws, nchild, sel_masked)
            gen = jax.vmap(lambda k, a, cw, nc: self.aggregation.generate(
                k, (a, cw, nc), ChoiceMap()))(keys, v, child_ws, nchild)
            keep = act & prev_active[d]
            new = mask_tree(keep, reg[0], gen[0])
            weights.append(jnp.sum(jnp.where(keep, reg[1], 0.0)))
            return new, None

        p, a, act, retval, _, _ = self._walk(key, root_input, prod, agg)
        new_trace = self._make_trace(args, p, a, act, retval)
        return new_trace, sum(weights), UnknownChange


def RecurseLeveled(production, aggregation, max_branch: int, max_depth: int,
                   w_example) -> LeveledRecurseCombinator:
    return LeveledRecurseCombinator(production, aggregation, max_branch,
                                    max_depth, w_example)
