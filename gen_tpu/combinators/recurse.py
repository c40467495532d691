"""Recurse combinator: stochastic recursion over a tree.

Reference: /root/reference/src/modeling_library/recurse/recurse.jl (680
LoC): a *production* kernel maps an input U to a value V plus child inputs,
an *aggregation* kernel combines V with the children's outputs W into this
node's output; addresses are ``(idx, "production")`` / ``(idx,
"aggregation")`` with the heap indexing ``child(parent, j) =
(parent-1)*B + j + 1`` (recurse.jl:139-152).

Design — the reference's dynamically-sized persistent hash maps
and priority-queue dirty propagation become a **bounded complete-tree
arena**: every slot of a depth-``max_depth``, branch-``max_branch`` tree
always exists in the trace; an *active* mask (driven by each production's
``num_children``) selects the real tree. Inactive slots still sample, but
their randomness is *non-addressed noise* in the GFI sense — their score
contributions cancel (q = p), so ``get_score`` is exactly the active
tree's joint and ``project(EmptySelection)`` returns the inactive mass.
Everything is fixed-shape, so tree-structure moves jit.

Kernel signatures (fixed-width):
  production(u)                          -> (v, num_children, child_inputs)
        child_inputs: pytree with leading axis max_branch
  aggregation(v, child_outputs, num_children) -> w
        child_outputs: pytree with leading axis max_branch (garbage beyond
        num_children — the kernel must mask by num_children)
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from ..choice_map import ChoiceMap
from ..diff import UnknownChange, all_unknown_change
from ..gfi import GenerativeFunction, Trace
from ..selection import Selection
from .vector import tree_index, tree_stack

PROD = "production"
AGG = "aggregation"


def num_nodes(max_branch: int, max_depth: int) -> int:
    if max_branch == 1:
        return max_depth
    return (max_branch ** max_depth - 1) // (max_branch - 1)


def child_index(parent: int, j: int, max_branch: int) -> int:
    """0-based heap indexing (reference get_child, recurse.jl:139-146)."""
    return parent * max_branch + j + 1


def parent_index(idx: int, max_branch: int) -> int:
    return (idx - 1) // max_branch


class RecurseTrace(Trace):
    __slots__ = ("gen_fn", "args", "prod_subs", "agg_subs", "active",
                 "retval", "score", "noise")

    def __init__(self, gen_fn, args, prod_subs, agg_subs, active, retval,
                 score, noise):
        self.gen_fn = gen_fn
        self.args = args
        self.prod_subs = tuple(prod_subs)   # per-node production subtraces
        self.agg_subs = tuple(agg_subs)     # per-node aggregation subtraces
        self.active = active                # (N,) bool
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

    def get_choices(self) -> ChoiceMap:
        import numpy as np
        active = np.asarray(self.active)
        if active.dtype != np.bool_ or isinstance(self.active,
                                                  jax.core.Tracer):
            raise ValueError(
                "Recurse choices view requires a concrete active mask")
        out = ChoiceMap()
        for i, is_act in enumerate(active):
            if not is_act:
                continue
            p = self.prod_subs[i].get_choices()
            if not p.is_empty():
                out.set_submap((i, PROD), p)
            a = self.agg_subs[i].get_choices()
            if not a.is_empty():
                out.set_submap((i, AGG), a)
        return out

    def project(self, selection: Selection):
        if _sel_is_empty(selection):
            return self.noise
        total = jnp.asarray(0.0)
        for i in range(len(self.prod_subs)):
            act = self.active[i]
            psel = selection.subselection(i).subselection(PROD)
            asel = selection.subselection(i).subselection(AGG)
            p_sel = self.prod_subs[i].project(psel)
            a_sel = self.agg_subs[i].project(asel)
            total = total + jnp.where(act, p_sel + a_sel, 0.0)
        return total

    def __getitem__(self, addr):
        from ..address import addr_path
        path = addr_path(addr)
        i, kind = path[0], path[1]
        sub = self.prod_subs[i] if kind == PROD else self.agg_subs[i]
        rest = path[2:]
        if not rest:
            return sub.get_retval()
        return sub[rest if len(rest) > 1 else rest[0]]


def _sel_is_empty(sel) -> bool:
    return hasattr(sel, "is_empty_set") and sel.is_empty_set()


jax.tree_util.register_pytree_node(
    RecurseTrace,
    lambda t: ((t.args, t.prod_subs, t.agg_subs, t.active, t.retval,
                t.score, t.noise), (t.gen_fn,)),
    lambda aux, c: RecurseTrace(aux[0], c[0], c[1], c[2], c[3], c[4], c[5],
                                c[6]))


class RecurseCombinator(GenerativeFunction):
    """``Recurse(production, aggregation, max_branch, max_depth)``;
    args = (root_input,)."""

    def __init__(self, production: GenerativeFunction,
                 aggregation: GenerativeFunction, max_branch: int,
                 max_depth: int, w_example):
        self.production = production
        self.aggregation = aggregation
        self.max_branch = max_branch
        self.max_depth = max_depth
        self.n_nodes = num_nodes(max_branch, max_depth)
        # zero-prototype of the aggregation output W, used as the dummy
        # child-output slot for deepest-level nodes
        self.w_zero = jax.tree_util.tree_map(
            lambda x: jnp.zeros(jnp.shape(x), jnp.asarray(x).dtype),
            w_example)

    def __repr__(self):
        return (f"Recurse({self.production!r}, {self.aggregation!r}, "
                f"B={self.max_branch}, D={self.max_depth})")

    def accepts_output_grad(self) -> bool:
        return True

    def has_argument_grads(self):
        return None

    # -- core walk ---------------------------------------------------------

    def _node_depth(self, i):
        d, count, level_size = 0, 0, 1
        while True:
            if i < count + level_size:
                return d
            count += level_size
            level_size *= self.max_branch
            d += 1

    def _walk(self, root_input, per_node_prod, per_node_agg):
        """Generic two-pass walk. per_node_prod(i, active, input) ->
        (subtrace, extra); per_node_agg(i, active, v, child_ws, nchild) ->
        (subtrace, extra). Returns (prod_subs, agg_subs, active, retval,
        extras)."""
        N, B = self.n_nodes, self.max_branch
        inputs = [None] * N
        inputs[0] = root_input
        active = [None] * N
        active[0] = jnp.asarray(True)
        prod_subs = [None] * N
        prod_extras = [None] * N
        vs = [None] * N
        nchilds = [None] * N

        for i in range(N):
            if inputs[i] is None:
                # parent not yet processed (shouldn't happen: heap order)
                raise RuntimeError("arena walk out of order")
            sub, extra = per_node_prod(i, active[i], inputs[i])
            prod_subs[i] = sub
            prod_extras[i] = extra
            v, nchild, child_inputs = sub.get_retval()
            at_max_depth = self._node_depth(i) >= self.max_depth - 1
            nchild = jnp.where(at_max_depth, 0, nchild)
            vs[i] = v
            nchilds[i] = nchild
            for j in range(B):
                ci = child_index(i, j, B)
                if ci < N:
                    inputs[ci] = tree_index(child_inputs, j)
                    active[ci] = active[i] & (j < nchild)

        agg_subs = [None] * N
        agg_extras = [None] * N
        ws = [None] * N
        for i in reversed(range(N)):
            child_ws = []
            for j in range(B):
                ci = child_index(i, j, B)
                child_ws.append(ws[ci] if ci < N else self.w_zero)
            stacked = tree_stack(child_ws)
            sub, extra = per_node_agg(i, active[i], vs[i], stacked,
                                      nchilds[i])
            agg_subs[i] = sub
            agg_extras[i] = extra
            ws[i] = sub.get_retval()

        active_arr = jnp.stack(active)
        return (prod_subs, agg_subs, active_arr, ws[0],
                (prod_extras, agg_extras))

    def _dummy_child_ws(self, w_proto):
        return jax.tree_util.tree_map(
            lambda x: jnp.zeros((self.max_branch,) + jnp.shape(x),
                                jnp.asarray(x).dtype), w_proto)

    def _scores(self, prod_subs, agg_subs, active):
        s_act = jnp.asarray(0.0)
        s_noise = jnp.asarray(0.0)
        for i in range(self.n_nodes):
            node = prod_subs[i].get_score() + agg_subs[i].get_score()
            s_act = s_act + jnp.where(active[i], node, 0.0)
            s_noise = s_noise + jnp.where(active[i], 0.0, node)
        return s_act, s_noise

    def _make_trace(self, args, prod_subs, agg_subs, active, retval):
        score, noise = self._scores(prod_subs, agg_subs, active)
        return RecurseTrace(self, args, prod_subs, agg_subs, active, retval,
                            score, noise)

    # -- GFI ---------------------------------------------------------------

    def simulate(self, key, args: Tuple):
        (root_input,) = args
        keys = jax.random.split(key, 2 * self.n_nodes)

        def prod(i, act, inp):
            return self.production.simulate(keys[i], (inp,)), None

        def agg(i, act, v, child_ws, nchild):
            return self.aggregation.simulate(
                keys[self.n_nodes + i], (v, child_ws, nchild)), None

        prod_subs, agg_subs, active, retval, _ = self._walk(
            root_input, prod, agg)
        return self._make_trace(args, prod_subs, agg_subs, active, retval)

    def generate(self, key, args: Tuple, constraints: ChoiceMap = None):
        constraints = constraints if constraints is not None else ChoiceMap()
        (root_input,) = args
        keys = jax.random.split(key, 2 * self.n_nodes)
        weights = []

        def prod(i, act, inp):
            cons = constraints.get_submap((i, PROD))
            sub, w = self.production.generate(keys[i], (inp,), cons)
            weights.append(jnp.where(act, w, 0.0))
            return sub, None

        def agg(i, act, v, child_ws, nchild):
            cons = constraints.get_submap((i, AGG))
            sub, w = self.aggregation.generate(
                keys[self.n_nodes + i], (v, child_ws, nchild), cons)
            weights.append(jnp.where(act, w, 0.0))
            return sub, None

        prod_subs, agg_subs, active, retval, _ = self._walk(
            root_input, prod, agg)
        trace = self._make_trace(args, prod_subs, agg_subs, active, retval)
        return trace, sum(weights)

    def assess(self, args: Tuple, choices: ChoiceMap):
        """Full-choices density. The active tree is statically determined by
        WHICH node addresses appear in the choices (structure is static
        even when values are traced), so assess is key-free and
        differentiable — this is what powers choice/param gradients through
        Recurse via the generic base-class implementation."""
        (root_input,) = args
        N, B = self.n_nodes, self.max_branch
        active = [choices.has_submap((i, PROD)) for i in range(N)]
        if not active[0]:
            raise ValueError("Recurse.assess: missing root production")
        inputs = [None] * N
        inputs[0] = root_input
        weight = jnp.asarray(0.0)
        vs, nchilds = [None] * N, [None] * N
        for i in range(N):
            if not active[i]:
                continue
            w, retval = self.production.assess(
                (inputs[i],), choices.get_submap((i, PROD)))
            weight = weight + w
            v, nchild, child_inputs = retval
            if self._node_depth(i) >= self.max_depth - 1:
                # depth cap: match _walk, which zeroes nchild at the last
                # level — the aggregation density must see the same nchild
                # the trace was built with
                nchild = jnp.zeros_like(nchild)
            vs[i], nchilds[i] = v, nchild
            for j in range(B):
                ci = child_index(i, j, B)
                if ci < N:
                    inputs[ci] = tree_index(child_inputs, j)
        ws = [None] * N
        for i in reversed(range(N)):
            if not active[i]:
                continue
            child_ws = []
            for j in range(B):
                ci = child_index(i, j, B)
                if ci < N and active[ci]:
                    child_ws.append(ws[ci])
                else:
                    child_ws.append(self.w_zero)
            w, retval = self.aggregation.assess(
                (vs[i], tree_stack(child_ws), nchilds[i]),
                choices.get_submap((i, AGG)))
            weight = weight + w
            ws[i] = retval
        return weight, ws[0]

    def project(self, trace, selection: Selection):
        return trace.project(selection)

    def update(self, key, trace: RecurseTrace, args: Tuple, argdiffs: Tuple,
               constraints: ChoiceMap):
        constraints = constraints if constraints is not None else ChoiceMap()
        (root_input,) = args
        keys = jax.random.split(key, 2 * self.n_nodes) if key is not None \
            else None
        weights = []
        prev_active = trace.active

        def case_select(act_now, was_act, upd_out, gen_out, prev_sub):
            """weight contribution for one node given transition type."""
            new_sub_u, w_u = upd_out
            new_sub_g, w_g = gen_out
            # stay-active: update weight; newly-active: generate weight;
            # newly-inactive: -prev_score; stay-inactive: 0
            w = jnp.where(
                act_now & was_act, w_u,
                jnp.where(act_now & ~was_act, w_g,
                          jnp.where(~act_now & was_act,
                                    -prev_sub.get_score(), 0.0)))
            new_sub = jax.tree_util.tree_map(
                lambda a, b: jnp.where(act_now & was_act, a, b),
                new_sub_u, new_sub_g)
            return new_sub, w

        def prod(i, act, inp):
            k = keys[i] if keys is not None else None
            cons = constraints.get_submap((i, PROD))
            prev_sub = trace.prod_subs[i]
            upd = self.production.update(
                k, prev_sub, (inp,), (UnknownChange,), cons)[:2]
            gen = self.production.generate(k, (inp,), cons)
            new_sub, w = case_select(act, prev_active[i], upd, gen, prev_sub)
            weights.append(w)
            return new_sub, None

        def agg(i, act, v, child_ws, nchild):
            k = keys[self.n_nodes + i] if keys is not None else None
            cons = constraints.get_submap((i, AGG))
            prev_sub = trace.agg_subs[i]
            aargs = (v, child_ws, nchild)
            upd = self.aggregation.update(
                k, prev_sub, aargs, all_unknown_change(aargs), cons)[:2]
            gen = self.aggregation.generate(k, aargs, cons)
            new_sub, w = case_select(act, prev_active[i], upd, gen, prev_sub)
            weights.append(w)
            return new_sub, None

        prod_subs, agg_subs, active, retval, _ = self._walk(
            root_input, prod, agg)
        new_trace = self._make_trace(args, prod_subs, agg_subs, active,
                                     retval)
        # discard: only available with concrete masks (eager)
        discard = ChoiceMap()
        try:
            import numpy as np
            pa = np.asarray(prev_active)
            na = np.asarray(active)
            for i in range(self.n_nodes):
                if pa[i] and not na[i]:
                    pch = trace.prod_subs[i].get_choices()
                    if not pch.is_empty():
                        discard.set_submap((i, PROD), pch)
                    ach = trace.agg_subs[i].get_choices()
                    if not ach.is_empty():
                        discard.set_submap((i, AGG), ach)
                elif pa[i] and na[i]:
                    for kind, sub in ((PROD, trace.prod_subs[i]),
                                      (AGG, trace.agg_subs[i])):
                        cons = constraints.get_submap((i, kind))
                        if not cons.is_empty():
                            old = sub.get_choices().filter_paths(cons) \
                                if hasattr(sub.get_choices(), "filter_paths") \
                                else _overwritten(sub.get_choices(), cons)
                            if not old.is_empty():
                                discard.set_submap((i, kind), old)
        except jax.errors.TracerArrayConversionError:
            discard = ChoiceMap()
        return new_trace, sum(weights), UnknownChange, discard

    def regenerate(self, key, trace: RecurseTrace, args: Tuple,
                   argdiffs: Tuple, selection: Selection):
        # regenerate = update with selected nodes resampled; implement via
        # per-node regenerate in the same walk
        (root_input,) = args
        keys = jax.random.split(key, 2 * self.n_nodes)
        weights = []
        prev_active = trace.active

        def prod(i, act, inp):
            sel = selection.subselection(i).subselection(PROD)
            prev_sub = trace.prod_subs[i]
            reg = self.production.regenerate(
                keys[i], prev_sub, (inp,), (UnknownChange,), sel)
            gen = self.production.generate(keys[i], (inp,), ChoiceMap())
            new_sub = jax.tree_util.tree_map(
                lambda a, b: jnp.where(act & prev_active[i], a, b),
                reg[0], gen[0])
            from ..selection import NONE
            w = jnp.where(act & prev_active[i], reg[1],
                          jnp.where((~act) & prev_active[i],
                                    -prev_sub.project(NONE), 0.0))
            weights.append(w)
            return new_sub, None

        def agg(i, act, v, child_ws, nchild):
            sel = selection.subselection(i).subselection(AGG)
            prev_sub = trace.agg_subs[i]
            aargs = (v, child_ws, nchild)
            reg = self.aggregation.regenerate(
                keys[self.n_nodes + i], prev_sub, aargs,
                all_unknown_change(aargs), sel)
            gen = self.aggregation.generate(keys[self.n_nodes + i], aargs,
                                            ChoiceMap())
            new_sub = jax.tree_util.tree_map(
                lambda a, b: jnp.where(act & prev_active[i], a, b),
                reg[0], gen[0])
            weights.append(jnp.where(act & prev_active[i], reg[1], 0.0))
            return new_sub, None

        prod_subs, agg_subs, active, retval, _ = self._walk(
            root_input, prod, agg)
        new_trace = self._make_trace(args, prod_subs, agg_subs, active,
                                     retval)
        return new_trace, sum(weights), UnknownChange


def _overwritten(old: ChoiceMap, cons: ChoiceMap) -> ChoiceMap:
    out = ChoiceMap()
    for path, v in old.leaf_items():
        if cons.has_value(path):
            out.set_value(path, v)
    return out


def Recurse(production, aggregation, max_branch: int, max_depth: int,
            w_example) -> RecurseCombinator:
    return RecurseCombinator(production, aggregation, max_branch, max_depth,
                             w_example)
