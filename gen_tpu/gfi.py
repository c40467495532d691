"""The Generative Function Interface (GFI).

The central abstraction of the framework, preserved exactly from the
reference (/root/reference/src/gen_fn_interface.jl:137-410): every model
object — traced-interpreter model, combinator, or hand-written — implements
the same trace interface, and every inference algorithm is written against
it.

accelerator-native departures from the reference:

* **Explicit randomness.** Every sampling method takes a ``jax.random`` key
  as its first argument; there is no global RNG. This is what makes
  ``vmap(simulate)`` over thousands of chains/particles correct.

* **Purity.** ``update``/``regenerate`` return new traces; parameter
  gradients are returned functionally (``param_gradients``) with a thin
  mutating accumulator wrapper (``accumulate_param_gradients``) for API
  parity with the reference.

* **Pytree traces.** Every trace is a pytree whose structure is static and
  whose leaves are arrays, so every GFI method jits, vmaps, and shards.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import jax

from .choice_map import ChoiceMap
from .diff import all_no_change
from .selection import NONE, Selection


class Trace:
    """A recorded execution of a generative function.

    Accessors mirror /root/reference/src/gen_fn_interface.jl:10-92.
    """

    def get_args(self) -> Tuple:
        raise NotImplementedError

    def get_retval(self):
        raise NotImplementedError

    def get_choices(self) -> ChoiceMap:
        raise NotImplementedError

    def get_score(self):
        """log p(t, r; x) / q(r; x, t); equals log p(t; x) when there is no
        non-addressed randomness."""
        raise NotImplementedError

    def get_gen_fn(self) -> "GenerativeFunction":
        raise NotImplementedError

    def __getitem__(self, addr):
        return self.get_choices()[addr]

    # convenience forwarding, matching Gen's trace-first API style

    def update(self, key, constraints: ChoiceMap, args=None, argdiffs=None):
        fn = self.get_gen_fn()
        if args is None:
            args = self.get_args()
            argdiffs = all_no_change(args)
        return fn.update(key, self, args, argdiffs, constraints)

    def regenerate(self, key, selection: Selection, args=None, argdiffs=None):
        fn = self.get_gen_fn()
        if args is None:
            args = self.get_args()
            argdiffs = all_no_change(args)
        return fn.regenerate(key, self, args, argdiffs, selection)

    def project(self, selection: Selection):
        return self.get_gen_fn().project(self, selection)


class GenerativeFunction:
    """Abstract generative function; the 11 GFI methods.

    Weight formulas are documented at the reference lines cited per method;
    they are preserved exactly.
    """

    # -- metadata ---------------------------------------------------------

    def has_argument_grads(self) -> Tuple[bool, ...]:
        raise NotImplementedError

    def accepts_output_grad(self) -> bool:
        return False

    def get_params(self):
        """Iterable over trainable parameter names (may be empty)."""
        return ()

    # -- core methods -----------------------------------------------------

    def simulate(self, key, args: Tuple) -> Trace:
        """Sample t ~ p(.; x); return the trace.
        Reference: gen_fn_interface.jl:149-151."""
        raise NotImplementedError

    def generate(self, key, args: Tuple, constraints: Optional[ChoiceMap] = None
                 ) -> Tuple[Trace, Any]:
        """Constrained generation; weight = log p(t; x) / q(t; u, x).
        Reference: gen_fn_interface.jl:185-191."""
        raise NotImplementedError

    def project(self, trace: Trace, selection: Selection):
        """log-density of the selected choices under the internal proposal
        decomposition. Reference: gen_fn_interface.jl:206-208."""
        raise NotImplementedError

    def propose(self, key, args: Tuple) -> Tuple[ChoiceMap, Any, Any]:
        """Default via simulate. Reference: gen_fn_interface.jl:222-226."""
        trace = self.simulate(key, args)
        return trace.get_choices(), trace.get_score(), trace.get_retval()

    def assess(self, args: Tuple, choices: ChoiceMap) -> Tuple[Any, Any]:
        """(weight, retval) with ALL addressed choices given.
        Reference: gen_fn_interface.jl:241-244 (default via generate; here
        implemented natively by each gen fn so it stays key-free and
        differentiable)."""
        raise NotImplementedError

    def update(self, key, trace: Trace, args: Tuple, argdiffs: Tuple,
               constraints: ChoiceMap):
        """(new_trace, weight, retdiff, discard); the incremental edit move.
        weight = log [p(t';x') q(r;x,t)] / [p(t;x) q(r';x',t') q(t';x',t+u)].
        Reference: gen_fn_interface.jl:246-277."""
        raise NotImplementedError

    def regenerate(self, key, trace: Trace, args: Tuple, argdiffs: Tuple,
                   selection: Selection):
        """(new_trace, weight, retdiff); resample the selected addresses from
        the internal proposal. Reference: gen_fn_interface.jl:292-334."""
        raise NotImplementedError

    # -- gradients --------------------------------------------------------
    #
    # Both gradient methods are generic over ANY generative function: they
    # are jax.grad of the key-free, fully-constrained `assess` re-execution
    # — the functional analogue of the reference's ReverseDiff tape replay
    # (src/dynamic/backprop.jl), with XLA autodiff supplying the analytic
    # per-distribution logpdf derivatives.

    def choice_gradients(self, trace: Trace, selection: Selection = NONE,
                         retgrad=None):
        """(arg_grads, choice_values, choice_grads): gradient of
        log p(t; x) + <retgrad, retval> w.r.t. args and the selected
        continuous choices, as choice maps.
        Reference: gen_fn_interface.jl:373-410."""
        from .utils import combine, partition_inexact, tree_vdot
        choices = trace.get_choices()
        sel_values = choices.filter(selection)
        rest = choices.filter(selection.complement())
        args = trace.get_args()
        args_dyn, args_static = partition_inexact(args)

        def f(payload, adyn):
            full = rest.merge(payload)
            w, retval = self.assess(combine(adyn, args_static), full)
            return w + tree_vdot(retgrad, retval)

        choice_grads, arg_grads = jax.grad(f, argnums=(0, 1))(
            sel_values, args_dyn)
        return arg_grads, sel_values, choice_grads

    def param_gradients(self, trace: Trace, retgrad=None, scale_factor=1.0):
        """(arg_grads, param_grads): functional form of the reference's
        ``accumulate_param_gradients!`` (gen_fn_interface.jl:336-371).
        ``param_grads`` maps each reachable gen fn with trainable params to
        its {name: grad} dict (the reference recurses into callees the same
        way, backprop.jl:336-370). Param grads are scaled by
        ``scale_factor``; arg grads are not."""
        from .dynamic.params import collect_param_fns, override_params
        from .utils import combine, partition_inexact, tree_vdot
        fns = collect_param_fns(trace)
        bundle = {i: dict(fn.params) for i, fn in enumerate(fns)}
        bundle_dyn, bundle_static = partition_inexact(bundle)
        choices = trace.get_choices()
        args = trace.get_args()
        args_dyn, args_static = partition_inexact(args)

        def f(bdyn, adyn):
            b = combine(bdyn, bundle_static)
            with override_params({id(fn): b[i] for i, fn in enumerate(fns)}):
                w, retval = self.assess(combine(adyn, args_static), choices)
            return w + tree_vdot(retgrad, retval)

        bundle_grads, arg_grads = jax.grad(f, argnums=(0, 1))(
            bundle_dyn, args_dyn)
        if scale_factor != 1.0:
            bundle_grads = jax.tree_util.tree_map(
                lambda g: g * scale_factor, bundle_grads)
        param_grads = {fn: bundle_grads[i] for i, fn in enumerate(fns)}
        return arg_grads, param_grads

    def accumulate_param_gradients(self, trace: Trace, retgrad=None,
                                   scale_factor=1.0):
        """Mutating wrapper: increments the gradient accumulators of every
        reachable gen fn (host-side) and returns arg grads, matching the
        reference API (gen_fn_interface.jl:336-371)."""
        arg_grads, param_grads = self.param_gradients(trace, retgrad,
                                                      scale_factor)
        for fn, grads in param_grads.items():
            store = fn.params_grad
            for name, g in grads.items():
                acc = store.get(name)
                store[name] = g if acc is None else jax.tree_util.tree_map(
                    lambda a, b: a + b, acc, g)
        return arg_grads

    # -- modeling-language sugar ------------------------------------------

    def __call__(self, *args):
        """Inside a model body, ``fn(args) @ "addr"`` traces a call at an
        address. Outside any handler this raises."""
        from .dynamic.handlers import Call
        return Call(self, args)

    def inline(self, *args):
        """Call another generative function *without* an address scope — its
        choices splice into the caller's trace (Gen's ``{*} ~ fn()``
        / ``splice``, reference src/dynamic/dynamic.jl:90-103)."""
        from .dynamic.handlers import active_handler
        return active_handler().splice(self, args)
