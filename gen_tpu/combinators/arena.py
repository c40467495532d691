"""UnfoldArena: fixed-capacity state-space traces with O(1), recompile-free
extension — the accelerator-native long-sequence story (SURVEY.md §5.7).

The plain :class:`~gen_tpu.combinators.unfold.UnfoldCombinator` has a
static length, so a particle filter that extends the trace each step
compiles one program per timestep. The arena preallocates ``max_length``
slots; the active length ``t`` is a *traced* scalar, extension writes slot
``t`` with ``dynamic_update_slice`` — one compiled program for every step,
and the entire filter can be a single ``lax.scan`` over time with particles
``vmap``-ed inside (see :func:`smc_run`). Inactive slots are zero padding
with zero scores (not samples), so the trace score is exactly the active
prefix's joint."""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from ..choice_map import ChoiceMap
from ..gfi import GenerativeFunction, Trace
from ..utils import logsumexp
from .vector import VectorChoiceMap


class ArenaTrace(Trace):
    """subtraces: one batched kernel-trace pytree over the slot axis;
    t_active: traced scalar count of live slots."""

    __slots__ = ("arena", "subtraces", "t_active", "init_state", "params")

    def __init__(self, arena, subtraces, t_active, init_state, params):
        self.arena = arena
        self.subtraces = subtraces
        self.t_active = t_active
        self.init_state = init_state
        self.params = params

    def get_args(self):
        return (self.t_active, self.init_state) + tuple(self.params)

    def get_retval(self):
        return self.subtraces.get_retval()  # stacked states (max_length,...)

    def get_score(self):
        return jnp.sum(self.subtraces.get_score())  # inactive slots are 0

    def get_gen_fn(self):
        return self.arena

    def last_state(self):
        # one-hot reduction instead of a dynamic gather: under vmap the
        # gather lowers to per-particle scatter/gather ops; the masked sum
        # is a pure elementwise reduction.
        idx = jnp.maximum(self.t_active - 1, 0)

        def pick(x):
            onehot = (jnp.arange(x.shape[0]) == idx)
            return jnp.sum(
                jnp.where(onehot.reshape((-1,) + (1,) * (x.ndim - 1)), x, 0),
                axis=0)

        return jax.tree_util.tree_map(pick, self.get_retval())

    def get_choices(self):
        t = self.t_active
        if isinstance(t, jax.core.Tracer):
            raise ValueError("arena choices view requires a concrete length")
        out = ChoiceMap()
        inner = self.subtraces.get_choices()
        for i in range(int(t)):
            out.set_submap(i, jax.tree_util.tree_map(lambda x: x[i], inner))
        return out

    def project(self, selection):
        if hasattr(selection, "is_empty_set") and selection.is_empty_set():
            return jnp.asarray(0.0)
        raise NotImplementedError(
            "arena project: convert with to_unfold_trace() first")

    def to_unfold_trace(self):
        """Concrete-length view as a standard UnfoldTrace (full GFI)."""
        from .unfold import UnfoldCombinator, UnfoldTrace
        t = int(self.t_active)
        subs = jax.tree_util.tree_map(lambda x: x[:t], self.subtraces)
        unfold = UnfoldCombinator(self.arena.kernel)
        args = (t, self.init_state) + tuple(self.params)
        return UnfoldTrace(unfold, args, subs, jnp.sum(subs.get_score()),
                           subs.get_retval(), t)


jax.tree_util.register_pytree_node(
    ArenaTrace,
    lambda tr: ((tr.subtraces, tr.t_active, tr.init_state, tr.params),
                (tr.arena,)),
    lambda aux, c: ArenaTrace(aux[0], c[0], c[1], c[2], c[3]))


class UnfoldArena(GenerativeFunction):
    """``UnfoldArena(kernel, max_length)``: SMC-oriented interface —
    ``init`` then repeated ``extend``; each is ONE compiled program for all
    timesteps."""

    def __init__(self, kernel: GenerativeFunction, max_length: int):
        self.kernel = kernel
        self.max_length = max_length

    def __repr__(self):
        return f"UnfoldArena({self.kernel!r}, max_length={self.max_length})"

    def _zero_pad(self, sub):
        """Arena of max_length slots: slot 0 = sub, rest zero."""
        def pad(x):
            x = jnp.asarray(x)
            out = jnp.zeros((self.max_length,) + x.shape, x.dtype)
            return out.at[0].set(x)
        return jax.tree_util.tree_map(pad, sub)

    def init(self, key, init_state, params: Tuple = (),
             constraints: Optional[ChoiceMap] = None):
        """Generate step 0. Returns (trace, weight)."""
        sub, w = self.kernel.generate(
            key, (jnp.asarray(0, jnp.int32), init_state) + tuple(params),
            constraints if constraints is not None else ChoiceMap())
        arena = self._zero_pad(sub)
        return ArenaTrace(self, arena, jnp.asarray(1, jnp.int32), init_state,
                          tuple(params)), w

    def extend(self, key, trace: ArenaTrace,
               constraints: Optional[ChoiceMap] = None):
        """Append one step at t_active (traced): O(1), no recompilation.
        Weight = generate weight of the new step (the Unfold extension
        semantics, unfold/update.jl + particle_filter.jl:162-180)."""
        t = trace.t_active
        state = trace.last_state()
        sub, w = self.kernel.generate(
            key, (t, state) + tuple(trace.params),
            constraints if constraints is not None else ChoiceMap())
        # branchless slot write: where-mask over the slot axis instead of
        # dynamic_update_slice (which lowers to slow scatters under vmap)
        def write_slot(arena_leaf, new_leaf):
            mask = (jnp.arange(arena_leaf.shape[0]) == t)
            mask = mask.reshape((-1,) + (1,) * (arena_leaf.ndim - 1))
            newv = jnp.asarray(new_leaf, arena_leaf.dtype)
            return jnp.where(mask, newv[None, ...], arena_leaf)

        new_arena = jax.tree_util.tree_map(write_slot, trace.subtraces, sub)
        return ArenaTrace(self, new_arena, t + 1, trace.init_state,
                          trace.params), w

    # minimal GFI (full ops via to_unfold_trace)
    def simulate(self, key, args: Tuple):
        t_total, init_state, *params = args
        keys = jax.random.split(key, int(t_total))
        trace, _ = self.init(keys[0], init_state, tuple(params))
        for i in range(1, int(t_total)):
            trace, _ = self.extend(keys[i], trace)
        return trace


def smc_run(key, arena: UnfoldArena, init_state, params: Tuple,
            observations: VectorChoiceMap, num_particles: int,
            ess_threshold: Optional[float] = None,
            resample_method: str = "systematic"):
    """The ENTIRE particle filter as one jitted program: ``lax.scan`` over
    timesteps, particles vmapped inside, collective resampling between
    steps. ``observations``: dense per-step constraints
    (``vector_choicemap(T, y=obs)``). Returns (final_state_traces,
    log_weights, log_ml_estimate)."""
    from ..inference.particle_filter import _resample_parents
    T = observations.length
    if ess_threshold is None:
        ess_threshold = num_particles / 2

    k_init, k_scan = jax.random.split(key)
    init_keys = jax.random.split(k_init, num_particles)
    obs0 = observations.get_submap(0)
    traces, weights = jax.vmap(
        lambda k: arena.init(k, init_state, params, obs0))(init_keys)

    def step(carry, inp):
        traces, log_weights, log_ml = carry
        t, k = inp
        k_res, k_ext = jax.random.split(k)
        # maybe resample: lax.cond skips the sort + whole-trace gather when
        # ESS is high (dominant step cost at large N)
        log_total = logsumexp(log_weights)
        lnw = log_weights - log_total
        ess = jnp.exp(-logsumexp(2.0 * lnw))
        do = ess < ess_threshold

        lm_dtype = jnp.result_type(log_ml, log_total)

        def resample(_):
            parents = _resample_parents(k_res, lnw, resample_method)
            res = jax.tree_util.tree_map(lambda x: x[parents], traces)
            return (res, jnp.zeros_like(log_weights),
                    (log_ml + log_total
                     - jnp.log(num_particles)).astype(lm_dtype))

        def keep(_):
            return traces, log_weights, jnp.asarray(log_ml, lm_dtype)

        traces, log_weights, log_ml = jax.lax.cond(do, resample, keep, None)
        # extend every particle with this step's observation
        obs_t = jax.tree_util.tree_map(
            lambda x: jax.lax.dynamic_index_in_dim(x, t, keepdims=False),
            observations.inner)
        ext_keys = jax.random.split(k_ext, num_particles)
        traces, ws = jax.vmap(
            lambda kk, tr: arena.extend(kk, tr, obs_t))(ext_keys, traces)
        return (traces, log_weights + ws, log_ml), None

    ts = jnp.arange(1, T)
    keys = jax.random.split(k_scan, T - 1)
    (traces, log_weights, log_ml), _ = jax.lax.scan(
        step, (traces, weights, jnp.asarray(0.0)), (ts, keys))
    final_lml = log_ml + logsumexp(log_weights) - jnp.log(num_particles)
    return traces, log_weights, final_lml
