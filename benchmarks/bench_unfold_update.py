"""Where dense combinator updates hurt: the single-site Unfold crossover.

VERDICT round-1 weak item 5: Map/Unfold ``update`` re-runs the full
vmap/scan and relies on exact weight arithmetic — on an accelerator dense
recompute is usually right, but a SINGLE-site update on a long Unfold pays O(T) compute
where the reference's dirty-set bookkeeping (unfold/update.jl:22-113) pays
O(1). This benchmark measures exactly that tax and the framework's answer.

Three ways to move one (or every) site of a T-step AR(1) chain trace:

- ``single``: one-site MH via ``trace.update`` with a one-hot constraint —
  the dense O(T) rescan per move. Per-SITE cost grows linearly with T:
  this is the shape the reference's incremental update avoids.
- ``blocked``: ONE ``trace.update`` that re-proposes every even (then odd)
  site — the same O(T) scan now serves T/2 sites, so per-site cost is
  O(1). Exactness: even/odd sites are conditionally independent given the
  complement, so the two half-sweeps are exact block-Gibbs-style MH (the
  coal/regression examples' pattern).
- ``vmap_chains``: the dense update's native habitat — 1024 independent
  chains vmapped; per-site-per-chain cost shows the throughput the dense
  formulation buys once there is ANY batch dimension to feed the device.

Run: python benchmarks/bench_unfold_update.py        (GPU)
     python benchmarks/bench_unfold_update.py --cpu
"""

import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

if "--cpu" in sys.argv:
    import jax
    jax.config.update("jax_platforms", "cpu")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import gen_tpu as gt
from gen_tpu import gen
from gen_tpu.combinators import Unfold, vector_choicemap
from gen_tpu.inference import mh_accept, select_trace


@gen
def ar1_kernel(t, prev):
    x = gt.normal(0.9 * prev, 1.0) @ "x"
    return x


chain = Unfold(ar1_kernel)


def single_site_move(key, trace, T):
    """One-hot proposal at a uniformly chosen site; dense update."""
    ki, ku, ka = jax.random.split(key, 3)
    i = jax.random.randint(ki, (), 0, T)
    xs = trace.get_retval()
    prop = xs[i] + 0.5 * jax.random.normal(ku)
    new_xs = jnp.where(jnp.arange(T) == i, prop, xs)
    cons = vector_choicemap(T, x=new_xs)
    new_trace, w, _, _ = trace.update(None, cons)
    acc = mh_accept(ka, w)
    return select_trace(acc, new_trace, trace)


def blocked_move(key, trace, T, parity):
    """Re-propose every site of one parity in ONE dense update (exact:
    even/odd sites are conditionally independent given the rest)."""
    ku, ka = jax.random.split(key)
    xs = trace.get_retval()
    mask = (jnp.arange(T) % 2) == parity
    prop = xs + 0.5 * jax.random.normal(ku, (T,)) * mask
    new_trace, w, _, _ = trace.update(None, vector_choicemap(T, x=prop))
    acc = mh_accept(ka, w)
    return select_trace(acc, new_trace, trace)


def _timeit(f, *args, reps=20):
    out = f(*args)
    jax.tree_util.tree_leaves(out)[0].block_until_ready()
    t0 = time.time()
    for r in range(reps):
        out = f(*args)
    jax.tree_util.tree_leaves(out)[0].block_until_ready()
    return (time.time() - t0) / reps


def main(Ts=(256, 1024, 4096, 16384, 65536), n_ch=1024):
    print(f"| T | single-site ms/move | per-site (dense tax) | "
          f"blocked ms/half-sweep | per-site | vmapx{n_ch} "
          f"per-site-chain |")
    print("|---|---|---|---|---|---|")
    for T in Ts:
        key = jax.random.PRNGKey(0)
        trace = chain.simulate(key, (T, 0.0))

        single = jax.jit(lambda k, tr: single_site_move(k, tr, T))
        blocked = jax.jit(lambda k, tr: blocked_move(k, tr, T, 0))
        t_single = _timeit(single, jax.random.PRNGKey(1), trace)
        t_blocked = _timeit(blocked, jax.random.PRNGKey(2), trace)

        keys = jax.random.split(jax.random.PRNGKey(3), n_ch)
        traces = jax.vmap(lambda k: chain.simulate(k, (T, 0.0)))(keys)
        vb = jax.jit(jax.vmap(lambda k, tr: blocked_move(k, tr, T, 0)))
        t_vmap = _timeit(vb, keys, traces,
                         reps=5 if T >= 16384 else 20)

        print(f"| {T} | {t_single*1e3:.2f} | {t_single*1e3:.2f} ms "
              f"| {t_blocked*1e3:.2f} | {t_blocked*2e3/T*1e3:.1f} us "
              f"| {t_vmap*2e9/(T*n_ch):.0f} ns |")


if __name__ == "__main__":
    main()
