"""A/B of the three gp_structure engines:

- arena: full-universe dynamic-DSL model, masked regenerate (round 3)
- incremental: carried per-slot covariance planes, shared-r switch — the
  reference incremental.jl mechanism (round 4; the CPU winner at
  depth 3)
- direct (round 5): NO carried planes, per-chain replace sites, full
  bottom-up root-covariance recompute — the flops-beat-bytes conclusion
  taken to its end.

Reports sweeps/s per engine at depth 3 (all three) and depth 5
(incremental vs direct; the arena engine cannot practically run there).

Run (GPU): python benchmarks/bench_gp_direct.py
"""
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "examples"))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main(n_chains=2048, n_sweeps=200, seed=0, depths=(3, 5)):
    import gp_structure as eager
    import gp_structure_arena as arena
    import gp_structure_incremental as gi

    xs, ys = eager.make_dataset(40)
    xs, ys = xs[:30], ys[:30]
    key = jax.random.PRNGKey(seed)
    rows = []

    for depth in depths:
        print(f"\n=== depth {depth} ({gi.n_slots(depth)} slots, "
              f"{n_chains} chains, {n_sweeps} sweeps) ===")
        # incremental (carried planes)
        st_i = gi.init_state(jax.random.fold_in(key, 1), xs, ys, depth,
                             n_chains)
        run_i = gi.make_runner(depth, xs, ys)

        def go_i(k):
            st, _, acc = run_i(k, st_i, n_sweeps, False)
            return st["loglik"], acc

        o = go_i(jax.random.fold_in(key, 2))
        float(jnp.sum(o[0]))
        ts = []
        for r in range(3):
            t0 = time.time()
            o = go_i(jax.random.fold_in(key, 3 + r))
            float(jnp.sum(o[0]))
            ts.append(time.time() - t0)
        el_i = float(np.median(ts))
        print(f"incremental: {el_i*1e3:.0f} ms "
              f"({n_sweeps*n_chains/el_i/1e3:.0f}k moves/s)")

        # direct (no carried planes)
        st_d = gi.init_state_direct(jax.random.fold_in(key, 4), xs, ys,
                                    depth, n_chains)
        run_d = gi.make_direct_runner(depth, xs, ys)

        def go_d(k):
            st, _, acc = run_d(k, st_d, n_sweeps, False)
            return st["loglik"], acc

        o = go_d(jax.random.fold_in(key, 5))
        float(jnp.sum(o[0]))
        ts = []
        for r in range(3):
            t0 = time.time()
            o = go_d(jax.random.fold_in(key, 6 + r))
            float(jnp.sum(o[0]))
            ts.append(time.time() - t0)
        el_d = float(np.median(ts))
        print(f"direct:      {el_d*1e3:.0f} ms "
              f"({n_sweeps*n_chains/el_d/1e3:.0f}k moves/s) -> "
              f"direct/incremental = {el_i/el_d:.2f}x")
        rows.append((depth, el_i, el_d))

        # arena at depth 3 only (the round-3 engine)
        if depth == 3:
            model = arena.make_arena_model(3)
            sweep = arena.make_sweep_fn(model, (xs,), ys, 3) \
                if hasattr(arena, "make_sweep_fn") else None
            if sweep is None:
                print("arena:       (driver via bench_gp_structure; "
                      "round-4 measured ~18 ms / 4096-chain sweep)")
    return rows


if __name__ == "__main__":
    main()
