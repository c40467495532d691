"""GP covariance-structure learning, JITTED many-chain formulation: the
recursive PCFG kernel grammar hosted on a bounded-depth masked tree arena.

This is the fixed-shape twin of examples/gp_structure.py (reference
/root/reference/examples/gp_structure/involution_mh.jl:1-221 and
incremental.jl:1-264). The eager version is structurally general (each tree
its own pytree shape, like Gen.jl's tries) but runs at Python speed; this
version trades bounded depth for a single compiled program over any number
of vmapped chains — the accelerator-native answer to the reference's
``incremental.jl`` static-IR + diff-propagation formulation (there the win
is asymptotic reuse inside one chain; here XLA's fusion + DCE play that
role and the throughput comes from batching chains).

Design — the **full-universe arena** (same masking idea as
``gen_tpu.combinators.recurse.RecurseCombinator``, expressed directly in
the dynamic DSL):

- Every slot of the depth-``max_depth`` binary heap ALWAYS samples a node
  type and two leaf parameters, so every trace has one fixed pytree shape.
  The *active* tree is derived from the types (a slot is active iff its
  parent is active and binary). Inactive slots are prior noise: their
  density factors are independent of the data and marginalize to one, so
  the active tree's marginal law under this model is EXACTLY the truncated
  PCFG of the eager example — same posterior, fixed shapes.
- The covariance is evaluated bottom-up over the heap with branchless
  ``where``-selection per node (all six kernel forms computed, one kept) —
  no data-dependent control flow, everything elementwise.
- The subtree-replace move is GFI ``regenerate`` under a traced
  :class:`gen_tpu.MaskedSelection`: a branchless random walk picks a node
  ``r`` per chain, the selection's flags mark the whole heap region under
  ``r``, and the masked regenerate resamples exactly that region from the
  prior in ONE compiled pass (selected addresses' prior terms cancel, so
  the regenerate weight is the data log-likelihood ratio). Because the
  node-pick distribution depends on the current tree, MH needs the usual
  state-dependent-mixture correction q(r|t')/q(r|t); all pick-walk factors
  above ``r`` are unchanged by the move, so it reduces to the stop factor
  at ``r``: 1/2 if the root of the (old/new) subtree is binary, 1 if leaf
  — the same ratio the reference's involutive machinery extracts from the
  auxiliary trace (involution_mh.jl:140-148).
- The noise move is plain selection-``regenerate`` on ``"noise"`` — the
  reference's gamma(1,1) independence proposal IS the prior.

Exactness gate: at max_depth=1 the structure space has 36 elements; the
vectorized sampler's cross-chain structure frequencies are checked against
the same enumerated oracle as the eager example (TV < 0.08), and `main`
cross-checks the two samplers against each other.

Run: python examples/gp_structure_arena.py
"""

from __future__ import annotations

import math
from collections import Counter
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

import gen_tpu as gt
from gen_tpu import MaskedSelection, choicemap, gen, select
from gen_tpu.inference.common import mh_accept, select_trace

# node-type codes shared with the eager example (reference shared.jl:218-226)
CONST, LINEAR, SE, PERIODIC, PLUS, TIMES = range(6)
NODE_DIST = jnp.asarray([0.2, 0.2, 0.2, 0.2, 0.1, 0.1])
LEAF_DIST = jnp.asarray([0.25, 0.25, 0.25, 0.25, 0.0, 0.0])

LOG_HALF = math.log(0.5)


def n_slots(max_depth: int) -> int:
    """Complete binary heap, 1-based slots 1..N, children (2c, 2c+1)."""
    return 2 ** (max_depth + 1) - 1


def slot_depth(c: int) -> int:
    return c.bit_length() - 1


# -- model -------------------------------------------------------------------

def _onehot_at(idx, n):
    """(n,) one-hot of a traced 1-based slot index — arena reads use one-hot
    reductions, not gathers (dynamic_index under vmap lowers to per-element
    gathers, slow under vmap)."""
    return (jnp.arange(1, n + 1) == idx).astype(jnp.float32)


def types_at(types, idx):
    return jnp.sum(types.astype(jnp.float32) * _onehot_at(idx,
                                                          types.shape[0])
                   ).astype(types.dtype)


def active_mask(types, max_depth: int):
    """(N,) bool: slot active iff parent active and binary. Root active."""
    N = n_slots(max_depth)
    act = [None] * (N + 1)
    act[1] = jnp.asarray(True)
    for c in range(2, N + 1):
        parent = c // 2
        act[c] = act[parent] & (types[parent - 1] >= PLUS)
    return jnp.stack(act[1:])


def eval_cov_arena(types, p0, p1, xs):
    """Branchless bottom-up covariance over the heap (eager counterpart:
    examples/gp_structure.py::eval_cov_mat, reference shared.jl:45-140).
    All six kernel forms are computed per slot and one is kept by
    where-selection; division/periodic denominators are clamped away from
    zero (prob-0 parameter values otherwise turn unselected branches into
    NaN, and NaN× arithmetic — though not `where` selection — propagates)."""
    N = types.shape[0]
    d = xs[:, None] - xs[None, :]
    d2 = d * d
    ad = jnp.abs(d)
    covs = [None] * (N + 1)
    for c in range(N, 0, -1):
        t, a, b = types[c - 1], p0[c - 1], p1[c - 1]
        z = xs - a
        c_const = jnp.full_like(d, a)
        c_lin = z[:, None] * z[None, :]
        # SE and PERIODIC share ONE exp via a selected exponent —
        # transcendentals dominate this rebuild (measured: the two moves
        # cost the same ~18 ms/4096-chain sweep, i.e. the full model
        # re-evaluation, of which exp/sin on 15 x (30,30) planes is the
        # bulk), so one exp per slot instead of two is a real saving
        a_safe = jnp.maximum(a, 1e-12)
        freq = 2.0 * jnp.pi / jnp.maximum(b, 1e-12)
        expo = jnp.where(t == PERIODIC,
                         -(1.0 / a_safe) * jnp.sin(freq * ad) ** 2,
                         -0.5 * d2 / a_safe)
        c_exp = jnp.exp(expo)
        cov = (jnp.where(t == CONST, c_const, 0.0)
               + jnp.where(t == LINEAR, c_lin, 0.0)
               + jnp.where((t == SE) | (t == PERIODIC), c_exp, 0.0))
        if 2 * c + 1 <= N:
            left, right = covs[2 * c], covs[2 * c + 1]
            cov = (cov + jnp.where(t == PLUS, left + right, 0.0)
                   + jnp.where(t == TIMES, left * right, 0.0))
        covs[c] = cov
    return covs[1]


def make_arena_model(max_depth: int):
    """Full-universe arena model; args = (xs,); retval = (N,) types."""
    N = n_slots(max_depth)

    @gen
    def gp_model_arena(xs):
        types, p0s, p1s = [], [], []
        for c in range(1, N + 1):
            probs = NODE_DIST if slot_depth(c) < max_depth else LEAF_DIST
            t = gt.categorical(probs) @ (c, "type")
            a = gt.uniform(0.0, 1.0) @ (c, "p0")
            b = gt.uniform(0.0, 1.0) @ (c, "p1")
            types.append(t)
            p0s.append(a)
            p1s.append(b)
        noise = gt.gamma(1.0, 1.0) @ "noise"
        types = jnp.stack(types)
        cov = eval_cov_arena(types, jnp.stack(p0s), jnp.stack(p1s), xs)
        n = xs.shape[0]
        gt.mvnormal(jnp.zeros(n), cov + (noise + 0.01) * jnp.eye(n)) @ "ys"
        return types

    return gp_model_arena


# -- subtree-replace move ----------------------------------------------------

def pick_walk(key, types, max_depth: int):
    """Branchless random node pick (eager pick_random_node, reference
    shared.jl:238-248): at each binary node stop w.p. 1/2 else recurse to a
    uniform child; leaves stop. Returns the 1-based slot index."""
    cur = jnp.asarray(1, types.dtype)
    done = jnp.asarray(False)
    for level in range(max_depth):
        k_stop, k_dir, key = jax.random.split(key, 3)
        is_binary = types_at(types, cur) >= PLUS
        stop_now = (~is_binary) | jax.random.bernoulli(k_stop)
        go_left = jax.random.bernoulli(k_dir)
        step = (~done) & (~stop_now)
        cur = jnp.where(step, jnp.where(go_left, 2 * cur, 2 * cur + 1), cur)
        done = done | stop_now
    return cur


def region_flags(r, max_depth: int):
    """Per-slot traced flags: slot i is in the region iff r is an
    ancestor-or-self of i in the heap (pure arithmetic, no gathers)."""
    N = n_slots(max_depth)
    flags = {}
    for i in range(1, N + 1):
        anc, hit = i, jnp.asarray(False)
        for _ in range(slot_depth(i) + 1):
            hit = hit | (anc == r)
            anc //= 2
        for name in ("type", "p0", "p1"):
            flags[(i, name)] = hit
    return flags


def subtree_move(key, trace, max_depth: int):
    """One subtree-replace MH step on the arena trace (involutive-MH
    equivalent: reference involution_mh.jl:135-155)."""
    k_pick, k_regen, k_acc = jax.random.split(key, 3)
    types = trace.get_retval()
    r = pick_walk(k_pick, types, max_depth)
    sel = MaskedSelection(region_flags(r, max_depth))
    new_trace, weight, _ = trace.regenerate(k_regen, sel)
    new_types = new_trace.get_retval()
    # state-dependent pick correction: only the stop factor at r differs
    old_binary = types_at(types, r) >= PLUS
    new_binary = types_at(new_types, r) >= PLUS
    corr = (jnp.where(new_binary, LOG_HALF, 0.0)
            - jnp.where(old_binary, LOG_HALF, 0.0))
    accept = mh_accept(k_acc, weight + corr)
    return select_trace(accept, new_trace, trace), accept


NOISE_SEL = select("noise")


def noise_move(key, trace):
    """Noise MH: regenerate-from-prior == the reference's gamma(1,1)
    independence proposal (involution_mh.jl:74-78)."""
    k1, k2 = jax.random.split(key)
    new_trace, weight, _ = trace.regenerate(k1, NOISE_SEL)
    accept = mh_accept(k2, weight)
    return select_trace(accept, new_trace, trace), accept


def sweep(key, trace, max_depth: int):
    k1, k2 = jax.random.split(key)
    trace, acc = subtree_move(k1, trace, max_depth)
    trace, _ = noise_move(k2, trace)
    return trace, acc


# -- many-chain driver --------------------------------------------------------

def init_chains(key, model, xs, ys, n_chains: int):
    obs = choicemap(ys=ys)
    keys = jax.random.split(key, n_chains)
    traces, _ = jax.vmap(lambda k: model.generate(k, (xs,), obs))(keys)
    return traces


@partial(jax.jit, static_argnums=(2, 3, 4))
def run_chains(key, traces, max_depth: int, n_sweeps: int, collect: bool):
    """lax.scan of vmapped sweeps; optionally collects per-sweep masked
    skeletons (0 = inactive slot, 1..6 = active type + 1)."""
    n_chains = traces.get_retval().shape[0]

    def body(trs, k):
        ks = jax.vmap(lambda i: jax.random.fold_in(k, i))(
            jnp.arange(n_chains))
        trs, acc = jax.vmap(lambda kk, t: sweep(kk, t, max_depth))(ks, trs)
        out = None
        if collect:
            types = trs.get_retval()
            act = jax.vmap(lambda t: active_mask(t, max_depth))(types)
            out = jnp.where(act, types + 1, 0).astype(jnp.int8)
        return trs, (out, jnp.mean(acc))

    traces, (skels, accs) = jax.lax.scan(
        body, traces, jax.random.split(key, n_sweeps))
    return traces, skels, jnp.mean(accs)


# -- posterior predictive (reference shared.jl:182-200 workflow) -------------

def extract_params(traces, max_depth: int):
    """Batched (types (B, N), p0 (B, N), p1 (B, N), noise (B,)) from a
    vmapped trace population."""
    N = n_slots(max_depth)

    def one(tr):
        types = tr.get_retval()
        p0 = jnp.stack([tr[(c, "p0")] for c in range(1, N + 1)])
        p1 = jnp.stack([tr[(c, "p1")] for c in range(1, N + 1)])
        return types, p0, p1, tr["noise"]

    return jax.vmap(one)(traces)


@partial(jax.jit, static_argnums=(5,))
def posterior_predictive_mean(types, p0, p1, noise, xs, n_train, ys_train):
    """Chain-averaged GP posterior predictive mean at xs[n_train:], each
    chain using ITS OWN sampled covariance structure — the arena analogue
    of the eager example's compute_predictive."""
    n = xs.shape[0]

    def one(t, a, b, nz):
        cov = eval_cov_arena(t, a, b, xs) + (nz + 0.01) * jnp.eye(n)
        c11 = cov[:n_train, :n_train]
        c21 = cov[n_train:, :n_train]
        return c21 @ jnp.linalg.solve(c11, ys_train)

    return jnp.mean(jax.vmap(one)(types, p0, p1, noise), axis=0)


# -- skeleton encoding (oracle cross-check) ----------------------------------

def skeleton_to_key(s, max_depth: int):
    """Eager-example structure tuple -> masked-types tuple."""
    arr = np.zeros(n_slots(max_depth), np.int8)

    def fill(s, c):
        if isinstance(s, tuple):
            arr[c - 1] = s[0] + 1
            fill(s[1], 2 * c)
            fill(s[2], 2 * c + 1)
        else:
            arr[c - 1] = s + 1

    fill(s, 1)
    return tuple(arr.tolist())


def skeleton_counts(skels) -> Counter:
    """(n_sweeps, n_chains, N) int8 -> Counter over masked-types tuples."""
    flat = np.asarray(skels).reshape(-1, skels.shape[-1])
    return Counter(map(tuple, flat.tolist()))


def has_periodic(skels) -> np.ndarray:
    return np.asarray(skels == PERIODIC + 1).any(axis=-1)


# -- real data (the dataset the workload was designed for) -------------------

def load_airline(subsample: int = 3):
    """The Box & Jenkins airline-passengers series the reference's
    gp_structure example ships and loads (vendored raw at
    examples/data/airline.csv), preprocessed EXACTLY like the
    reference's loader (shared.jl:14-24): time shifted to 0 and scaled
    to [0, 1]; passengers centered on the mean and scaled by
    4/(max-min). ``subsample``
    thins the 144 monthly points for the (n, n) covariance planes (every
    3rd month keeps the annual cycle at ~4 points/period)."""
    import os
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "data", "airline.csv")
    arr = np.loadtxt(path, delimiter=",")
    xs, ys = arr[:, 0].astype(np.float64), arr[:, 1].astype(np.float64)
    xs = xs - xs.min()
    xs = xs / xs.max()
    ys = ys - ys.mean()
    ys = ys * 4.0 / (ys.max() - ys.min())
    return jnp.asarray(xs[::subsample]), jnp.asarray(ys[::subsample])


# -- drivers ------------------------------------------------------------------

def structure_posterior_arena(key, xs, ys, max_depth=1, n_chains=512,
                              n_burn=400, n_collect=200):
    model = make_arena_model(max_depth)
    k_init, k_burn, k_run = jax.random.split(key, 3)
    traces = init_chains(k_init, model, xs, ys, n_chains)
    traces, _, _ = run_chains(k_burn, traces, max_depth, n_burn, False)
    traces, skels, acc = run_chains(k_run, traces, max_depth, n_collect,
                                    True)
    counts = skeleton_counts(skels)
    total = sum(counts.values())
    return {k: v / total for k, v in counts.items()}, float(acc)


def main(seed=0):
    import gp_structure as eager

    # 1. exactness gate vs the enumerated oracle (same dataset and oracle
    #    as the eager example's gate)
    rng = np.random.default_rng(3)
    xs = jnp.asarray(np.linspace(0, 1, 12))
    ys = jnp.asarray(0.9 * (np.asarray(xs) - 0.4)
                     + 0.07 * rng.standard_normal(12))
    exact = eager.exact_structure_posterior(xs, ys, max_depth=1)
    exact_by_key = {skeleton_to_key(s, 1): p for s, p in exact.items()}
    emp, acc = structure_posterior_arena(
        jax.random.PRNGKey(seed), xs, ys, max_depth=1)
    tv = 0.5 * sum(abs(emp.get(k, 0.0) - p)
                   for k, p in exact_by_key.items())
    tv += 0.5 * sum(p for k, p in emp.items() if k not in exact_by_key)
    print(f"arena sampler: mean subtree accept {acc:.3f}")
    print(f"TV(arena-sampled, enumerated-exact) over 36 structures: "
          f"{tv:.3f}")
    assert tv < 0.08, tv

    # 2. cross-check vs the eager sampler on the same data (the two
    #    formulations target the identical posterior)
    _, structs = eager.run_chain(jax.random.PRNGKey(seed + 1), xs, ys,
                                 max_depth=1, n_sweeps=4000)
    ec = Counter(skeleton_to_key(s, 1) for s in structs)
    etot = sum(ec.values())
    tv_x = 0.5 * sum(abs(emp.get(k, 0.0) - ec.get(k, 0) / etot)
                     for k in set(emp) | set(ec))
    print(f"TV(arena, eager sampler): {tv_x:.3f}")
    assert tv_x < 0.2, tv_x          # eager chain is short + autocorrelated

    # 3. the real workload: depth-3 grammar on periodic+trend data — the
    #    posterior must discover a periodic component
    xs3, ys3 = eager.make_dataset(40)
    emp3, acc3 = structure_posterior_arena(
        jax.random.PRNGKey(seed + 2), xs3[:30], ys3[:30], max_depth=3,
        n_chains=256, n_burn=600, n_collect=200)
    frac_per = sum(p for k, p in emp3.items()
                   if (PERIODIC + 1) in k)
    print(f"depth-3 arena run: subtree accept {acc3:.3f}, "
          f"fraction containing PERIODIC: {frac_per:.2%}")
    assert frac_per > 0.5, frac_per

    # 4. posterior predictive on the held-out tail, averaged over the
    #    chain population's sampled structures (reference
    #    shared.jl:182-200) — must beat the predict-the-mean baseline
    model3 = make_arena_model(3)
    k_i, k_b = jax.random.split(jax.random.PRNGKey(seed + 3))
    trs = init_chains(k_i, model3, xs3[:30], ys3[:30], 128)
    trs, _, _ = run_chains(k_b, trs, 3, 500, False)
    types, p0, p1, noise = extract_params(trs, 3)
    mu = posterior_predictive_mean(types, p0, p1, noise, xs3, 30,
                                  ys3[:30])
    mse = float(jnp.mean((mu - ys3[30:]) ** 2))
    base = float(jnp.mean((ys3[30:] - jnp.mean(ys3[:30])) ** 2))
    print(f"held-out predictive MSE: {mse:.4f} "
          f"(mean-baseline {base:.4f})")
    assert mse < 0.5 * base, (mse, base)
    print("gp_structure_arena example OK")


if __name__ == "__main__":
    main()
