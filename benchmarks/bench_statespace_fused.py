"""Collapsed state-space-model HMC in the fused HMC kernel.

The scalarize pass (unrolled scan / cholesky / triangular_solve) stages
the exact Kalman-filter marginal likelihood — a ``lax.scan`` of matmuls,
Cholesky factorizations and triangular solves — into ops/hmc_fused.py, so
the Rao-Blackwellized PMMH workload (reference examples/pmmh:
AR(1)-plus-noise hyperparameter posterior; our collapsed formulation has
zero pseudo-marginal variance) runs with every chain's entire T-step
filter recursion unrolled inside one kernel.

Evidence standard (bench_verify): cross-chain moments of the final chain
population vs an EXACT 3-D quadrature of the collapsed posterior (the
whole parameter space is (phi, log_q, log_r), so quadrature is the gold
standard — each grid node evaluates the exact Kalman log-marginal), plus
rank-normalized split-R-hat on a separate multi-draw run, plus an XLA
same-model comparison for the kernel speedup.

Run (GPU): python benchmarks/bench_statespace_fused.py
Quick CPU check: python benchmarks/bench_statespace_fused.py --small
"""

import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import gen_tpu as gt
from gen_tpu import choicemap, gen, select
from gen_tpu.models import lgssm

T_STEPS = 100
PHI_TRUE, Q_TRUE, R_TRUE = 0.8, 0.3, 0.5


def make_model(T):
    like = lgssm(T)
    eye1 = jnp.eye(1, dtype=jnp.float32)
    z1 = jnp.zeros(1, jnp.float32)

    @gen
    def ar1_model(stationary_var_cap):
        phi = gt.normal(0.0, 1.0) @ "phi"
        log_q = gt.normal(-1.0, 1.0) @ "log_q"
        log_r = gt.normal(-1.0, 1.0) @ "log_r"
        A = phi * eye1
        Q = jnp.exp(log_q) * eye1
        R = jnp.exp(log_r) * eye1
        like(A, Q, eye1, R, z1, stationary_var_cap * eye1) @ "ys"
        return phi

    return ar1_model


def make_dataset(T=T_STEPS, seed=0):
    rng = np.random.default_rng(seed)
    x = 0.0
    ys = np.empty((T, 1), np.float32)
    for t in range(T):
        x = (PHI_TRUE * x if t else 0.0) + np.sqrt(Q_TRUE) * rng.standard_normal()
        ys[t, 0] = x + np.sqrt(R_TRUE) * rng.standard_normal()
    return jnp.asarray(ys)


def quadrature_exact(model, args, ys, n_grid=81):
    """Exact posterior moments of (phi, log_q, log_r) by dense 3-D
    quadrature of the collapsed logp (assess through the GFI)."""
    phi_g = np.linspace(-2.0, 2.0, n_grid)
    lq_g = np.linspace(-7.0, 2.5, n_grid)
    lr_g = np.linspace(-7.0, 2.5, n_grid)
    P, LQ, LR = np.meshgrid(phi_g, lq_g, lr_g, indexing="ij")
    pts = jnp.asarray(np.stack([P, LQ, LR], -1).reshape(-1, 3), jnp.float32)

    def logp(v):
        cm = choicemap(phi=v[0], log_q=v[1], log_r=v[2], ys=ys)
        w, _ = model.assess(args, cm)
        return w

    lps = []
    B = 65536
    f = jax.jit(jax.vmap(logp))
    for i in range(0, pts.shape[0], B):
        lps.append(np.asarray(f(pts[i:i + B]), np.float64))
    lp = np.concatenate(lps).reshape(n_grid, n_grid, n_grid)
    w = np.exp(lp - lp.max())
    # posterior mass must be interior to the grid
    edge = max(w[0].max(), w[-1].max(), w[:, 0].max(), w[:, -1].max(),
               w[:, :, 0].max(), w[:, :, -1].max())
    assert edge < 1e-6 * w.max(), f"quadrature grid clips posterior: {edge}"
    w /= w.sum()
    out = {}
    for name, G in (("phi", P), ("log_q", LQ), ("log_r", LR)):
        m = float((w * G).sum())
        sd = float(np.sqrt((w * G * G).sum() - m * m))
        out[(name,)] = (m, sd)
    return out


def main(small=False):
    if small:
        jax.config.update("jax_platforms", "cpu")
    from bench_hard_targets import run_target

    T = T_STEPS // (4 if small else 1)
    model = make_model(T)
    ys = make_dataset(T)
    args = (jnp.float32(2.0),)
    print(f"AR(1)+noise, T={T}: computing exact quadrature reference...")
    t0 = time.time()
    exact = quadrature_exact(model, args, ys, n_grid=61 if small else 121)
    print(f"quadrature {time.time()-t0:.1f}s:",
          {k[0]: (round(m, 3), round(s, 3)) for k, (m, s) in exact.items()})

    row = run_target(
        "collapsed_ar1_kalman_T%d" % T, model, args, choicemap(ys=ys),
        select("phi", "log_q", "log_r"), exact, ("phi",),
        n_chains=131072 // (64 if small else 1),
        n_steps=500 // (2 if small else 1), num_warmup=400,
        rhat_chains=2048 // (8 if small else 1),
        # ChEES picks L=1 here (near-Langevin), so the convergence
        # diagnostic needs a long run (R-hat ~1.02 at 1000 steps)
        rhat_steps=1000 if small else 12000)

    # XLA same-model comparison at the same chain count (kernel speedup)
    from gen_tpu.inference.hmc import hmc_chains
    from gen_tpu.inference.target import FlatTarget
    import bench as B
    key = jax.random.PRNGKey(1)
    n_x = 8192 // (64 if small else 1)
    ks = jax.random.split(jax.random.fold_in(key, 0), n_x)
    traces, _ = jax.jit(jax.vmap(
        lambda k: model.generate(k, args, choicemap(ys=ys))))(ks)
    one = jax.tree_util.tree_map(lambda x: x[0], traces)
    target = FlatTarget(one, select("phi", "log_q", "log_r"))
    flat = jax.vmap(lambda tr: tr.get_choices().filter(
        select("phi", "log_q", "log_r")).to_array())(traces)

    @jax.jit
    def run_xla(v, k):
        return hmc_chains(k, target, v, n_steps=100, L=row["L"],
                          eps=row["eps"])
    v, h, _ = run_xla(flat, jax.random.fold_in(key, 1))
    float(jnp.sum(h[-1]))
    t0 = time.time()
    v, h, _ = run_xla(v, jax.random.fold_in(key, 2))
    float(jnp.sum(h[-1]))
    el = time.time() - t0
    xla_rate = n_x * 100 * row["L"] / el
    fused_rate = (500 // (2 if small else 1)) * row["L"] * \
        (131072 // (64 if small else 1)) / (row["us_per_step"] * 1e-6 *
                                            (500 // (2 if small else 1)))
    print(f"XLA hmc_chains @ {n_x} chains: {el*1e3:.0f} ms "
          f"-> {xla_rate/1e6:.2f}M Kalman-leapfrog-grads/s; "
          f"fused: {fused_rate/1e6:.2f}M "
          f"({fused_rate/xla_rate:.1f}x, at {131072//(64 if small else 1)} "
          "chains)")
    print("PASS" if row["ok"] else "FAIL")
    return 0 if row["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main(small="--small" in sys.argv))
