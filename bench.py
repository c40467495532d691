"""Headline benchmark: effective samples/sec for many-chain HMC on the
Bayesian regression model, plus two many-chain NUTS cells.

Prints ONE JSON line with the device it ran on (platform, device_kind,
count) and three metrics. Timings end in ``block_until_ready``; each is
the median of three runs after one run that compiles.

Formulation:
- scan-of-vmap over full HMC steps (samples written step-major).
- the likelihood is `normal_linear` (Gram-matrix sufficient statistics):
  the O(n p^2) data reduction depends only on data, so it is hoisted out
  of the sampling loop (by XLA loop-invariant motion on the scan path, by
  the partial-eval staging pass on the kernel path).
- warmup on the XLA `hmc_chains` path (flat coordinates, unrolled
  leapfrog) with stuck-chain teleport; eps jitter breaks
  trajectory-length resonances.
- the timed phase is ops/hmc_fused.py: on the GPU one Triton kernel that
  keeps each chain's state in registers across all steps, with the
  model's assess-logp scalarized into lane-vector ops (ops/scalarize.py).
Correctness gates for the same pipeline: chip_smoke.py and
benchmarks/bench_verify.py (exact-quadrature moments + split-R-hat).
"""

import json
import os
import time

import numpy as np


def autocorr_ess(x, block: int = 65536):
    """ESS summed over chains via Geyer's initial positive sequence; blocks
    over the chain axis so (steps, 524k) histories fit in host memory."""
    x = np.asarray(x)
    if x.shape[1] > block:
        return float(sum(autocorr_ess(x[:, i:i + block])
                         for i in range(0, x.shape[1], block)))
    x = np.asarray(x, dtype=np.float64)
    n, m = x.shape
    x = x - x.mean(axis=0, keepdims=True)
    # FFT autocovariance per chain
    f = np.fft.rfft(np.concatenate([x, np.zeros_like(x)], axis=0), axis=0)
    acov = np.fft.irfft(f * np.conj(f), axis=0)[:n].real / n
    var0 = acov[0]
    ok = np.isfinite(var0) & (var0 > 0)
    rho = acov / np.where(ok, var0, 1.0)[None, :]
    # consecutive-pair sums rho[2t+1] + rho[2t+2]
    n_pairs = (n - 1) // 2
    pairs = rho[1:1 + 2 * n_pairs].reshape(n_pairs, 2, m).sum(axis=1)
    # truncate each chain at its first negative pair (Geyer initial positive)
    stopped = np.cumsum(pairs < 0, axis=0) > 0
    s = np.where(stopped, 0.0, pairs).sum(axis=0)
    ess = n / (1.0 + 2.0 * s)
    ess = np.where(ok, ess, 1.0)  # degenerate (stuck) chains
    return float(ess.sum())


def _median_time(fn, reps=3):
    """Median seconds of ``fn(rep)`` over ``reps`` runs (each ended by
    block_until_ready), and the last result."""
    import jax
    times, out = [], None
    for rep in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(rep))
        times.append(time.perf_counter() - t0)
    return float(np.median(times)), out


def main():
    import jax
    import jax.numpy as jnp
    import gen_tpu as gt
    from gen_tpu import gen, choicemap, select
    from gen_tpu.inference import hmc_chains
    from gen_tpu.inference.target import FlatTarget
    from gen_tpu.utils import use_compile_cache

    use_compile_cache()
    dev = jax.devices()[0]

    n_points = 50
    xs = jnp.linspace(-3.0, 3.0, n_points)
    rng = np.random.default_rng(0)
    true_ys = 0.7 * xs - 0.4 + 0.5 * jnp.asarray(rng.standard_normal(n_points))
    X = jnp.stack([xs, jnp.ones_like(xs)], axis=1)

    @gen
    def regression_model(X):
        slope = gt.normal(0.0, 2.0) @ "slope"
        intercept = gt.normal(0.0, 2.0) @ "intercept"
        log_noise = gt.normal(0.0, 1.0) @ "log_noise"
        beta = jnp.stack([slope, intercept])
        gt.normal_linear(X, beta, jnp.exp(log_noise)) @ "ys"
        return slope

    obs = choicemap(ys=true_ys)
    sel = select("slope", "intercept", "log_noise")

    n_chains = 524288
    warmup_steps = 100
    sample_steps = 500
    L, eps = 10, 0.035

    key = jax.random.PRNGKey(0)
    k_init, k_run = jax.random.split(key)
    init_keys = jax.random.split(k_init, n_chains)

    @jax.jit
    def init(keys):
        traces, _ = jax.vmap(
            lambda k: regression_model.generate(k, (X,), obs))(keys)
        return jax.vmap(
            lambda tr: tr.get_choices().filter(sel).to_array())(traces)

    one_trace, _ = regression_model.generate(jax.random.PRNGKey(1), (X,), obs)
    target = FlatTarget(one_trace, sel)
    # flat layout is sorted-address order: find the slope slot
    paths = [p for p, _ in one_trace.get_choices().filter(sel).leaf_items()]
    slope_idx = paths.index(("slope",))

    from functools import partial

    @partial(jax.jit, static_argnums=(2, 3))
    def run(values, key, n_steps, teleport):
        return hmc_chains(
            key, target, values, n_steps=n_steps, L=L, eps=eps,
            collect=lambda v: v[:, slope_idx], teleport_after=teleport)

    values = init(init_keys)
    # warmup with stuck-chain teleport: ~18% of prior-initialized chains sit
    # in the low-noise tail where eps exceeds the leapfrog stability limit
    # and would reject forever, polluting the cross-chain posterior; teleport
    # (warmup-only) rescues them. The timed phase is pure MH.
    values, _, _ = jax.block_until_ready(
        run(values, jax.random.fold_in(k_run, 0), warmup_steps, 10))

    # timed phase: ops/hmc_fused.py (the fused kernel on the GPU)
    from gen_tpu.ops.hmc_fused import hmc_chains_fused

    def run_fused(rep):
        return hmc_chains_fused(jax.random.fold_in(k_run, 10 + rep),
                                target.logp, values, n_steps=sample_steps,
                                L=L, eps=eps, collect_idx=slope_idx)

    jax.block_until_ready(run_fused(-1))      # compile
    elapsed, (_, slopes, accs) = _median_time(run_fused)

    slopes = np.asarray(slopes)          # (steps, chains)
    accept_rate = float(np.mean(np.asarray(accs))) / sample_steps
    ess = autocorr_ess(slopes)
    ess_per_sec = ess / elapsed

    # -- second metric: the GENERAL-model engine --------------------------
    # many-chain FSM-NUTS on eight_schools (non-conjugate hierarchical,
    # d=10): NUTS chooses trajectory lengths itself, so this tracks the
    # engine a user gets for arbitrary models (sample_posterior
    # engine='auto'/'nuts_fused'), not just the fixed-L conjugate headline.
    # Validation: chip_smoke.py and benchmarks/bench_nuts_fused.py.
    nuts_ess_per_sec, nuts_unit = _nuts_fused_metric()

    # -- third metric: the same engine at d=102 (100-school eight_schools)
    s100_ess_per_sec, s100_unit = _nuts_fused_metric(
        n_chains=32768, n_schools=100)

    print(json.dumps({
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "metric": "hmc_ess_per_sec",
        "value": ess_per_sec,
        "unit": "effective samples/sec on one device (regression model, "
                f"{n_chains} chains, L={L}, accept={accept_rate:.2f}, "
                "fused HMC kernel)",
        "metric2": "nuts_fused_ess_per_sec",
        "value2": nuts_ess_per_sec,
        "unit2": nuts_unit,
        "metric3": "nuts_fused_d102_ess_per_sec",
        "value3": s100_ess_per_sec,
        "unit3": s100_unit,
    }))


def _nuts_fused_metric(n_chains=131072, n_ticks=2000, num_warmup=400,
                       n_schools=8):
    import sys
    import jax
    import jax.numpy as jnp
    from gen_tpu import choicemap, select

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "benchmarks"))
    from bench_hard_targets import (YS_8, SIGMAS_8, eight_schools,
                                    make_schools)
    from gen_tpu.inference.chees import chees_hmc_warmup_and_sample
    from gen_tpu.inference.target import FlatTarget
    from gen_tpu.ops.nuts_fused import nuts_chains_fused

    if n_schools == 8:
        ys, sigmas = YS_8, SIGMAS_8
    else:
        ys, sigmas = make_schools(n_schools, seed=0)
    sig = jnp.asarray(sigmas, jnp.float32)
    obs = choicemap(ys=jnp.asarray(ys, jnp.float32))
    sel = select("mu", "log_tau", "theta_std")
    key = jax.random.PRNGKey(0)
    k_init, k_warm, k_run, k_time = jax.random.split(key, 4)

    traces, _ = jax.jit(jax.vmap(
        lambda k: eight_schools.generate(k, (sig,), obs)))(
        jax.random.split(k_init, n_chains))
    one_trace = jax.tree_util.tree_map(lambda x: x[0], traces)
    target = FlatTarget(one_trace, sel)
    _, warm_flat, winfo = jax.jit(
        lambda trs, k: chees_hmc_warmup_and_sample(
            k, trs, sel, num_warmup=num_warmup, num_samples=1,
            target_accept=0.8))(traces, k_warm)
    eps = float(winfo["step_size"])

    def run(values, k):
        return nuts_chains_fused(
            k, target.logp, values, num_ticks=n_ticks, eps=eps,
            max_depth=8, inv_mass_diag=winfo["inv_mass"], collect_idx=0)

    values = jax.block_until_ready(run(warm_flat, k_run))[0]   # compile
    elapsed, (_, hist_t, _, _, stats) = _median_time(
        lambda rep: run(values, jax.random.fold_in(k_time, rep)))
    ess = autocorr_ess(np.asarray(hist_t))
    depth = float(np.mean(np.asarray(stats["mean_depth"])))
    unit = ("effective samples/sec on one device (many-chain FSM-NUTS, "
            f"{n_schools}-school eight_schools d={n_schools + 2}, "
            f"{n_chains} chains, {n_ticks} leapfrog slots, eps={eps:.3f}, "
            f"mean depth={depth:.1f})")
    return ess / elapsed, unit


if __name__ == "__main__":
    main()
