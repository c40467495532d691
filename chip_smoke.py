"""Smoke run of gen_tpu on NVIDIA GPUs: the main sampling paths at full
width, each checked against an exact or plain reference.

    python chip_smoke.py               # one card: phases 1-5
    python chip_smoke.py --four-cards  # four cards: the multi-device paths

One process; the only child it starts is ``nvidia-smi``. Phases, each
printing one line (what ran, its size, its gates with value and limit,
wall time):

1. device: JAX must report a GPU, else the script exits non-zero;
2. the fused HMC kernel against the XLA sampler ``hmc_chains`` on the same
   injected randomness (a control run beside it shows what an error of
   known size reads), then both timed at the headline size;
3. the HMC headline (robust-regression model, 524,288 chains): moments
   against quadrature, split R-hat on the kernel's own draws;
   3b. ``sample_posterior(engine="hmc_fused")`` on both sides of the
   kernel's d-rule: moments and split R-hat;
4. ``sample_posterior(engine="auto")`` NUTS on eight_schools (d=10) and
   the 100-school model (d=102): moments against quadrature, split R-hat;
5. genealogy SMC on a linear-Gaussian SSM at 2^20 particles: log-ML
   against the Kalman filter, and the three resampling formulations timed.

``--four-cards`` runs instead the multi-device paths on a 1-D mesh of 4
devices, each against its one-device run: ``sample_posterior(mesh=...)``,
the NUTS engine on identical inputs, the fused kernel under ``shard_map``,
and particle-sharded SMC with the gather and ring exchanges.

Any failed gate or exception exits non-zero. The last line of a passing
run is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))


class GateFailure(RuntimeError):
    pass


class Gates:
    """Collects ``name value (op) limit`` checks; raises on the first
    failure when ``strict`` (the script), records only when not (the CPU
    tests of the phase functions at tiny sizes)."""

    def __init__(self, strict: bool = True):
        self.strict = strict
        self.rows = []

    def check(self, name, value, limit, ok=None, op="<="):
        value = float(value)
        if ok is None:
            ok = value <= limit if op == "<=" else value >= limit
        ok = bool(ok) and np.isfinite(value)
        self.rows.append((name, value, limit, ok))
        if self.strict and not ok:
            raise GateFailure(f"gate {name}: {value!r} {op} {limit!r} failed")
        return f"{name} {value:.6g} {op} {limit:g} {'ok' if ok else 'FAIL'}"


def _line(phase, what, size, gates, seconds, extra=""):
    print(f"phase {phase} | {what} | {size} | {'; '.join(gates)}"
          f"{' | ' + extra if extra else ''} | {seconds:.1f} s", flush=True)


def _block(x):
    import jax
    return jax.block_until_ready(x)


def _timed(fn, reps=3):
    """(compile+first seconds, median steady seconds, last result)."""
    t0 = time.perf_counter()
    out = _block(fn(0))
    first = time.perf_counter() - t0
    times = []
    for r in range(reps):
        t0 = time.perf_counter()
        out = _block(fn(r + 1))
        times.append(time.perf_counter() - t0)
    return first, float(np.median(times)), out


# -- shared model pieces -----------------------------------------------------

def _paths():
    for p in (HERE, os.path.join(HERE, "benchmarks")):
        if p not in sys.path:
            sys.path.insert(0, p)


def regression_setup():
    """The headline robust-regression model (bench.py), its flat target,
    prior initializer and exact posterior moments (quadrature)."""
    _paths()
    import jax
    import jax.numpy as jnp
    import gen_tpu as gt
    from gen_tpu import choicemap, gen, select
    from gen_tpu.inference.target import FlatTarget
    from bench_verify import exact_posterior_moments

    xs = jnp.linspace(-3.0, 3.0, 50)
    rng = np.random.default_rng(0)
    ys = 0.7 * xs - 0.4 + 0.5 * jnp.asarray(rng.standard_normal(50))
    X = jnp.stack([xs, jnp.ones_like(xs)], axis=1)

    @gen
    def regression_model(X):
        slope = gt.normal(0.0, 2.0) @ "slope"
        intercept = gt.normal(0.0, 2.0) @ "intercept"
        log_noise = gt.normal(0.0, 1.0) @ "log_noise"
        gt.normal_linear(X, jnp.stack([slope, intercept]),
                         jnp.exp(log_noise)) @ "ys"
        return slope

    obs = choicemap(ys=ys)
    sel = select("slope", "intercept", "log_noise")
    one, _ = regression_model.generate(jax.random.PRNGKey(1), (X,), obs)
    target = FlatTarget(one, sel)
    paths = [p[0] for p, _ in one.get_choices().filter(sel).leaf_items()]
    mb, sb, ml, sl = exact_posterior_moments(X, ys)
    exact = {"slope": (mb[0], sb[0]), "intercept": (mb[1], sb[1]),
             "log_noise": (ml, sl)}
    mean = np.array([exact[p][0] for p in paths], np.float32)
    sd = np.array([exact[p][1] for p in paths], np.float32)

    @jax.jit
    def init(keys):
        trs, _ = jax.vmap(lambda k: regression_model.generate(
            k, (X,), obs))(keys)
        return jax.vmap(lambda t: t.get_choices().filter(sel).to_array())(
            trs)

    return target, paths, mean, sd, init


def _moment_gates(g, vv, names, mean, sd, mean_tol, sd_tol):
    out = []
    m, s = vv.mean(axis=0), vv.std(axis=0)
    dm = np.abs(m - mean) / sd
    ds = np.abs(s / sd - 1.0)
    out.append(g.check(f"max|dmean|/sd({names})", dm.max(), mean_tol))
    out.append(g.check(f"max|sd/sd_exact-1|({names})", ds.max(), sd_tol))
    return out


def _rhat_worst(hist):
    """Worst split R-hat (rank-normalized) over the coordinates of a
    (draws, chains, d) history; non-finite counts as a failure."""
    import jax
    import jax.numpy as jnp
    from gen_tpu.diagnostics import rhat
    vals = np.asarray(jax.jit(lambda h: jax.lax.map(
        rhat, jnp.moveaxis(h, 2, 0)))(jnp.asarray(hist)))
    return max(v if np.isfinite(v) else np.inf for v in vals)


def _rhat_gate(g, hist, label, limit=1.01):
    return g.check(f"split-rhat({label})", _rhat_worst(hist), limit)


# -- phases --------------------------------------------------------------------

def phase_device(four_cards=False):
    import jax
    if jax.default_backend() != "gpu":
        sys.stderr.write(f"chip_smoke: JAX found no GPU (backend "
                         f"{jax.default_backend()!r}); nothing was run\n")
        raise SystemExit(2)
    from gen_tpu.utils import use_compile_cache
    cache = use_compile_cache()
    devs = jax.devices()
    want = 4 if four_cards else 1
    if len(devs) < want:
        sys.stderr.write(f"chip_smoke: {want} GPUs needed, JAX sees "
                         f"{len(devs)}\n")
        raise SystemExit(2)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    print(f"phase 1 | device | {devs[0].platform} {devs[0].device_kind} x "
          f"{len(devs)} | jax {jax.__version__} | compile cache {cache}",
          flush=True)
    for line in smi:                      # name, power limit, as printed
        print(line, flush=True)
    return dict(platform=devs[0].platform, kind=devs[0].device_kind,
                count=len(devs))


def _injected(key, n_steps, n, d, eps, jitter=0.2):
    import jax
    import jax.numpy as jnp
    ks = jax.random.split(key, 3)
    eps_steps = eps * (1.0 - jitter + 2.0 * jitter
                       * jax.random.uniform(ks[0], (n_steps,)))
    z = jax.random.normal(ks[1], (n_steps, n, d))
    u = jnp.maximum(jax.random.uniform(ks[2], (n_steps, n)), 1e-30)
    return eps_steps, z, u


def _decisions(values0, coll):
    """Per-step accept decisions from an all-coordinate history: a step
    accepted iff the position moved (continuous proposals)."""
    prev = np.concatenate([np.asarray(values0)[None], np.asarray(coll)[:-1]])
    return np.any(np.asarray(coll) != prev, axis=2)


def _compare(values0, coll_a, coll_b):
    """Two all-coordinate histories of the same chains: (max |dx| over the
    chains whose accept decisions all agree, number of differing
    decisions, fraction of chains with equal decisions)."""
    dec_a, dec_b = _decisions(values0, coll_a), _decisions(values0, coll_b)
    same = np.all(dec_a == dec_b, axis=0)
    dx = float(np.max(np.abs(np.asarray(coll_a) - np.asarray(coll_b))
                      [:, same])) if same.any() else np.inf
    return dx, int(np.sum(dec_a != dec_b)), float(same.mean())


# Phase 2's exactness limits lie between the kernel's readings against the
# XLA sampler and those of a control: the XLA sampler against itself with
# its log density off by a relative CONTROL_REL, a stand-in for a kernel
# error of that size. On one H100: max |dx| 2.86e-6 (control 1.24e-3),
# 6 differing decisions (control 116). Each run prints both readings
# beside the limits.
CONTROL_REL = 1e-4
KERNEL_DX_LIMIT = 3e-5
KERNEL_FLIPS_LIMIT = 25


def phase_kernel(g, n_exact=65536, exact_steps=20, n_time=524288,
                 time_steps=500, L=10, eps=0.035, reps=3, interpret=False):
    """Kernel vs XLA: exactness on injected randomness, with the control
    beside it, then times."""
    import copy
    import jax
    import jax.numpy as jnp
    from gen_tpu.inference.hmc import hmc_chains
    from gen_tpu.ops.hmc_fused import hmc_chains_fused
    t_start = time.perf_counter()
    target, paths, mean, sd, _ = regression_setup()
    d = len(paths)
    key = jax.random.PRNGKey(11)
    v0 = jnp.asarray(mean + 0.5 * sd * np.random.default_rng(1)
                     .standard_normal((n_exact, d)), jnp.float32)
    draws = _injected(key, exact_steps, n_exact, d, eps)
    _, coll_k, _ = hmc_chains_fused(
        key, target.logp, v0, n_steps=exact_steps, L=L, eps=eps,
        collect_idx=None, injected_rng=draws, interpret=interpret)

    def xla(tgt):
        return jax.jit(lambda v, dr: hmc_chains(
            key, tgt, v, n_steps=exact_steps, L=L, eps=eps, draws=dr)[1])(
                v0, draws)

    control = copy.copy(target)
    control.value_and_grad = jax.value_and_grad(
        lambda x: (1.0 + CONTROL_REL) * target.logp(x))
    coll_r = xla(target)
    dx, flips, same = _compare(v0, coll_k, coll_r)
    dx_c, flips_c, _ = _compare(v0, xla(control), coll_r)
    gates = [
        g.check(f"max|dx| (chains with equal decisions; control {dx_c:.3g})",
                dx, KERNEL_DX_LIMIT),
        g.check(f"differing accept decisions (control {flips_c})", flips,
                KERNEL_FLIPS_LIMIT),
        g.check("chains with equal decisions (fraction)", same, 0.99,
                op=">="),
    ]
    _line(2, "fused HMC kernel vs hmc_chains (XLA), injected randomness",
          f"{n_exact} chains d={d} {exact_steps} steps L={L}", gates,
          time.perf_counter() - t_start,
          "f32 both sides, XLA dots at precision HIGHEST; the kernel's "
          "staged logp sums in another order than XLA's Gram form; control:"
          f" the XLA sampler with its log density scaled by 1+{CONTROL_REL:g}")

    t_start = time.perf_counter()
    vt = jnp.asarray(mean + 0.5 * sd * np.random.default_rng(2)
                     .standard_normal((n_time, d)), jnp.float32)
    ci = paths.index("slope")
    run_k = lambda r: hmc_chains_fused(
        jax.random.PRNGKey(r), target.logp, vt, n_steps=time_steps, L=L,
        eps=eps, collect_idx=ci, interpret=interpret)
    run_x = jax.jit(lambda v, k: hmc_chains(
        k, target, v, n_steps=time_steps, L=L, eps=eps,
        collect=lambda x: x[:, ci]))
    ck, tk, _ = _timed(run_k, reps)
    cx, tx, _ = _timed(lambda r: run_x(vt, jax.random.PRNGKey(r)), reps)
    _line(2, "time: kernel vs XLA (median of 3, block_until_ready)",
          f"{n_time} chains x {time_steps} steps L={L}",
          [f"kernel {tk * 1e6 / time_steps:.1f} us/step",
           f"XLA {tx * 1e6 / time_steps:.1f} us/step",
           f"XLA/kernel {tx / tk:.2f}x"],
          time.perf_counter() - t_start,
          f"compile+first: kernel {ck:.1f} s, XLA {cx:.1f} s")
    return dict(kernel_s=tk, xla_s=tx, dx=dx, flips=flips, dx_control=dx_c,
                flips_control=flips_c)


def hmc_warmup(target, L=10, eps=0.035):
    """The headline's warmup, jitted: ``warm(values, key, n)`` runs ``n``
    ``hmc_chains`` steps, teleporting chains stuck for 10 steps."""
    import jax
    from functools import partial
    from gen_tpu.inference.hmc import hmc_chains

    @partial(jax.jit, static_argnums=2)
    def warm(values, key, n):
        v, _, _ = hmc_chains(key, target, values, n_steps=n, L=L, eps=eps,
                             collect=lambda x: 0.0, teleport_after=10)
        return v
    return warm


def phase_hmc(g, n_chains=524288, warmup=100, steps=500, L=10, eps=0.035,
              rhat_chains=8192, rhat_steps=500, interpret=False):
    """The HMC headline: warmup on hmc_chains, sampling in the kernel."""
    import jax
    import jax.numpy as jnp
    from gen_tpu.ops.hmc_fused import hmc_chains_fused
    _paths()
    from bench import autocorr_ess
    t_start = time.perf_counter()
    target, paths, mean, sd, init = regression_setup()
    warm = hmc_warmup(target, L, eps)
    ci = paths.index("slope")

    def sample(values, key, collect_idx):
        return hmc_chains_fused(key, target.logp, values, n_steps=steps,
                                L=L, eps=eps, collect_idx=collect_idx,
                                interpret=interpret)

    k0 = jax.random.PRNGKey(0)
    values = warm(init(jax.random.split(k0, n_chains)),
                  jax.random.fold_in(k0, 1), warmup)
    _block(sample(values, jax.random.fold_in(k0, 2), ci))   # compile
    t0 = time.perf_counter()
    values, slopes, accs = _block(sample(values, jax.random.fold_in(k0, 3),
                                         ci))
    t_sample = time.perf_counter() - t0
    gates = _moment_gates(g, np.asarray(values, np.float64), "all", mean,
                          sd, 0.03, 0.03)
    # R-hat chains follow the headline's own path: warmup, one kernel
    # pass (the headline's compile run), then the collected kernel pass
    vals = warm(init(jax.random.split(jax.random.fold_in(k0, 4),
                                      rhat_chains)),
                jax.random.fold_in(k0, 5), warmup)
    vals, _, _ = sample(vals, jax.random.fold_in(k0, 7), 0)
    _, hist, _ = sample(vals, jax.random.fold_in(k0, 6), None)
    gates.append(_rhat_gate(g, np.asarray(hist)[:rhat_steps], "kernel draws"))
    ess = autocorr_ess(np.asarray(slopes))
    accept = float(jnp.mean(accs)) / steps
    _line(3, "HMC headline: hmc_chains warmup + fused kernel sampling",
          f"{n_chains} chains d={len(paths)} L={L} {warmup}+{steps} steps; "
          f"R-hat on {rhat_chains} chains x {rhat_steps} kernel draws after "
          f"{warmup}+{steps} steps", gates,
          time.perf_counter() - t_start,
          f"sampling {t_sample:.3f} s, accept {accept:.3f}, slope ESS "
          f"{ess:.6g}, ESS/s {ess / t_sample:.6g}")
    return dict(sample_s=t_sample, ess=ess)


def schools_problem(K):
    """eight_schools on K schools (the classic data at K=8, otherwise
    ``make_schools(K)``): model arguments, observations, flat coordinate
    names, exact posterior mean and sd by coordinate, flat target."""
    _paths()
    import jax
    import jax.numpy as jnp
    from gen_tpu import choicemap, select
    from gen_tpu.inference.target import FlatTarget
    from bench_hard_targets import (SIGMAS_8, YS_8, eight_schools,
                                    make_schools, schools_exact)
    ys, sig = (YS_8, SIGMAS_8) if K == 8 else make_schools(K, seed=0)
    exact = schools_exact(ys, sig)
    sig_j = jnp.asarray(sig, jnp.float32)
    obs = choicemap(ys=jnp.asarray(ys, jnp.float32))
    one, _ = eight_schools.generate(jax.random.PRNGKey(0), (sig_j,), obs)
    sel = select("mu", "log_tau", "theta_std")
    names = [p[0] for p, _ in one.get_choices().filter(sel).leaf_items()]
    mean = np.concatenate([np.atleast_1d(exact[(nm,)][0]) for nm in names])
    sd = np.concatenate([np.atleast_1d(exact[(nm,)][1]) for nm in names])
    return dict(model=eight_schools, args=(sig_j,), obs=obs, names=names,
                mean=mean, sd=sd, target=FlatTarget(one, sel))


def _flat_draws(samples, names):
    """(draws, chains, d) flat draws in FlatTarget layout order."""
    parts = []
    for nm in names:
        a = np.asarray(samples[nm], np.float64)
        parts.append(a.reshape(a.shape[0], a.shape[1], -1))
    return np.concatenate(parts, axis=2)


def phase_hmc_fused(g, sizes=((6, 32768), (8, 32768)), warmup=400,
                    samples=500):
    """sample_posterior(engine='hmc_fused') on the schools family, one size
    on each side of the kernel's d-rule: moments against quadrature and
    split R-hat of its draws; prints the route that ran."""
    import jax
    from gen_tpu.inference import sample_posterior
    from gen_tpu.ops.backend import HMC_KERNEL_MAX_D, hmc_kernel_route
    for K, n in sizes:
        t_start = time.perf_counter()
        sp = schools_problem(K)
        out = sample_posterior(jax.random.PRNGKey(K), sp["model"],
                               sp["args"], sp["obs"], num_chains=n,
                               num_warmup=warmup, num_samples=samples,
                               engine="hmc_fused")
        flat = _flat_draws(out.samples, sp["names"])
        t_call = time.perf_counter() - t_start
        d = flat.shape[2]
        route = "kernel" if hmc_kernel_route(d) else "XLA sampler"
        gates = _moment_gates(g, flat.reshape(-1, d), "all", sp["mean"],
                              sp["sd"], 0.05, 0.05)
        gates.append(_rhat_gate(g, flat, "draws"))
        _line("3b", f"sample_posterior(engine='hmc_fused') -> {route} "
                    f"(the kernel serves d <= {HMC_KERNEL_MAX_D})",
              f"schools K={K} d={d} {n} chains, warmup {warmup}, {samples} "
              "draws", gates, time.perf_counter() - t_start,
              f"call {t_call:.1f} s; eps {out.info['step_size']:.4g}, "
              f"L {out.info['num_leapfrogs']}, accept "
              f"{float(out.info['mean_accept']):.3f}")


def phase_nuts(g, sizes=((8, 131072, 0), (100, 32768, 24000)), warmup=400,
               ticks=2000, reps=3, mesh=None, rhat_chains=2048, where=""):
    """sample_posterior(engine='auto') NUTS on the schools models: moments
    and split R-hat of its draws, then the engine's us per tick from the
    final draws (on ``mesh`` when given). Sizes are (K, chains, more
    ticks). With more ticks, R-hat is gated on the draws of
    ``rhat_chains`` of the chains followed by the draws those chains
    complete in that many further ticks of the same engine (same step
    size and mass): split R-hat exceeds 1 by about tau / draws per chain,
    and at d=102 the 2,000-tick run completes ~123 draws per chain. The
    R-hat of the draws alone and its fall along the continued history are
    printed beside the gate."""
    import jax
    import jax.numpy as jnp
    from gen_tpu.inference import sample_posterior
    from gen_tpu.ops.nuts_fused import (extract_completed_draws,
                                        nuts_chains_fused)
    results = []
    for K, n, more in sizes:
        t_start = time.perf_counter()
        sp = schools_problem(K)
        kw = dict(num_chains=n, num_warmup=warmup, num_ticks=ticks,
                  num_samples=ticks, engine="auto")
        if mesh is not None:
            kw["mesh"] = mesh
        t0 = time.perf_counter()
        out = sample_posterior(jax.random.PRNGKey(K), sp["model"],
                               sp["args"], sp["obs"], **kw)
        _block(out.samples)
        t_call = time.perf_counter() - t0
        flat = _flat_draws(out.samples, sp["names"])     # (m, n, d)
        m0, d = flat.shape[0], flat.shape[2]
        gates = [g.check("engine is nuts_fused",
                         out.info["engine"] == "nuts_fused", 1, op=">=")]
        gates += _moment_gates(g, flat.reshape(-1, d), "all", sp["mean"],
                               sp["sd"], 0.05, 0.05)
        target = sp["target"]
        eps = float(out.info["step_size"])
        inv_m = out.info["inv_mass"]
        rh_draws = _rhat_worst(flat)
        note = ""
        if not more:
            gates.append(g.check("split-rhat(draws)", rh_draws, 1.01))
        else:
            rc = min(rhat_chains, n)
            _, hist, hcnt, cnt, _ = nuts_chains_fused(
                jax.random.PRNGKey(50 + K), target.logp,
                jnp.asarray(flat[-1, :rc], jnp.float32), num_ticks=more,
                eps=eps, inv_mass_diag=inv_m, collect_idx=None)
            m = int(jnp.min(cnt))
            cont = np.asarray(extract_completed_draws(hist, hcnt, m),
                              np.float64)
            del hist
            hist_all = np.concatenate([flat[:, :rc], cont], axis=0)
            seq = [(k, _rhat_worst(hist_all[:k]))
                   for k in (m0, m0 + m // 4, m0 + m // 2, m0 + m)]
            gates.append(g.check(f"split-rhat(draws + {more} more ticks)",
                                 seq[-1][1], 1.01))
            note = (f"; R-hat of the draws alone {rh_draws:.4f}; along "
                    f"the continued history of {rc} chains: " + ", ".join(
                        f"{k} draws {r:.4f}" for k, r in seq))
        # us per tick: the same engine timed alone from the final draws
        v_last = jnp.asarray(flat[-1], jnp.float32)
        if mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec as P
            v_last = jax.device_put(v_last, NamedSharding(
                mesh, P(mesh.axis_names[0])))
        run = lambda r: nuts_chains_fused(
            jax.random.PRNGKey(100 + r), target.logp, v_last,
            num_ticks=ticks, eps=eps, inv_mass_diag=inv_m)
        c, t_run, res = _timed(run, reps)
        depth = float(jnp.mean(res[4]["mean_depth"]))
        _line(4, f"NUTS sample_posterior(engine='auto') -> "
                 f"{out.info['engine']}{where}",
              f"schools K={K} d={d} {n} chains, warmup {warmup}, {ticks} "
              f"ticks, {m0} draws/chain", gates,
              time.perf_counter() - t_start,
              f"call {t_call:.1f} s; {t_run * 1e6 / ticks:.1f} us/tick "
              f"(median of {reps}, compile+first {c:.1f} s); mean depth "
              f"{depth:.2f}; eps {eps:.4g}{note}")
        results.append(dict(K=K, us_per_tick=t_run * 1e6 / ticks,
                            samples=out.samples, names=sp["names"],
                            sd=sp["sd"], eps=eps, inv_mass=inv_m,
                            v_last=jnp.asarray(flat[-1], jnp.float32),
                            target=target))
    return results


def lgssm_setup(T=100, seed=0):
    """A 2-state, 1-observation linear-Gaussian SSM, its simulated data
    and exact Kalman log-ML."""
    import jax.numpy as jnp
    import gen_tpu as gt
    from gen_tpu.models.lgssm import LGSSMParams, kalman_filter
    A = np.array([[0.9, 0.2], [-0.1, 0.8]])
    Q = np.array([[0.2, 0.05], [0.05, 0.1]])
    C = np.array([[1.0, 0.5]])
    R = np.array([[0.5]])
    mu0, P0 = np.zeros(2), np.eye(2)
    rng = np.random.default_rng(seed)
    x = rng.multivariate_normal(mu0, P0)
    ys = []
    for t in range(T):
        if t:
            x = A @ x + rng.multivariate_normal(np.zeros(2), Q)
        ys.append(C @ x + rng.multivariate_normal(np.zeros(1), R))
    ys = jnp.asarray(np.array(ys), jnp.float32)
    params = LGSSMParams(*(jnp.asarray(m, jnp.float32)
                           for m in (A, Q, C, R, mu0, P0)))
    exact = float(kalman_filter(params, ys).log_ml)
    return params, gt.vector_choicemap(T, y=ys), exact


def phase_smc(g, n=2 ** 20, T=100, seeds=4, resample_ns=(2 ** 12, 2 ** 16,
                                                         2 ** 20), reps=3):
    """Genealogy SMC log-ML vs Kalman; resampling formulations timed."""
    import jax
    import jax.numpy as jnp
    from gen_tpu.inference.smc import smc_genealogy
    from gen_tpu.models.lgssm import lgssm_kernel
    from gen_tpu.ops import resample as rs
    t_start = time.perf_counter()
    params, obs, exact = lgssm_setup(T)
    run = jax.jit(lambda k: smc_genealogy(
        k, lgssm_kernel, jnp.zeros(2, jnp.float32), tuple(params), obs,
        n)[3])
    lmls = [float(run(jax.random.PRNGKey(s))) for s in range(seeds)]
    spread = float(np.std(lmls, ddof=1))
    tol = 5.0 * spread
    err = abs(float(np.mean(lmls)) - exact)
    gates = [g.check(f"|mean log-ML - Kalman| (Kalman {exact:.4f})", err,
                     tol)]
    _line(5, "SMC smc_genealogy, linear-Gaussian SSM",
          f"{n} particles T={T} {seeds} seeds", gates,
          time.perf_counter() - t_start,
          f"log-ML {['%.4f' % v for v in lmls]}; tolerance 5 x the "
          f"seeds' sd ({spread:.3g})")
    t_start = time.perf_counter()
    cells = []
    for m in resample_ns:
        lw = jax.random.normal(jax.random.PRNGKey(m), (m,), jnp.float32)
        for name in ("_jnp_systematic", "_sorted_systematic",
                     "_counting_systematic"):
            f = jax.jit(getattr(rs, name))
            _, t, _ = _timed(lambda r: f(lw, 0.37 + 0.01 * r), reps)
            cells.append(f"N={m} {name.strip('_')} {t * 1e6:.1f} us")
    _line(5, "resampling formulations (median of 3)",
          f"N in {list(resample_ns)}", cells, time.perf_counter() - t_start)
    return dict(lmls=lmls, exact=exact)


def phase_four_cards(g, n_hmc=524288, hmc_steps=500, warmup=100,
                     nuts_size=(8, 131072), nuts_warmup=400, ticks=2000,
                     n_smc=2 ** 20, T=100, smc_seeds=4, reps=3,
                     early_pairs=8, interpret=False):
    """The three multi-device paths on a 1-D mesh of 4 devices, each
    against its one-device run."""
    from gen_tpu.parallel import chain_mesh
    mesh = chain_mesh(4)
    out = four_cards_nuts(g, mesh, nuts_size, nuts_warmup, ticks, reps,
                          early_pairs)
    four_cards_hmc(g, mesh, n_hmc, hmc_steps, warmup, reps, interpret)
    out.update(four_cards_smc(g, n_smc, T, smc_seeds))
    return out


def four_cards_nuts(g, mesh, nuts_size, nuts_warmup, ticks, reps,
                    early_pairs):
    """sample_posterior on the mesh and on one device, then the NUTS
    engine alone on identical inputs and keys."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from gen_tpu.ops.nuts_fused import nuts_chains_fused

    # each run passes phase 4's gates; the two agree in distribution
    K, n = nuts_size
    kw = dict(sizes=((K, n, 0),), warmup=nuts_warmup, ticks=ticks,
              reps=reps)
    r4 = phase_nuts(g, mesh=mesh, where=" on 4 devices", **kw)[0]
    r1 = phase_nuts(g, where=" on one device", **kw)[0]
    t_start = time.perf_counter()
    sd = r1["sd"]
    a = _flat_draws(r4["samples"], r1["names"]).reshape(-1, sd.size)
    b = _flat_draws(r1["samples"], r1["names"]).reshape(-1, sd.size)
    mass_rel = float(jnp.max(jnp.abs(jnp.asarray(r4["inv_mass"])
                                     / jnp.asarray(r1["inv_mass"]) - 1)))
    gates = [g.check("max|mean 4 - mean 1|/sd", np.max(np.abs(
                 a.mean(0) - b.mean(0)) / sd), 0.01),
             g.check("max|sd 4 - sd 1|/sd", np.max(np.abs(
                 a.std(0) - b.std(0)) / sd), 0.01)]
    _line("4c", "sample_posterior(mesh=chain_mesh(4)) vs one device, in "
                "distribution", f"schools K={K} {n} chains", gates,
          time.perf_counter() - t_start,
          f"ChEES warmup step size on 4 devices {r4['eps']!r} vs one "
          f"{r1['eps']!r}, inverse mass max rel. diff {mass_rel:.3g} (its "
          "cross-chain statistics are summed over the mesh in another "
          "order); engine us/tick on 4 devices "
          f"{r4['us_per_tick']:.1f} vs one {r1['us_per_tick']:.1f}")

    # chains are independent, so the sharded engine follows the
    # one-device run on the same inputs
    t_start = time.perf_counter()
    run = lambda v: nuts_chains_fused(
        jax.random.PRNGKey(7), r1["target"].logp, v, num_ticks=ticks,
        eps=r1["eps"], inv_mass_diag=r1["inv_mass"])
    on_mesh = NamedSharding(mesh, P(mesh.axis_names[0]))
    h1 = np.asarray(_block(run(r1["v_last"]))[1])
    h4 = np.asarray(_block(run(jax.device_put(r1["v_last"], on_mesh)))[1])
    diff = np.abs(h1 - h4)                              # (pairs, n)
    early = np.all(diff[:early_pairs] <= 1e-4, axis=0).mean()
    apart = np.any(diff > 1e-3, axis=0)
    first = (f"median {np.median(np.argmax(diff > 1e-3, axis=0)[apart]):g}"
             if apart.any() else "none")
    gates = [g.check(f"chains within 1e-4 over the first {early_pairs} "
                     "tick pairs", early, 0.99, op=">=")]
    _line("4c", "nuts_chains_fused on 4 devices vs one device, same inputs "
                "and keys", f"{n} chains d={sd.size} {ticks} ticks", gates,
          time.perf_counter() - t_start,
          f"chains equal at every tick pair {np.all(diff == 0, 0).mean():.4f}"
          f", within 1e-3 {1 - apart.mean():.4f}; first tick pair past "
          f"1e-3 in the chains that part: {first}")
    return dict(nuts_early=early)


def four_cards_hmc(g, mesh, n_hmc, hmc_steps, warmup, reps, interpret):
    """The fused HMC kernel under shard_map, against one device."""
    import jax
    import jax.numpy as jnp
    from gen_tpu.ops.hmc_fused import hmc_chains_fused
    from gen_tpu.parallel import sharded_hmc_chains_fused
    t_start = time.perf_counter()
    target, paths, mean, sd, init = regression_setup()
    k0 = jax.random.PRNGKey(0)
    values = hmc_warmup(target)(init(jax.random.split(k0, n_hmc)),
                                jax.random.fold_in(k0, 1), warmup)
    one = lambda r: hmc_chains_fused(
        jax.random.fold_in(k0, 2 + r), target.logp, values,
        n_steps=hmc_steps, L=10, eps=0.035, interpret=interpret)
    four = lambda r: sharded_hmc_chains_fused(
        jax.random.fold_in(k0, 2 + r), target.logp, values, hmc_steps, mesh,
        L=10, eps=0.035, interpret=interpret)
    c1, t1, (v1, _, _) = _timed(one, reps)
    c4, t4, (v4, _, acc4) = _timed(four, reps)
    gates = (_moment_gates(g, np.asarray(v4, np.float64), "4 devices",
                           mean, sd, 0.03, 0.03)
             + _moment_gates(g, np.asarray(v1, np.float64), "one device",
                             mean, sd, 0.03, 0.03))
    _line("4c", "sharded_hmc_chains_fused (kernel under shard_map) vs "
                "hmc_chains_fused on one device",
          f"{n_hmc} chains d={len(paths)} {warmup}+{hmc_steps} steps L=10",
          gates, time.perf_counter() - t_start,
          f"us/step 4 devices {t4 * 1e6 / hmc_steps:.1f} vs one "
          f"{t1 * 1e6 / hmc_steps:.1f} (median of {reps}); compile+first "
          f"{c4:.1f} s vs {c1:.1f} s; accept 4 devices "
          f"{float(jnp.mean(acc4)) / hmc_steps:.3f}")
    return dict(hmc_us_step=(t4 * 1e6 / hmc_steps, t1 * 1e6 / hmc_steps))


def four_cards_smc(g, n_smc, T, smc_seeds):
    """Particle-sharded SMC, gather and ring exchanges, against one device
    and Kalman; the tolerance comes from the one-device seeds' spread."""
    import jax
    import jax.numpy as jnp
    from gen_tpu.inference.smc import smc_genealogy
    from gen_tpu.models.lgssm import lgssm_kernel
    from gen_tpu.parallel import chain_mesh, sharded_smc_genealogy
    t_start = time.perf_counter()
    params, obs, exact = lgssm_setup(T)
    z0 = jnp.zeros(2, jnp.float32)
    run1 = jax.jit(lambda k: smc_genealogy(
        k, lgssm_kernel, z0, tuple(params), obs, n_smc)[3])
    seeds = [jax.random.PRNGKey(s) for s in range(smc_seeds)]
    lml1 = [float(run1(k)) for k in seeds]
    spread = float(np.std(lml1, ddof=1))
    tol = 5.0 * spread
    pmesh = chain_mesh(4, axis="particles")
    out, secs = {}, {}
    for ex in ("all_gather", "ring"):
        t0 = time.perf_counter()
        out[ex] = [float(sharded_smc_genealogy(
            k, lgssm_kernel, z0, tuple(params), obs, n_smc, pmesh,
            exchange=ex)[3]) for k in seeds]
        secs[ex] = time.perf_counter() - t0
    gates = []
    for ex, v in out.items():
        gates.append(g.check(f"|{ex} - one device| (means of {smc_seeds} "
                             "seeds)", abs(np.mean(v) - np.mean(lml1)), tol))
        gates.append(g.check(f"|{ex} - Kalman|", abs(np.mean(v) - exact),
                             tol))
    _line("4c", "sharded_smc_genealogy vs one device and Kalman",
          f"{n_smc} particles T={T} over 4 devices, {smc_seeds} seeds",
          gates, time.perf_counter() - t_start,
          f"log-ML one device {['%.4f' % v for v in lml1]}, all_gather "
          f"{['%.4f' % v for v in out['all_gather']]}, ring "
          f"{['%.4f' % v for v in out['ring']]}, Kalman {exact:.4f}; "
          f"tolerance 5 x the one-device seeds' sd ({spread:.3g}); "
          f"{smc_seeds} runs incl. compile: all_gather "
          f"{secs['all_gather']:.1f} s, ring {secs['ring']:.1f} s")
    return dict(smc=out, smc_one=lml1)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the multi-device phases on 4 GPUs")
    args = ap.parse_args(argv)
    sys.path.insert(0, HERE)
    device = phase_device(args.four_cards)
    g = Gates(strict=True)
    if args.four_cards:
        phase_four_cards(g)
    else:
        phase_kernel(g)
        phase_hmc(g)
        phase_hmc_fused(g)
        phase_nuts(g)
        phase_smc(g)
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
