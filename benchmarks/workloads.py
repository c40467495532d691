"""BASELINE.md workload matrix: one timing function per benchmark family.

Run on the GPU: python benchmarks/workloads.py
(CPU works too, slower; results print as JSON lines.)"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))


def _timeit(fn, *args, reps=5):
    """Mean seconds of fn(*args[:-1], key_r) over ``reps`` runs, a
    different key per rep, each ended by ``block_until_ready`` (after one
    untimed run that compiles). The last argument must be a PRNG key."""
    import jax

    def force(o):
        return jax.block_until_ready(o)

    base_key = args[-1]
    out = force(fn(*args[:-1], jax.random.fold_in(base_key, 1000)))
    t0 = time.time()
    for r in range(reps):
        force(fn(*args[:-1], jax.random.fold_in(base_key, r)))
    return (time.time() - t0) / reps, out


def bench_nuts(n_chains=4096, n_warmup=100, n_samples=200):
    """NUTS + dual averaging, many chains vmapped (regression model)."""
    import jax
    import jax.numpy as jnp
    import gen_tpu as gt
    from gen_tpu import gen, choicemap, select
    from gen_tpu.inference import nuts_warmup_and_sample
    import sys, os
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
    from bench import autocorr_ess

    xs = jnp.linspace(-3.0, 3.0, 50)
    rng = np.random.default_rng(0)
    ys = 0.7 * xs - 0.4 + 0.5 * jnp.asarray(rng.standard_normal(50))

    @gen
    def model(x):
        slope = gt.normal(0.0, 2.0) @ "slope"
        intercept = gt.normal(0.0, 2.0) @ "intercept"
        gt.normal(slope * x + intercept, 0.5) @ "ys"

    obs = choicemap(ys=ys)
    sel = select("slope", "intercept")
    key = jax.random.PRNGKey(0)
    init_keys = jax.random.split(key, n_chains)

    @jax.jit
    def run(init_keys, k):
        traces, _ = jax.vmap(
            lambda kk: model.generate(kk, (xs,), obs))(init_keys)
        chain_keys = jax.vmap(lambda i: jax.random.fold_in(k, i))(
            jnp.arange(n_chains))
        samples, _, info = jax.vmap(
            lambda ck, tr: nuts_warmup_and_sample(
                ck, tr, sel, num_warmup=n_warmup, num_samples=n_samples,
                max_depth=6))(chain_keys, traces)
        return samples

    el, samples = _timeit(run, init_keys, jax.random.PRNGKey(1), reps=3)
    slopes = np.asarray(samples)[:, :, 0].T  # (samples, chains)
    ess = autocorr_ess(slopes)
    print(json.dumps({"workload": "nuts_regression",
                      "chains": n_chains,
                      "ess_per_sec": round(ess / el),
                      "sec_per_run": round(el, 3)}))


def bench_nuts_fsm(n_chains=4096, n_ticks=2000, step_size=0.05,
                   num_slots=256):
    """FSM-NUTS on the same regression target as bench_nuts: every chain
    does one real leapfrog per global tick (no lockstep idling), so ESS/sec
    should track the MEAN trajectory length instead of the per-transition
    max across chains. Uses a pre-tuned step size (the FSM sampling phase
    is what's being measured; bench_nuts includes warmup)."""
    import jax
    import jax.numpy as jnp
    import gen_tpu as gt
    from gen_tpu import gen, choicemap, select
    from gen_tpu.inference import nuts_fsm
    from gen_tpu.inference.target import FlatTarget
    import sys, os
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
    from bench import autocorr_ess

    xs = jnp.linspace(-3.0, 3.0, 50)
    rng = np.random.default_rng(0)
    ys = 0.7 * xs - 0.4 + 0.5 * jnp.asarray(rng.standard_normal(50))

    @gen
    def model(x):
        slope = gt.normal(0.0, 2.0) @ "slope"
        intercept = gt.normal(0.0, 2.0) @ "intercept"
        gt.normal(slope * x + intercept, 0.5) @ "ys"

    obs = choicemap(ys=ys)
    sel = select("slope", "intercept")
    trace, _ = model.generate(jax.random.PRNGKey(9), (xs,), obs)
    target = FlatTarget(trace, sel)

    @jax.jit
    def run(k):
        k0, k1 = jax.random.split(k)
        theta0 = target.flat0[None, :] + 0.1 * jax.random.normal(
            k0, (n_chains, target.dim))
        res = jax.vmap(lambda kk, t: nuts_fsm(
            kk, target.value_and_grad, t, step_size, n_ticks, max_depth=6,
            num_sample_slots=num_slots))(
                jax.random.split(k1, n_chains), theta0)
        return res.slots, res.counts, res.mean_accept

    el, (slots, counts, acc) = _timeit(run, jax.random.PRNGKey(1), reps=3)
    counts = np.asarray(counts)
    m = int(min(counts.min(), num_slots))
    burn = max(2, m // 10)
    samples = np.asarray(slots)[:, burn:m, 0].T   # (samples, chains)
    ess = autocorr_ess(samples)
    print(json.dumps({"workload": "nuts_fsm_regression",
                      "chains": n_chains, "ticks": n_ticks,
                      "min_trajectories": int(counts.min()),
                      "mean_trajectories": round(float(counts.mean()), 1),
                      "accept": round(float(np.asarray(acc).mean()), 3),
                      "ess_per_sec": round(ess / el),
                      "sec_per_run": round(el, 3)}))


def bench_coal(n_chains=1024, n_sweeps=200):
    """Trans-dimensional changepoint moves/sec, many chains vmapped."""
    import jax
    import jax.numpy as jnp
    import sys, os
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                    "examples"))
    import coal

    years, counts = coal.make_dataset()
    import gen_tpu as gt
    obs = gt.choicemap(counts=counts)
    key = jax.random.PRNGKey(0)
    init_keys = jax.random.split(key, n_chains)
    traces, _ = jax.vmap(
        lambda k: coal.coal_model.generate(k, (years,), obs))(init_keys)

    def chain_sweep(k, trace):
        ks = jax.random.split(k, 8)
        trace = coal.refresh_inactive(ks[0], trace)
        for i in range(1, 6):
            trace, _ = coal.branchless_birth_death(ks[i], trace)
        from gen_tpu.inference import mh_proposal
        trace, _ = mh_proposal(ks[6], trace, coal.height_walk)
        trace, _ = mh_proposal(ks[7], trace, coal.position_walk)
        return trace

    @jax.jit
    def run(traces, k):
        def body(trs, sk):
            ks = jax.vmap(lambda i: jax.random.fold_in(sk, i))(
                jnp.arange(n_chains))
            return jax.vmap(chain_sweep)(ks, trs), None
        trs, _ = jax.lax.scan(body, traces,
                              jax.random.split(k, n_sweeps))
        return trs.get_score()

    el, _ = _timeit(run, traces, jax.random.PRNGKey(1), reps=3)
    moves = n_chains * n_sweeps * 8  # 8 MH moves per sweep
    print(json.dumps({"workload": "coal_rjmcmc",
                      "chains": n_chains,
                      "moves_per_sec": round(moves / el),
                      "sec_per_run": round(el, 3)}))


def bench_smc_genealogy(n_particles=131072, T=32, reps=3):
    """Genealogy-SMC particle-steps/sec on a nonlinear state-space model —
    the driver-reproducible form of the RESULTS.md "Sequential Monte
    Carlo" rows (round 1 measured 63.9M @ 131k, 114.9M @ 1M particles;
    whole filter = one program, rank-merge sort-based resampling,
    cond-gated by ESS)."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    import gen_tpu as gt
    from gen_tpu import gen
    from gen_tpu.combinators.vector import VectorChoiceMap
    from gen_tpu.inference import smc_genealogy

    @gen
    def ssm_kernel(t, prev):
        x = gt.normal(0.8 * prev + 2.0 * jnp.sin(0.5 * prev), 0.5) @ "x"
        gt.normal(x, 0.4) @ "y"
        return x

    rng = np.random.default_rng(0)
    ys = jnp.asarray(np.cumsum(rng.standard_normal(T)) * 0.3,
                     jnp.float32)
    obs = VectorChoiceMap(gt.ChoiceMap().set_value("y", ys), T)

    @jax.jit
    def run(k):
        _, _, lw, lml = smc_genealogy(k, ssm_kernel, 0.0, (), obs,
                                      n_particles)
        return lml

    el, lml = _timeit(run, jax.random.PRNGKey(0), reps=reps)
    print(json.dumps({
        "workload": "smc_genealogy", "particles": n_particles, "T": T,
        "particle_steps_per_sec": round(n_particles * T / el),
        "log_ml": round(float(lml), 3),
        "sec_per_filter": round(el, 4)}))


def bench_amortized(n_steps=100, batch=4096):
    """Amortized-inference training throughput: the inverse_graphics MLP
    proposal (reference examples/inverse_graphics/train.jl) trained on
    simulated (image, latents) pairs — measures scene-gradients/sec of
    the fused simulate->render->assess->grad->ADAM step (the reference
    loops per example; here the whole minibatch is one program)."""
    import time
    import jax
    import sys, os
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                    "examples"))
    import inverse_graphics as ig

    def run(key):
        fns, bdyn, _, _ = ig.train_proposal(key, n_steps=n_steps,
                                            batch=batch, eval_every=None)
        jax.block_until_ready(bdyn)

    def run1(key):
        fns, bdyn, _, _ = ig.train_proposal(key, n_steps=1, batch=batch,
                                            eval_every=None)
        jax.block_until_ready(bdyn)

    t0 = time.time()
    run(jax.random.PRNGKey(0))
    total = time.time() - t0
    # second call re-jits (fresh closure) — subtract a 1-step call to
    # estimate the compile+init overhead and report steady-state
    t0 = time.time()
    run1(jax.random.PRNGKey(1))
    overhead = time.time() - t0
    steady = max(total - overhead, 1e-9)
    print(json.dumps({
        "workload": "amortized_training",
        "batch": batch, "steps": n_steps,
        "scene_grads_per_sec": round(n_steps * batch / steady),
        "steps_per_sec": round(n_steps / steady, 2),
        "sec_total": round(total, 2)}))


def bench_coal_sort(n_chains=1024, n_sweeps=200, n_burn=200,
                    tv_gate=None, n_mc=None):
    """Sorted-parameterization coal RJMCMC (examples/coal_sort.py — Green
    weighted-geometric birth/death with the non-unit Jacobian, permutation
    + position + rate moves; reference examples/coal/coal_sort.jl:1-605):
    branchless many-chain moves/sec + exact-k-posterior TV gate."""
    import jax
    import jax.numpy as jnp
    import sys, os
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                    "examples"))
    import coal_sort as cs
    import gen_tpu as gt

    events = cs.make_dataset()
    obs = gt.choicemap(events=events)
    key = jax.random.PRNGKey(0)
    k_init, k_burn, k_run = jax.random.split(key, 3)
    traces, _ = jax.vmap(
        lambda k: cs.coal_sort_model.generate(k, (cs.T_END,), obs))(
        jax.random.split(k_init, n_chains))

    def chain_sweep(key, trace):
        ks = jax.random.split(key, 9)
        trace = cs.refresh_inactive(ks[0], trace)
        for i in range(1, 5):
            trace, _ = cs.birth_death_move(ks[i], trace)
        trace, _ = cs.rate_move(ks[5], trace)
        trace, _ = cs.rate_move(ks[6], trace)
        trace, _ = cs.position_move(ks[7], trace)
        trace, _ = cs.permutation_move(ks[8], trace)
        return trace

    import functools

    @functools.partial(jax.jit, static_argnums=2)
    def run(traces, key, n):
        def body(trs, sk):
            ks = jax.vmap(lambda i: jax.random.fold_in(sk, i))(
                jnp.arange(n_chains))
            trs = jax.vmap(chain_sweep)(ks, trs)
            return trs, jax.vmap(lambda t: t["k"])(trs)
        return jax.lax.scan(body, traces, jax.random.split(key, n))

    traces, _ = run(traces, k_burn, n_burn)       # burn + compile
    el, (_, k_hist) = _timeit(lambda trs, k: run(trs, k, n_sweeps),
                              traces, k_run, reps=3)
    moves = n_chains * n_sweeps * 9

    # exactness: TV of the cross-chain k posterior vs semi-exact MC
    k_hist = np.asarray(k_hist).reshape(-1)
    emp = np.bincount(k_hist, minlength=cs.K_MAX + 1) / k_hist.size
    if n_mc is None:
        n_mc = 50_000 if n_chains <= 64 else 200_000
    exact_d = cs.exact_k_posterior(events, n_mc=n_mc)
    exact = np.asarray([exact_d[k] for k in range(cs.K_MAX + 1)])
    tv = 0.5 * float(np.abs(emp - exact).sum())
    out = {"workload": "coal_sort_rjmcmc", "chains": n_chains,
           "moves_per_sec": round(moves / el),
           "k_posterior_tv": round(tv, 4),
           "sec_per_run": round(el, 3)}
    print(json.dumps(out))
    if tv_gate is not None:
        assert tv < tv_gate, (tv, emp, exact)
    return out


def bench_bbvi(samples_per_iter=16384, iters=50):
    """BBVI gradient steps/sec."""
    import jax
    import jax.numpy as jnp
    import gen_tpu as gt
    from gen_tpu import choicemap, gen, init_param, param
    from gen_tpu.learning import (ADAM, ParamUpdate,
                                  single_sample_gradient_estimate)

    @gen
    def model():
        mu = gt.normal(0.0, 1.0) @ "mu"
        gt.normal(mu, 1.0) @ "y"

    @gen
    def var_model():
        loc = param("mu_loc")
        log_std = param("mu_log_std")
        gt.normal(loc, jnp.exp(log_std)) @ "mu"

    init_param(var_model, "mu_loc", 0.0)
    init_param(var_model, "mu_log_std", 0.0)
    update = ParamUpdate(ADAM(0.02), var_model)
    obs = choicemap(y=1.0)
    key = jax.random.PRNGKey(0)

    # warm the jitted estimator
    single_sample_gradient_estimate(key, var_model, (), model, (), obs,
                                    samples_per_iter)
    update.apply()
    t0 = time.time()
    for i in range(iters):
        key, sub = jax.random.split(key)
        single_sample_gradient_estimate(sub, var_model, (), model, (), obs,
                                        samples_per_iter)
        update.apply()
    el = (time.time() - t0) / iters
    print(json.dumps({"workload": "bbvi",
                      "samples_per_iter": samples_per_iter,
                      "steps_per_sec": round(1.0 / el, 2),
                      "sample_grads_per_sec": round(samples_per_iter / el)}))


def bench_gp_structure(n_chains=4096, n_sweeps=100, max_depth=3,
                       n_points=30):
    """GP covariance-structure learning moves/sec: the jitted tree-arena
    engine (examples/gp_structure_arena.py — subtree-replace as masked
    regenerate over the bounded-depth heap), many chains vmapped. One
    sweep = a subtree-replace move + a noise move."""
    import jax
    import sys, os
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                    "examples"))
    import gp_structure as g
    import gp_structure_arena as ga

    xs, ys = g.make_dataset(n=n_points)
    model = ga.make_arena_model(max_depth)
    traces = ga.init_chains(jax.random.PRNGKey(0), model, xs, ys, n_chains)

    def run(trs, k):
        trs, _, acc = ga.run_chains(k, trs, max_depth, n_sweeps, False)
        return trs.get_score(), acc

    el, (_, acc) = _timeit(run, traces, jax.random.PRNGKey(1), reps=3)
    moves = n_chains * n_sweeps * 2
    print(json.dumps({"workload": "gp_structure",
                      "chains": n_chains, "max_depth": max_depth,
                      "mean_subtree_accept": round(float(acc), 3),
                      "moves_per_sec": round(moves / el),
                      "sec_per_run": round(el, 3)}))


def bench_pmmh(n_iters=100, n_particles=4096, T=40):
    """Particle-marginal MH fully on-device: the whole chain is ONE program
    (scan over MH iterations, each running the arena particle filter — scan
    over time, vmap over particles). Reports PF particle-steps/sec, the
    BASELINE.md PMMH matrix row."""
    import jax
    import jax.numpy as jnp
    import sys, os
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                    "examples"))
    import pmmh as ex
    import gen_tpu as gt
    from gen_tpu.combinators import UnfoldArena, smc_run
    from gen_tpu.combinators.vector import VectorChoiceMap

    ys = ex.simulate_data(T)
    arena = UnfoldArena(ex.ssm_kernel, max_length=T)
    obs_inner = gt.ChoiceMap().set_value("y", jnp.asarray(ys))

    @jax.jit
    def chain(key):
        obs = VectorChoiceMap(obs_inner, T)

        def pf(k, phi):
            _, _, lml = smc_run(k, arena, 0.0, (phi, 0.5, 0.4), obs,
                                n_particles)
            return lml

        def mh_step(carry, k):
            phi, lml = carry
            k1, k2, k3 = jax.random.split(k, 3)
            phi_new = phi + 0.12 * jax.random.normal(k1)
            lml_new = pf(k2, phi_new)
            logp = lambda p: gt.normal.logpdf(p, 0.0, 1.0)
            alpha = lml_new + logp(phi_new) - lml - logp(phi)
            acc = jnp.log(jax.random.uniform(k3)) < alpha
            return (jnp.where(acc, phi_new, phi),
                    jnp.where(acc, lml_new, lml)), (phi, acc)

        k0, krest = jax.random.split(key)
        lml0 = pf(k0, jnp.asarray(0.3))
        (_, _), (phis, accs) = jax.lax.scan(
            mh_step, (jnp.asarray(0.3), lml0),
            jax.random.split(krest, n_iters))
        return jnp.mean(phis), jnp.mean(accs)

    el, out = _timeit(chain, jax.random.PRNGKey(0), reps=3)
    psteps = n_iters * n_particles * T
    print(json.dumps({"workload": "pmmh",
                      "particles": n_particles, "T": T,
                      "mh_iters_per_sec": round(n_iters / el, 1),
                      "pf_particle_steps_per_sec": round(psteps / el),
                      "accept_rate": round(float(out[1]), 3),
                      "sec_per_chain": round(el, 3)}))


def bench_particle_gibbs(n_sweeps=50, n_particles=4096, T=40):
    """Particle Gibbs with ancestor sampling fully on-device: one program
    scans PG sweeps, each running the conditional genealogy SMC (scan over
    time, vmap over particles) plus a conjugate parameter draw. The
    pseudo-marginal-free companion to bench_pmmh at the same (N, T)."""
    import jax
    import jax.numpy as jnp
    import sys, os
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                    "examples"))
    import particle_gibbs as ex
    import gen_tpu as gt
    from gen_tpu.combinators.vector import VectorChoiceMap
    from gen_tpu.inference import particle_gibbs_step
    from gen_tpu.inference.smc import (reconstruct_trajectories,
                                       smc_genealogy)
    from gen_tpu.utils import logsumexp

    ys = ex.simulate_data(T)
    obs_inner = gt.ChoiceMap().set_value("y", jnp.asarray(ys))

    @jax.jit
    def chain(key):
        obs = VectorChoiceMap(obs_inner, T)
        k_init, k_pick, k_scan = jax.random.split(key, 3)
        subs, anc, log_w, _ = smc_genealogy(
            k_init, ex.ssm_kernel, 0.0, (0.5,), obs, n_particles)
        j = jax.random.categorical(k_pick, log_w - logsumexp(log_w))
        trajs = reconstruct_trajectories(subs, anc)
        ref = VectorChoiceMap(
            jax.tree_util.tree_map(lambda x: x[:, j], trajs).get_choices(),
            T)

        def sweep(carry, k):
            ref, phi = carry
            k_traj, k_phi = jax.random.split(k)
            ref, lml = particle_gibbs_step(
                k_traj, ex.ssm_kernel, 0.0, (phi,), obs, ref, n_particles,
                ancestor_sampling=True)
            phi = ex.phi_conjugate_draw(k_phi, ref.inner.get_value("x"))
            return (ref, phi), (phi, lml)

        _, (phis, lmls) = jax.lax.scan(
            sweep, (ref, jnp.asarray(0.5)),
            jax.random.split(k_scan, n_sweeps))
        return jnp.mean(phis), jnp.std(phis), jnp.mean(lmls)

    el, out = _timeit(chain, jax.random.PRNGKey(0), reps=3)
    psteps = n_sweeps * n_particles * T
    print(json.dumps({"workload": "particle_gibbs",
                      "particles": n_particles, "T": T,
                      "sweeps_per_sec": round(n_sweeps / el, 1),
                      "csmc_particle_steps_per_sec": round(psteps / el),
                      "phi_mean": round(float(out[0]), 3),
                      "phi_std": round(float(out[1]), 3),
                      "sec_per_chain": round(el, 3)}))


def bench_gp_collapsed_hmc(n_chains=1024, n_points=256, n_steps=20, L=5):
    """Many-chain HMC on the collapsed GP hyperparameter posterior: every
    leapfrog step differentiates through an (n, n) kernel build (matmul
    matmul) + Cholesky. Reports hyperparameter-gradient evals/sec."""
    import jax
    import jax.numpy as jnp
    import gen_tpu as gt
    from gen_tpu import choicemap, gen, select
    from gen_tpu.inference import hmc
    from gen_tpu.models import gp_marginal, gp_sample, rbf

    xs = jnp.linspace(-3.0, 3.0, n_points)
    ys = gp_sample(jax.random.PRNGKey(1), rbf, xs, (1.5, 0.8), 0.1)
    gpdist = gp_marginal("rbf", n_theta=2)

    @gen
    def model():
        log_ell = gt.normal(0.0, 1.0) @ "log_ell"
        log_var = gt.normal(0.0, 1.0) @ "log_var"
        gpdist(xs, jnp.exp(log_var), jnp.exp(log_ell), 0.1) @ "ys"

    obs = choicemap(ys=ys)
    sel = select("log_ell", "log_var")

    @jax.jit
    def chain(key):
        k0, k1 = jax.random.split(key)
        traces, _ = jax.vmap(lambda k: model.generate(k, (), obs))(
            jax.random.split(k0, n_chains))

        def step(trs, sk):
            ks = jax.vmap(lambda i: jax.random.fold_in(sk, i))(
                jnp.arange(n_chains))
            trs, accs = jax.vmap(
                lambda t, k: hmc(k, t, sel, L=L, eps=0.02))(trs, ks)
            return trs, (trs["log_ell"], accs)

        _, (ells, accs) = jax.lax.scan(step, traces,
                                       jax.random.split(k1, n_steps))
        return jnp.mean(ells), jnp.mean(accs)

    el, out = _timeit(chain, jax.random.PRNGKey(0), reps=3)
    grad_evals = n_chains * n_steps * (L + 1)
    chol_flops = grad_evals * 3 * (n_points ** 3 / 3.0)  # fwd+vjp ~ 3x
    print(json.dumps({"workload": "gp_collapsed_hmc",
                      "chains": n_chains, "n_points": n_points,
                      "grad_evals_per_sec": round(grad_evals / el),
                      "approx_chol_gflops": round(chol_flops / el / 1e9, 1),
                      "accept_rate": round(float(out[1]), 3),
                      "sec": round(el, 3)}))


def bench_mvn_mxu(n=262144, d=128, reps=5):
    """Batched shared-covariance MVN logpdf (the SMC/collapsed-model weight
    kernel): per-row cho_solve vs the matrix units Linv-matmul path (ops/mvn.py) in
    f32 and bf16. FLOPs counted as the 2*N*D^2 of the residual matmul."""
    import jax
    import jax.numpy as jnp
    from gen_tpu.dists import mvnormal
    from gen_tpu.ops.mvn import mvn_precompute, mvn_logpdf_rows

    rng = np.random.default_rng(0)
    cov_half = rng.standard_normal((d, d)).astype(np.float32)
    cov = jnp.asarray(cov_half @ cov_half.T + d * np.eye(d, dtype=np.float32))
    mu = jnp.zeros(d, jnp.float32)
    prec = mvn_precompute(cov)
    steps = 32  # amortize the one-time RNG so the weight kernel dominates

    def scan_weights(weight_fn):
        @jax.jit
        def run(key):
            xs = jax.random.normal(key, (n, d), jnp.float32)

            def body(acc, t):
                # shift the target mean per step (cheap (d,) update) so
                # every iteration is fresh work on the same particle block
                mu_t = mu + 0.01 * t
                return acc + jnp.sum(weight_fn(xs, mu_t)), None

            acc, _ = jax.lax.scan(body, jnp.float32(0.0),
                                  jnp.arange(steps, dtype=jnp.float32))
            return acc
        return run

    solve_path = scan_weights(
        lambda xs, m: jax.vmap(lambda x: mvnormal.logpdf(x, m, cov))(xs))
    mxu_f32 = scan_weights(lambda xs, m: mvn_logpdf_rows(xs, m, prec))
    mxu_bf16 = scan_weights(
        lambda xs, m: mvn_logpdf_rows(xs, m, prec, dtype=jnp.bfloat16))

    # bf16-RESIDENT: the particle block is *stored* bf16 — the whole chain
    # (subtract, matmul, square-sum) is device memory-bound at d=128, so halving the
    # stored bytes is where bf16 actually pays (casting f32 inputs doesn't)
    @jax.jit
    def mxu_bf16_resident(key):
        xs = jax.random.normal(key, (n, d), jnp.float32).astype(jnp.bfloat16)

        def body(acc, t):
            mu_t = mu + 0.01 * t
            lp = mvn_logpdf_rows(xs, mu_t.astype(jnp.bfloat16), prec,
                                 dtype=jnp.bfloat16)
            return acc + jnp.sum(lp), None

        acc, _ = jax.lax.scan(body, jnp.float32(0.0),
                              jnp.arange(steps, dtype=jnp.float32))
        return acc

    flops = 2.0 * n * d * d * steps
    out = {}
    for name, fn in [("cho_solve_per_row", solve_path),
                     ("mxu_f32", mxu_f32), ("mxu_bf16", mxu_bf16),
                     ("mxu_bf16_resident", mxu_bf16_resident)]:
        el, _ = _timeit(fn, jax.random.PRNGKey(0), reps=reps)
        out[name] = {"sec": round(el, 5),
                     "rows_per_sec": round(n * steps / el),
                     "gflops": round(flops / el / 1e9, 1)}
    print(json.dumps({"workload": "mvn_mxu_weights", "n": n, "d": d,
                      "steps": steps, **out}))


def bench_lgssm_collapsed_hmc(n_chains=8192, T=64, d=4, p=4,
                              n_steps=20, L=5):
    """HMC over transition-parameter posterior of a COLLAPSED LGSSM (score
    = exact Kalman log-ML; Rao-Blackwellized PMMH). Each leapfrog gradient
    differentiates through the whole Kalman scan — a (T x D x D)-matmul
    pipeline on the matrix units, vmapped over chains."""
    import jax
    import jax.numpy as jnp
    import gen_tpu as gt
    from gen_tpu.models import LGSSMParams, lgssm
    from gen_tpu.inference import hmc

    rng = np.random.default_rng(1)
    # default float dtype throughout (f32 by default, f64 under the test
    # suite's x64 mode) — a mixed-dtype carry fails lax.scan under x64
    ft = jnp.zeros(()).dtype
    a_true = jnp.asarray(0.7 * np.eye(d)
                         + 0.1 * rng.standard_normal((d, d)), ft)
    q = jnp.asarray(0.3 * np.eye(d), ft)
    c = jnp.asarray(rng.standard_normal((p, d)), ft)
    r = jnp.asarray(0.2 * np.eye(p), ft)
    mu0 = jnp.zeros(d, ft)
    p0 = jnp.asarray(np.eye(d), ft)
    dist = lgssm(T)
    ys = dist.sample(jax.random.PRNGKey(2), a_true, q, c, r, mu0, p0)

    @gt.gen
    def model():
        a_flat = gt.normal(jnp.zeros(d * d), 1.0) @ "a"
        dist(a_flat.reshape(d, d), q, c, r, mu0, p0) @ "ys"

    obs = gt.choicemap(ys=ys)
    sel = gt.select("a")

    @jax.jit
    def run(key):
        k_init, k_chain = jax.random.split(key)
        trs, _ = jax.vmap(lambda k: model.generate(k, (), obs))(
            jax.random.split(k_init, n_chains))

        def step(trs, ks):
            new, acc = jax.vmap(lambda t, k: hmc(k, t, sel, L=L, eps=0.01))(
                trs, jax.random.split(ks, n_chains))
            return new, jnp.mean(acc)

        keys = jax.random.split(k_chain, n_steps)
        trs, accs = jax.lax.scan(step, trs, keys)
        return trs.get_score().sum(), jnp.mean(accs)

    el, out = _timeit(run, jax.random.PRNGKey(0), reps=3)
    grad_evals = n_chains * n_steps * (L + 1)
    print(json.dumps({"workload": "lgssm_collapsed_hmc",
                      "chains": n_chains, "T": T, "d": d,
                      "kalman_grad_evals_per_sec": round(grad_evals / el),
                      "accept_rate": round(float(out[1]), 3),
                      "sec_per_run": round(el, 3)}))


def bench_hmm_forward_mxu(n=8192, k=128, v=128, t=64, reps=5):
    """Batched HMM forward: log-space (vmapped logsumexp recursion, elementwise)
    vs the scaled prob-space recursion (one (N,K)x(K,K) matmul per step —
    matmul) in f32 and bf16. FLOPs = 2*N*K^2*T (the transition contraction)."""
    import jax
    import jax.numpy as jnp
    from gen_tpu.models import HMMParams, hmm_forward, hmm_forward_batched

    rng = np.random.default_rng(0)
    params = HMMParams(
        jnp.asarray(rng.dirichlet(np.ones(k)).astype(np.float32)),
        jnp.asarray(rng.dirichlet(np.ones(k), size=k).astype(np.float32)),
        jnp.asarray(rng.dirichlet(np.ones(v), size=k).astype(np.float32)))

    def make(fn, n_seq):
        @jax.jit
        def run(key):
            ys = jax.random.randint(key, (n_seq, t), 0, v)
            return fn(ys)
        return run

    n_log = min(n, 2048)  # the (N,K,K) logsumexp intermediate caps N here
    log_space = make(lambda ys: jnp.sum(
        jax.vmap(lambda y: hmm_forward(params, y)[0])(ys)), n_log)
    mxu_f32 = make(lambda ys: jnp.sum(hmm_forward_batched(params, ys)[0]), n)
    mxu_bf16 = make(lambda ys: jnp.sum(
        hmm_forward_batched(params, ys, dtype=jnp.bfloat16)[0]), n)

    out = {}
    for name, fn, n_seq in [("log_space_vpu", log_space, n_log),
                            ("mxu_f32", mxu_f32, n),
                            ("mxu_bf16", mxu_bf16, n)]:
        el, _ = _timeit(fn, jax.random.PRNGKey(0), reps=reps)
        flops = 2.0 * n_seq * k * k * t
        out[name] = {"sec": round(el, 5),
                     "seqs_per_sec": round(n_seq / el),
                     "gflops": round(flops / el / 1e9, 1)}
    print(json.dumps({"workload": "hmm_forward_mxu", "n": n, "k": k,
                      "t": t, **out}))


if __name__ == "__main__":
    bench_bbvi()
    bench_coal()
    bench_gp_structure()
    bench_nuts()
    bench_pmmh()
    bench_particle_gibbs()
    bench_mvn_mxu()
    bench_lgssm_collapsed_hmc()
    bench_gp_collapsed_hmc()
    bench_hmm_forward_mxu()
