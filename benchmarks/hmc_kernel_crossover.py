"""Where the fused HMC kernel beats the XLA sampler, by dimension.

For the schools family (d = K + 2) it runs one call at the headline
scale (``--chains`` chains x ``--steps`` steps) of the kernel
(``hmc_chains_fused``) and of the XLA sampler (``hmc_chains``), and
prints per d:

- cold: the compile with the persistent compilation cache switched off
  plus the first call, i.e. what a first call of a new model pays;
- warm: the median of 3 further calls of the compiled program, i.e. what
  a call pays once its compile is cached (a persistent-cache hit adds the
  load of the compiled program, not measured here).

The two rankings differ: the kernel samples faster at every d measured,
but its compile grows steeply with d. ``HMC_KERNEL_MAX_D`` in
``gen_tpu/ops/backend.py`` is the largest d at which the kernel wins the
cold call, since the kernel compiles the step size and leapfrog count in
and ``sample_posterior`` adapts both on every call; both rankings are in
``PERF.md``.

    python benchmarks/hmc_kernel_crossover.py [--ks 1,6,8,10,14]
"""

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def measure(K, n, steps, reps=3, L=10, eps=0.05):
    """{route: (cold seconds, warm seconds)} for one call of each."""
    import jax
    import jax.numpy as jnp
    from gen_tpu import choicemap, select
    from gen_tpu.inference.hmc import hmc_chains
    from gen_tpu.inference.target import FlatTarget
    from gen_tpu.ops.hmc_fused import hmc_chains_fused
    from bench_hard_targets import eight_schools, make_schools
    ys, sig = make_schools(K, seed=0)
    sig_j = jnp.asarray(sig, jnp.float32)
    obs = choicemap(ys=jnp.asarray(ys, jnp.float32))
    one, _ = eight_schools.generate(jax.random.PRNGKey(0), (sig_j,), obs)
    tgt = FlatTarget(one, select("mu", "log_tau", "theta_std"))
    d = K + 2
    v = jnp.asarray(0.1 * np.random.default_rng(0).standard_normal((n, d)),
                    jnp.float32)
    kern = jax.jit(lambda vv, k: hmc_chains_fused(
        k, tgt.logp, vv, n_steps=steps, L=L, eps=eps, collect_idx=0))
    xla = jax.jit(lambda vv, k: hmc_chains(
        k, tgt, vv, n_steps=steps, L=L, eps=eps,
        collect=lambda x: x[:, 0]))
    out = {}
    for name, f in (("kernel", kern), ("xla", xla)):
        t0 = time.perf_counter()
        jax.block_until_ready(f(v, jax.random.PRNGKey(0)))
        cold = time.perf_counter() - t0
        ts = []
        for r in range(reps):
            t0 = time.perf_counter()
            jax.block_until_ready(f(v, jax.random.PRNGKey(r + 1)))
            ts.append(time.perf_counter() - t0)
        out[name] = (cold, float(np.median(ts)))
    return d, out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--ks", default="1,6,8,10,14")
    ap.add_argument("--chains", type=int, default=524288)
    ap.add_argument("--steps", type=int, default=500)
    a = ap.parse_args(argv)
    import subprocess
    import jax
    from gen_tpu.ops import backend
    jax.config.update("jax_enable_compilation_cache", False)
    backend.HMC_KERNEL_MAX_D = 10 ** 9        # force the kernel everywhere
    dev = jax.devices()[0]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip() if dev.platform == "gpu" \
        else "no nvidia-smi reading"
    print(f"device {dev.platform} {dev.device_kind} ({smi}); one call = "
          f"{a.chains} chains x {a.steps} steps, L=10", flush=True)
    measure(1, 1024, 2, reps=1)       # one-time start-up of both routes
    for K in (int(k) for k in a.ks.split(",")):
        d, o = measure(K, a.chains, a.steps)
        (ck, wk), (cx, wx) = o["kernel"], o["xla"]
        print(f"d={d}: cold kernel {ck:.2f} s, XLA {cx:.2f} s -> "
              f"{'kernel' if ck < cx else 'XLA'}; warm kernel {wk:.4f} s, "
              f"XLA {wx:.4f} s -> {'kernel' if wk < wx else 'XLA'}",
              flush=True)


if __name__ == "__main__":
    main()
