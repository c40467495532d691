"""Weak-scaling harness: sharded inference throughput vs device count.

Run with a virtual mesh (no accelerators needed):
    XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \
        python benchmarks/scaling.py

On real devices the same code shards over the interconnect. Weak scaling: the
per-device workload is constant (chains/particles per device fixed), so
ideal efficiency keeps time flat as devices grow. Reports one JSON line per
configuration.

CAVEAT: on a virtual CPU mesh the "devices" share one host's cores, so the
efficiency column measures partitioning overhead only — it cannot approach
1.0 and must not be read as an interconnect weak-scaling claim (those need a real
multi-device machine). The output marks such runs with "virtual_mesh": true."""

import json
import time

import jax
import jax.numpy as jnp
import numpy as np


def main(chains_per_device=512, steps=10):
    import gen_tpu as gt
    from gen_tpu import gen, choicemap, select
    from gen_tpu.inference import hmc
    from gen_tpu.parallel import chain_mesh, shard_keys
    from gen_tpu.utils import logsumexp

    n_points = 50
    xs = jnp.linspace(-3.0, 3.0, n_points)
    rng = np.random.default_rng(0)
    ys = 0.7 * xs - 0.4 + 0.5 * jnp.asarray(rng.standard_normal(n_points))

    @gen
    def model(x):
        slope = gt.normal(0.0, 2.0) @ "slope"
        intercept = gt.normal(0.0, 2.0) @ "intercept"
        gt.normal(slope * x + intercept, 0.5) @ "ys"

    obs = choicemap(ys=ys)
    sel = select("slope", "intercept")
    n_dev_total = len(jax.devices())
    results = []
    base_time = None

    dev_counts = [d for d in (1, 2, 4, 8, 16) if d <= n_dev_total]
    for n_dev in dev_counts:
        n_chains = chains_per_device * n_dev
        mesh = chain_mesh(n_dev)
        key = jax.random.PRNGKey(0)
        init_keys = shard_keys(key, n_chains, mesh)

        @jax.jit
        def run(init_keys, k):
            traces, lws = jax.vmap(
                lambda kk: model.generate(kk, (xs,), obs))(init_keys)
            lml = logsumexp(lws) - jnp.log(n_chains)  # cross-device reduce

            def body(trs, sk):
                ks = jax.vmap(lambda i: jax.random.fold_in(sk, i))(
                    jnp.arange(n_chains))

                def one(tr, kk):
                    new_tr, acc = hmc(kk, tr, sel, L=5, eps=0.05)
                    return new_tr, acc

                return jax.vmap(one)(trs, ks)

            final, accs = jax.lax.scan(body, traces,
                                       jax.random.split(k, steps))
            return final.get_score(), accs, lml

        scores, accs, lml = run(init_keys, jax.random.PRNGKey(1))
        jax.block_until_ready(scores)
        t0 = time.time()
        scores, accs, lml = run(init_keys, jax.random.PRNGKey(2))
        jax.block_until_ready(scores)
        elapsed = time.time() - t0
        if base_time is None:
            base_time = elapsed
        eff = base_time / elapsed
        results.append(dict(devices=n_dev, chains=n_chains,
                            seconds=round(elapsed, 4),
                            chain_steps_per_sec=round(
                                steps * n_chains / elapsed),
                            weak_scaling_efficiency=round(eff, 3),
                            virtual_mesh=jax.default_backend() == "cpu"))
        print(json.dumps(results[-1]))
    return results


if __name__ == "__main__":
    main()
