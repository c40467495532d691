"""Device-mesh helpers.

The reference has no distributed runtime at all (SURVEY.md §5.8): every
multi-chip concern here is new Design. The parallel axes of a
probabilistic-programming workload are:

* ``chains`` — independent MCMC chains (embarrassingly parallel; data
  parallelism's analogue),
* ``particles`` — SMC particles (independent except for resampling and
  log-ML normalization, which become ``psum``/gather collectives over the interconnect),
* ``data`` — minibatch shards in BBVI/train (gradient ``psum``).

We lay chains/particles over the mesh with ``jax.sharding.NamedSharding``
and let XLA insert the collectives (logsumexp/ESS reductions ride the interconnect).
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def device_count() -> int:
    return len(jax.devices())


def chain_mesh(n_devices: int = None, axis: str = "chains") -> Mesh:
    """A 1-D mesh over the first ``n_devices`` devices."""
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (axis,))


def shard_keys(key, n: int, mesh: Mesh, axis: str = "chains"):
    """Split a PRNG key into n subkeys laid out along a mesh axis."""
    keys = jax.random.split(key, n)
    sharding = NamedSharding(mesh, P(axis))
    return jax.device_put(keys, sharding)
