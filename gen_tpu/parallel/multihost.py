"""Multi-host (pod-slice) scaffolding.

Single-controller JAX spans hosts once ``jax.distributed.initialize`` has
run on every process; after that, every sharded entry point in
gen_tpu.parallel works unchanged — the mesh simply contains devices from
all hosts, chains/particles shard across the full slice, and XLA routes
the logsumexp/resampling/gradient collectives over the interconnect within a host and
DCN across hosts.

Exercised for real (round 3): tests/test_multihost.py spawns TWO OS
processes, each with two virtual CPU devices, joins them through
``initialize_multihost`` over a local coordinator, and runs the
distributed-SMC weight-normalization collective (pmax/psum logsumexp) and
an all_gather across the cross-process (DCN) axis — actual Gloo
collectives between controllers, verified against the host reference.
On a multi-host GPU cluster the same code paths run over the
interconnect unchanged. The virtual-mesh tests
(tests/test_parallel.py) pin the single-controller semantics; the
driver's dryrun_multichip compiles the same programs over an N-device
mesh."""

from __future__ import annotations

from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None) -> None:
    """Call once per process before any jax computation on a multi-host
    cluster. The no-argument form works only where the environment
    describes the cluster to JAX; otherwise pass the coordinator address,
    process count and process id."""
    if coordinator_address is None:
        jax.distributed.initialize()
    else:
        jax.distributed.initialize(coordinator_address=coordinator_address,
                                   num_processes=num_processes,
                                   process_id=process_id)


def slice_mesh(axis: str = "chains") -> Mesh:
    """1-D mesh over every device in the slice (all hosts)."""
    return Mesh(np.array(jax.devices()), (axis,))


def hierarchical_mesh(ici_axis: str = "particles",
                      dcn_axis: str = "replicas") -> Mesh:
    """2-D mesh: intra-host devices on the fast intra-host axis (particle
    resampling collectives), hosts on the DCN axis (independent replicas /
    chain groups — communication-free except final reductions).

    Layout rationale (SURVEY.md §5.8): resampling needs an all-gather-class
    collective over the particle axis every few steps — keep it within a host;
    chain/replica parallelism is embarrassingly parallel — put it across
    hosts where bandwidth is scarce."""
    n_local = jax.local_device_count()
    n_proc = jax.process_count()
    devices = np.asarray(jax.devices()).reshape(n_proc, n_local)
    return Mesh(devices, (dcn_axis, ici_axis))
