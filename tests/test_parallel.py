"""Sharded execution correctness: the same program under a device mesh must
produce the same numbers as single-device execution (sharding only changes
layout; XLA inserts the collectives). Runs on the 8-device virtual CPU mesh
from conftest."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import gen_tpu as gt
from gen_tpu import gen, choicemap, select, vector_choicemap
from gen_tpu.combinators import UnfoldArena, smc_run
from gen_tpu.parallel import (chain_mesh, device_count,
                              sharded_importance_sampling, shard_keys,
                              sharded_vi_step)



@pytest.fixture(autouse=True)
def _multi_device():
    """Decided at run time, not at import: the mesh tests need devices."""
    if device_count() < 2:
        pytest.skip("needs multiple devices")

KEY = jax.random.PRNGKey(0)


@gen
def model(n):
    mu = gt.normal(0.0, 3.0) @ "mu"
    gt.normal(mu * jnp.ones(n), 1.0) @ "ys"


OBS = choicemap(ys=jnp.full(10, 2.0))


def test_sharded_importance_matches_unsharded():
    mesh = chain_mesh(8)
    traces_s, lnw_s, lml_s = sharded_importance_sampling(
        KEY, model, (10,), OBS, 64, mesh)

    keys = jax.random.split(KEY, 64)
    traces_u, lws = jax.vmap(
        lambda k: model.generate(k, (10,), OBS))(keys)
    from gen_tpu.utils import logsumexp
    lml_u = logsumexp(lws) - jnp.log(64)
    np.testing.assert_allclose(float(lml_s), float(lml_u), rtol=1e-10)
    np.testing.assert_allclose(np.asarray(lnw_s),
                               np.asarray(lws - logsumexp(lws)), rtol=1e-10)


def test_sharded_smc_matches_unsharded():
    @gen
    def kern(t, prev):
        x = gt.normal(0.8 * prev, 0.5) @ "x"
        gt.normal(x, 0.3) @ "y"
        return x

    arena = UnfoldArena(kern, max_length=8)
    obs = vector_choicemap(5, y=jnp.array([0.1, -0.2, 0.4, 0.0, 0.3]))

    run = lambda k: smc_run(k, arena, 0.0, (), obs, 64)[2]
    lml_u = jax.jit(run)(KEY)

    mesh = chain_mesh(8, axis="particles")
    from jax.sharding import NamedSharding, PartitionSpec as P
    # shard the whole computation: same program, keys laid out over devices
    lml_s = jax.jit(run)(jax.device_put(KEY, NamedSharding(mesh, P())))
    np.testing.assert_allclose(float(lml_s), float(lml_u), rtol=1e-10)


def test_sharded_vi_grads_match():
    @gen
    def var_model():
        loc = gt.param("loc")
        gt.normal(loc, 1.0) @ "mu"

    gt.init_param(var_model, "loc", 0.5)
    mesh = chain_mesh(8)
    elbo_s, grads_s = sharded_vi_step(
        KEY, model, (10,), OBS, var_model, (), 64, mesh)

    # unsharded replica of the same estimator
    from gen_tpu.learning.variational import single_sample_gradient_estimate
    var_model.params_grad.clear()
    elbo_u, _ = single_sample_gradient_estimate(
        KEY, var_model, (), model, (10,), OBS, 64)
    np.testing.assert_allclose(float(elbo_s), float(elbo_u), rtol=1e-8)
    g_u = var_model.params_grad["loc"]
    np.testing.assert_allclose(np.asarray(grads_s[0]["loc"]),
                               np.asarray(g_u), rtol=1e-8)


def test_shard_keys_layout():
    mesh = chain_mesh(8)
    keys = shard_keys(KEY, 64, mesh)
    assert keys.shape[0] == 64
    assert len(keys.sharding.device_set) == 8


def test_sharded_hmc_chains_fused_cpu_mesh():
    """Fused-HMC sharding: each device runs the whole sampler on its chain
    shard (XLA fallback on the CPU mesh); deterministic, correct marginals."""
    from gen_tpu.parallel import chain_mesh
    from gen_tpu.parallel.sharded import sharded_hmc_chains_fused

    def logp(x):
        return -0.5 * jnp.sum(x * x)

    mesh = chain_mesh(8)
    vals0 = jax.random.normal(jax.random.PRNGKey(0), (64, 2)) * 2.0
    vals, coll, accs = sharded_hmc_chains_fused(
        jax.random.PRNGKey(1), logp, vals0, n_steps=300, mesh=mesh,
        L=5, eps=0.5)
    assert vals.shape == (64, 2) and coll.shape == (300, 64)
    s = np.asarray(coll)[50:]
    assert abs(s.mean()) < 0.1 and abs(s.std() - 1.0) < 0.1
    compiled = sharded_hmc_chains_fused._cache_size()
    v2, _, _ = sharded_hmc_chains_fused(
        jax.random.PRNGKey(1), logp, vals0, n_steps=300, mesh=mesh,
        L=5, eps=0.5)
    np.testing.assert_array_equal(np.asarray(vals), np.asarray(v2))
    # a repeated call reuses the compiled program (no retrace)
    assert sharded_hmc_chains_fused._cache_size() == compiled


def test_sharded_hmc_chains_fused_inv_mass():
    """The adapted inverse-mass diagonal is forwarded to every device's
    kernel: an anisotropic Gaussian sampled with the matched mass keeps
    correct per-coordinate marginals."""
    from gen_tpu.parallel import chain_mesh
    from gen_tpu.parallel.sharded import sharded_hmc_chains_fused

    var = jnp.asarray([25.0, 0.04])

    def logp(x):
        return -0.5 * jnp.sum(x * x / var)

    mesh = chain_mesh(8)
    vals0 = (jax.random.normal(jax.random.PRNGKey(2), (64, 2))
             * jnp.sqrt(var))
    vals, coll, _ = sharded_hmc_chains_fused(
        jax.random.PRNGKey(3), logp, vals0, n_steps=400, mesh=mesh,
        L=8, eps=0.35, collect_idx=None, inv_mass_diag=var)
    s = np.asarray(coll)[100:]                 # (steps, chains, 2)
    assert abs(s[..., 0].std() - 5.0) < 0.5
    assert abs(s[..., 1].std() - 0.2) < 0.02


def test_sharded_kernel_interpret_matches_per_shard_runs():
    """The Pallas kernel itself under shard_map (interpret mode on the CPU
    mesh): each device's shard equals hmc_chains_fused run alone on that
    shard with the device-folded key."""
    from gen_tpu.ops.hmc_fused import hmc_chains_fused
    from gen_tpu.parallel.sharded import sharded_hmc_chains_fused

    def logp(x):
        return -0.5 * jnp.sum(x * x)

    mesh = chain_mesh(4)
    key = jax.random.PRNGKey(5)
    vals0 = jax.random.normal(jax.random.PRNGKey(4), (32, 3))
    with jax.enable_x64(False):
        vals, coll, accs = sharded_hmc_chains_fused(
            key, logp, vals0, n_steps=3, mesh=mesh, L=2, eps=0.3,
            interpret=True)
        for i in range(4):
            sl = slice(8 * i, 8 * (i + 1))
            v1, c1, a1 = hmc_chains_fused(
                jax.random.fold_in(key, i), logp, vals0[sl], n_steps=3,
                L=2, eps=0.3, interpret=True)
            np.testing.assert_allclose(np.asarray(vals)[sl], np.asarray(v1),
                                       rtol=1e-6, atol=1e-6)
            np.testing.assert_allclose(np.asarray(coll)[:, sl],
                                       np.asarray(c1), rtol=1e-6, atol=1e-6)
            np.testing.assert_array_equal(np.asarray(accs)[sl],
                                          np.asarray(a1))


def test_multihost_mesh_constructors():
    """multihost.py mesh builders on the virtual single-process mesh: the
    slice mesh spans all devices; the hierarchical mesh puts the one host
    on the DCN axis and local devices within a host."""
    from gen_tpu.parallel.multihost import hierarchical_mesh, slice_mesh

    m = slice_mesh("chains")
    assert m.shape["chains"] == jax.device_count()
    h = hierarchical_mesh()
    assert h.shape["replicas"] == jax.process_count() == 1
    assert h.shape["particles"] == jax.local_device_count()


def test_sharded_nuts_chains_fused_matches_shapes():
    """Sharded fused FSM-NUTS (XLA fallback per shard on the CPU mesh):
    shapes and basic sanity; chains independent -> no collectives."""
    from gen_tpu.parallel import chain_mesh, sharded_nuts_chains_fused
    mesh = chain_mesh(8)

    def logp(x):
        return -0.5 * jnp.sum(x * x)

    vals0 = jax.random.normal(jax.random.PRNGKey(0), (32, 2))
    v, hist, hcnt, cnt, stats = sharded_nuts_chains_fused(
        jax.random.PRNGKey(1), logp, vals0, num_ticks=64, mesh=mesh,
        eps=0.5, max_depth=5)
    assert v.shape == (32, 2)
    # one history row per two-leapfrog tick
    assert hist.shape == (32, 32)
    assert hcnt.shape == (32, 32)
    assert int(jnp.min(cnt)) > 0
    np.testing.assert_array_equal(np.asarray(hcnt[-1]), np.asarray(cnt))
    assert float(jnp.mean(stats["mean_accept"])) > 0.5
