"""Auxiliary subsystems: checkpoint/restore, profiling timers, ops
fallbacks (the reference has none of these — SURVEY.md §5)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import gen_tpu as gt
from gen_tpu import choicemap, gen, init_param
from gen_tpu.checkpoint import (restore_params, restore_pytree, save_params,
                                save_pytree)
from gen_tpu.ops import systematic_resample
from gen_tpu.profiling import time_fn, timed

KEY = jax.random.PRNGKey(0)


def test_checkpoint_params(tmp_path):
    @gen
    def m():
        t = gt.param("theta")
        gt.normal(t, 1.0) @ "x"

    init_param(m, "theta", jnp.array([1.0, 2.0]))
    path = str(tmp_path / "params.npz")
    save_params(m, path)
    m.params["theta"] = jnp.zeros(2)
    restore_params(m, path)
    np.testing.assert_allclose(np.asarray(m.params["theta"]), [1.0, 2.0])


def test_checkpoint_trace_roundtrip(tmp_path):
    @gen
    def m():
        a = gt.normal(0.0, 1.0) @ "a"
        gt.normal(a, 0.5) @ "b"

    tr = m.simulate(KEY, ())
    path = str(tmp_path / "trace.npz")
    save_pytree(path, tr)
    # restore into a fresh template trace
    template = m.simulate(jax.random.PRNGKey(9), ())
    restored = restore_pytree(path, template)
    np.testing.assert_allclose(float(restored["a"]), float(tr["a"]))
    np.testing.assert_allclose(float(restored.get_score()),
                               float(tr.get_score()))
    # restored trace is fully functional
    new_tr, w, _, _ = restored.update(KEY, choicemap(b=0.0))
    assert np.isfinite(float(w))


def test_checkpoint_structure_mismatch(tmp_path):
    path = str(tmp_path / "x.npz")
    save_pytree(path, {"a": jnp.ones(3)})
    try:
        restore_pytree(path, {"b": jnp.ones(3)})
        assert False, "should have raised"
    except ValueError:
        pass


def test_systematic_resample_jnp():
    lw = jnp.log(jnp.array([0.1, 0.2, 0.3, 0.4]))
    parents = systematic_resample(lw, 0.5)
    assert parents.shape == (4,)
    # heavier particles get more offspring on average
    counts = np.bincount(np.asarray(parents), minlength=4)
    assert counts[3] >= counts[0]
    # statistical: offspring counts proportional to weights
    total = np.zeros(4)
    for s in range(200):
        u = float(jax.random.uniform(jax.random.fold_in(KEY, s)))
        p = systematic_resample(lw, u)
        total += np.bincount(np.asarray(p), minlength=4)
    np.testing.assert_allclose(total / total.sum(), [0.1, 0.2, 0.3, 0.4],
                               atol=0.02)


def test_time_fn():
    f = jax.jit(lambda x: x * 2)
    secs, out = time_fn(f, jnp.ones(16), iters=3)
    assert secs >= 0
    np.testing.assert_allclose(np.asarray(out), 2.0)


def test_timed_context():
    results = {}
    with timed("blk", results) as out:
        out["value"] = jnp.sum(jnp.ones(10))
    assert results["blk"] > 0


def test_sorted_systematic_matches_searchsorted():
    from gen_tpu.ops.resample import _jnp_systematic, _sorted_systematic
    for n in (1000, 40000):
        lw = jax.random.normal(jax.random.PRNGKey(0), (n,)) * 2.0
        for u in (0.0, 0.37, 0.999):
            a = np.asarray(_jnp_systematic(lw, u))
            b = np.asarray(_sorted_systematic(lw, u))
            assert np.array_equal(a, b), (n, u)


def test_sorted_multinomial_distribution():
    """Large-N multinomial path (sorted uniforms + rank merge): offspring
    counts match expectations within Poisson noise (z < 4 per bucket)."""
    from gen_tpu.inference.particle_filter import _resample_parents
    n = 40000
    lw = jnp.log(jnp.arange(1, n + 1, dtype=jnp.float64))
    lnw = lw - jax.scipy.special.logsumexp(lw)
    total = np.zeros(n)
    reps = 20
    for s in range(reps):
        parents = _resample_parents(jax.random.PRNGKey(s), lnw,
                                    "multinomial")
        total += np.bincount(np.asarray(parents), minlength=n)
    w = np.exp(np.asarray(lnw))
    bc = total.reshape(100, -1).sum(axis=1)
    bw = (reps * n * w).reshape(100, -1).sum(axis=1)
    z = np.abs(bc - bw) / np.sqrt(bw)
    assert z.max() < 4.5, z.max()


@pytest.mark.parametrize("n", [1, 7, 1000, 40000])
def test_resampling_formulations_agree(n):
    """The three exact systematic formulations (searchsorted, sort rank
    merge, scatter-add counting) and the dispatcher give the same parents."""
    from gen_tpu.ops.resample import (_counting_systematic, _jnp_systematic,
                                      _sorted_systematic)
    lw = jax.random.normal(jax.random.PRNGKey(n), (n,)) * 1.5
    for u in (0.0, 0.41, 0.999):
        a = np.asarray(_jnp_systematic(lw, u))
        np.testing.assert_array_equal(np.asarray(_sorted_systematic(lw, u)), a)
        np.testing.assert_array_equal(np.asarray(_counting_systematic(lw, u)),
                                      a)
        np.testing.assert_array_equal(np.asarray(systematic_resample(lw, u)),
                                      a)


@pytest.mark.parametrize("env_set", [True, False])
def test_compile_cache_rule(monkeypatch, tmp_path, env_set):
    """JAX_COMPILATION_CACHE_DIR, when set, is used as it is and nothing
    else is set; otherwise the cache is <checkout>/.jax_cache."""
    import os
    from gen_tpu.utils import use_compile_cache
    before = jax.config.jax_compilation_cache_dir
    try:
        if env_set:
            monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
            assert use_compile_cache() == str(tmp_path)
            assert jax.config.jax_compilation_cache_dir == before
        else:
            monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
            root = os.path.dirname(os.path.dirname(os.path.abspath(
                __file__)))
            want = os.path.join(root, ".jax_cache")
            assert use_compile_cache() == want
            assert jax.config.jax_compilation_cache_dir == want
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
