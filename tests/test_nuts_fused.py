"""Many-chain FSM-NUTS (ops/nuts_fused.py): the one-call engine is the
vmapped pair-scheduled FSM (``inference.nuts_fsm.nuts_fsm_paired``) —
exactly, under the same keys — and its draws, chunked driver, draw
collector and frozen-coordinate conditioning recover exact moments."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import gen_tpu as gt
from gen_tpu import choicemap, gen, select
from gen_tpu.ops.nuts_fused import nuts_chains_fused

KEY = jax.random.PRNGKey(0)


def test_fallback_gaussian_moments():
    """The vmapped pair FSM: anisotropic Gaussian moments recovered from
    the per-tick history. x64 off: the entry point is an f32 program and
    the suite-wide x64 default would promote the closure constants."""
    with jax.enable_x64(False):
        _run_fallback_gaussian_moments()


def _run_fallback_gaussian_moments():
    sds = jnp.array([1.0, 4.0])

    def logp(x):
        return -0.5 * jnp.sum((x / sds) ** 2)

    vals0 = jax.random.normal(KEY, (128, 2)) * sds
    vals, hist, hcnt, cnt, stats = nuts_chains_fused(
        jax.random.PRNGKey(2), logp, vals0, num_ticks=600, eps=0.5,
        max_depth=6, inv_mass_diag=sds ** 2, collect_idx=1)
    assert vals.shape == (128, 2)
    assert hist.shape == (300, 128)        # one row per two-leapfrog tick
    assert hcnt.shape == (300, 128)
    s = np.asarray(hist)[100:]
    assert abs(s.mean()) < 0.35
    np.testing.assert_allclose(s.std(), 4.0, rtol=0.1)
    assert int(cnt.min()) > 0
    np.testing.assert_array_equal(np.asarray(hcnt[-1]), np.asarray(cnt))
    assert float(jnp.mean(stats["mean_accept"])) > 0.6


def test_chunked_driver_stitches_streams():
    """Chunked driver: cumulative counts nondecreasing across chunk
    boundaries, final counts equal the last count row, extraction works on
    the stitched streams, and moments stay correct."""
    from gen_tpu.ops.nuts_fused import (nuts_chains_fused_chunked,
                                        extract_completed_draws)
    with jax.enable_x64(False):
        def logp(x):
            return -0.5 * jnp.sum(x * x)

        vals0 = jax.random.normal(KEY, (64, 2)) * 2.0
        vals, hist, hcnt, cnt, stats = nuts_chains_fused_chunked(
            jax.random.PRNGKey(3), logp, vals0, num_ticks=600, eps=0.5,
            chunk_ticks=150, max_depth=6, collect_idx=1)
        assert hist.shape == (300, 64) and hcnt.shape == (300, 64)
        dif = np.diff(np.asarray(hcnt), axis=0)
        assert (dif >= 0).all()
        np.testing.assert_array_equal(np.asarray(hcnt[-1]), np.asarray(cnt))
        m = int(cnt.min())
        assert m > 10
        draws = np.asarray(extract_completed_draws(hist, hcnt, m))
        assert draws.shape == (m, 64)
        assert abs(draws[m // 4:].mean()) < 0.3
        np.testing.assert_allclose(draws[m // 4:].std(), 1.0, rtol=0.12)


def test_frozen_mask_gibbs_within_nuts_gmm():
    """Mixed discrete/continuous inference THROUGH the fused-NUTS engine:
    2-component GMM where the means move by NUTS (free coordinates) while
    per-chain sufficient statistics of the current assignments (counts,
    sums) ride in the SAME state vector as frozen coordinates
    (inv_mass = 0), updated between NUTS calls by an exact discrete Gibbs
    step. Cross-chain moments of the means must match EXACT enumeration
    over all 2^N assignment vectors (conjugate per-cluster evidence).
    This is the 'observed-subset conditioning reaches the sampler'
    contract: per-chain conditioning values live in the chain state, not
    in the shared closure."""
    with jax.enable_x64(False):
        _run_gibbs_within_nuts_gmm()


def _run_gibbs_within_nuts_gmm():
    from gen_tpu.ops.nuts_fused import nuts_chains_fused

    sigma, tau = 1.0, 3.0
    ys = jnp.asarray([-2.3, -1.8, -2.1, -1.6, 1.7, 2.2, 1.9, 2.4],
                     jnp.float32)
    N = ys.shape[0]

    # exact symmetric posterior moments of mu_0 by enumeration
    import itertools
    y_np = np.asarray(ys, np.float64)
    logws, m0s, v0s = [], [], []
    for z in itertools.product([0, 1], repeat=N):
        z = np.asarray(z)
        lw, ms, vs = 0.0, [], []
        for k in (0, 1):
            yk = y_np[z == k]
            nk = len(yk)
            vk = 1.0 / (1.0 / tau ** 2 + nk / sigma ** 2)
            mk = vk * yk.sum() / sigma ** 2
            lw += 0.5 * np.log(vk / tau ** 2) + 0.5 * mk ** 2 / vk
            ms.append(mk)
            vs.append(vk)
        logws.append(lw)
        m0s.append(ms[0])
        v0s.append(vs[0])
    w = np.exp(np.asarray(logws) - max(logws))
    w /= w.sum()
    ex_mean = float(w @ np.asarray(m0s))
    ex_var = float(w @ (np.asarray(v0s) + np.asarray(m0s) ** 2)
                   - ex_mean ** 2)

    # state: [mu0, mu1, c0, c1, s0, s1]; counts/sums frozen
    def logp(v):
        mu = v[:2]
        c = v[2:4]
        s = v[4:6]
        prior = -0.5 * jnp.sum(mu ** 2) / tau ** 2
        lik = jnp.sum(-0.5 * c * mu ** 2 / sigma ** 2
                      + mu * s / sigma ** 2)
        return prior + lik

    inv_mass = jnp.asarray([1.0, 1.0, 0.0, 0.0, 0.0, 0.0], jnp.float32)
    n_chains, outer, ticks = 512, 60, 12

    @jax.jit
    def gibbs_assignments(key, v):
        mu = v[:, :2]                                    # (n, 2)
        lp = -0.5 * (ys[None, :, None] - mu[:, None, :]) ** 2 / sigma ** 2
        z = jax.random.categorical(key, lp, axis=-1)     # (n, N)
        one = (z[..., None] == jnp.arange(2)).astype(jnp.float32)
        c = jnp.sum(one, axis=1)                         # (n, 2)
        s = jnp.sum(one * ys[None, :, None], axis=1)     # (n, 2)
        return v.at[:, 2:4].set(c).at[:, 4:6].set(s)

    key = jax.random.PRNGKey(0)
    k_init, key = jax.random.split(key)
    v = jnp.concatenate([
        jax.random.normal(k_init, (n_chains, 2)) * tau,
        jnp.zeros((n_chains, 4))], axis=1)
    v = gibbs_assignments(jax.random.fold_in(key, 10_000), v)
    for it in range(outer):
        k_n, k_g = jax.random.split(jax.random.fold_in(key, it))
        v, _, _, _, _ = nuts_chains_fused(
            k_n, logp, v, num_ticks=ticks, eps=0.3, max_depth=4,
            inv_mass_diag=inv_mass, collect_idx=0)
        v = gibbs_assignments(k_g, v)

    mu0 = np.asarray(v[:, 0], np.float64)
    # symmetric init + label symmetry: cross-chain mu0 targets the exact
    # symmetric (bimodal) posterior
    assert abs(mu0.mean() - ex_mean) < 0.12, (mu0.mean(), ex_mean)
    assert abs(mu0.var() / ex_var - 1.0) < 0.12, (mu0.var(), ex_var)
    # frozen stats stayed exactly what Gibbs wrote (NUTS never moved them)
    c = np.asarray(v[:, 2:4])
    assert np.all(c.sum(axis=1) == N)


def test_collect_draws_matches_stitched_extraction():
    """nuts_collect_draws (bounded-memory chunk folding) reproduces the
    stitched-stream extract_completed_draws exactly on the same keys."""
    from gen_tpu.ops.nuts_fused import (extract_completed_draws,
                                        nuts_chains_fused_chunked,
                                        nuts_collect_draws)

    sds = jnp.array([1.0, 2.0])

    def logp(x):
        return -0.5 * jnp.sum((x / sds) ** 2)

    n, ticks = 64, 240
    vals0 = jax.random.normal(KEY, (n, 2)) * sds
    key = jax.random.PRNGKey(5)
    kw = dict(eps=0.7, max_depth=4, collect_idx=1)

    _, hist, hcnt, cnt, _ = nuts_chains_fused_chunked(
        key, logp, vals0, num_ticks=ticks, chunk_ticks=80, **kw)
    m = int(jnp.min(cnt))
    ref = np.asarray(extract_completed_draws(hist, hcnt, m))

    draws, _, counts, used = nuts_collect_draws(
        key, logp, vals0, num_draws=m, chunk_ticks=80, max_ticks=ticks,
        **kw)
    assert used <= ticks
    got = np.asarray(draws)
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, ref[:m], rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(np.asarray(counts) >= m, True)


def test_pair_twin_moments_match_exact():
    """Pair-SCHEDULE semantics (not just kernel-vs-twin): the pair twin's
    completed draws must match exact anisotropic-Gaussian moments — the
    multi-dim variance gate that catches stopping-rule asymmetries
    (cf. the round-1 checkpoint-momentum bug, invisible to 1-D tests)."""
    from gen_tpu.inference.nuts_fsm import nuts_fsm_paired
    from gen_tpu.ops.nuts_fused import extract_completed_draws

    sds = jnp.array([1.0, 3.0, 0.5])

    def logp(x):
        return -0.5 * jnp.sum((x / sds) ** 2)

    vag = jax.value_and_grad(logp)
    n, pairs = 1024, 300
    vals0 = jax.random.normal(KEY, (n, 3)) * sds
    keys = jax.random.split(jax.random.PRNGKey(1), n)
    res, (hist, hcnt) = jax.jit(lambda ks, v: jax.vmap(
        lambda kk, t: nuts_fsm_paired(
            kk, vag, t, 0.5, pairs, max_depth=6,
            inv_mass_diag=sds ** 2, collect_idx="all"))(ks, v))(
        keys, vals0)
    m = int(jnp.min(res.counts))
    assert m > 40
    draws = np.asarray(extract_completed_draws(
        jnp.swapaxes(hist, 0, 1), jnp.swapaxes(hcnt, 0, 1), m))
    dd = draws[m // 4:]
    np.testing.assert_allclose(dd.var(axis=(0, 1)),
                               np.asarray(sds) ** 2, rtol=0.06)
    assert np.abs(dd.mean(axis=(0, 1)) / np.asarray(sds)).max() < 0.05


def test_paired_chunked_driver_stitches():
    """The chunked driver: cumulative counts stitch across chunk
    boundaries and extracted draws are finite/sane."""
    from gen_tpu.ops.nuts_fused import (extract_completed_draws,
                                        nuts_chains_fused_chunked)

    sds = jnp.array([1.0, 2.0])

    def logp(x):
        return -0.5 * jnp.sum((x / sds) ** 2)

    n, ticks = 64, 240
    vals0 = jax.random.normal(KEY, (n, 2)) * sds
    _, hist, hcnt, cnt, _ = nuts_chains_fused_chunked(
        jax.random.PRNGKey(5), logp, vals0, num_ticks=ticks,
        chunk_ticks=80, eps=0.7, max_depth=4, collect_idx=1)
    m = int(jnp.min(cnt))
    assert m > 10
    np.testing.assert_array_equal(np.asarray(hcnt[-1]), np.asarray(cnt))
    draws = np.asarray(extract_completed_draws(hist, hcnt, m))
    assert np.all(np.isfinite(draws))
    assert abs(draws[m // 4:].mean()) < 0.35


@pytest.mark.parametrize("collect_idx", [1, None])
def test_one_call_engine_is_vmapped_pair_fsm(collect_idx):
    """nuts_chains_fused is nuts_fsm_paired vmapped over chains with the
    keys split from its key, in ONE call: same keys, same decisions and
    counts; positions agree to f32 rounding (the one-call program is
    compiled as a whole, the reference op by op)."""
    from gen_tpu.inference.nuts_fsm import nuts_fsm_paired
    with jax.enable_x64(False):
        sds = jnp.array([1.0, 3.0, 0.5])

        def logp(x):
            return -0.5 * jnp.sum((x / sds) ** 2) - 0.2 * x[0] * x[2]

        n, ticks = 32, 60
        vals0 = jax.random.normal(KEY, (n, 3)) * sds
        key = jax.random.PRNGKey(8)
        v, hist, hcnt, cnt, stats = nuts_chains_fused(
            key, logp, vals0, num_ticks=ticks, eps=0.4, max_depth=5,
            inv_mass_diag=sds ** 2, collect_idx=collect_idx)
        vag = jax.value_and_grad(logp)
        res, (h_r, c_r) = jax.vmap(lambda kk, t: nuts_fsm_paired(
            kk, vag, t, 0.4, ticks // 2, max_depth=5,
            inv_mass_diag=sds ** 2,
            collect_idx="all" if collect_idx is None else collect_idx))(
            jax.random.split(key, n), vals0)
    np.testing.assert_array_equal(np.asarray(cnt), np.asarray(res.counts))
    np.testing.assert_array_equal(np.asarray(hcnt), np.asarray(c_r).T)
    np.testing.assert_allclose(np.asarray(hist),
                               np.asarray(jnp.moveaxis(h_r, 0, 1)),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.asarray(v), np.asarray(res.theta),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.asarray(stats["mean_depth"]),
                               np.asarray(res.mean_depth), rtol=1e-6)
