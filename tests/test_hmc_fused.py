"""Fused HMC kernel (ops/hmc_fused.py): layout plumbing, XLA-path
posterior recovery, scalarization equivalence, the in-kernel Threefry
generator, the backend decision, and — through Pallas' interpret mode with
injected randomness — EXACT kernel-vs-reference comparison on the CPU, so
the tests exercise the real kernel logic. Statistics of the compiled
kernel on the card are the ``gpu``-marked tests and ``chip_smoke.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import gen_tpu as gt
from gen_tpu import choicemap, gen, select
from gen_tpu.inference.target import FlatTarget
from gen_tpu.ops.hmc_fused import hmc_chains_fused, _pad_lanes

KEY = jax.random.PRNGKey(0)


def test_plane_layout_roundtrip():
    v = jnp.arange(5 * 3, dtype=jnp.float32).reshape(5, 3)
    planes = _pad_lanes(v.T, 16, 1)
    assert planes.shape == (3, 16)
    np.testing.assert_allclose(planes[:, :5].T, v)
    # padding lanes are copies of chain 0 (finite logp guaranteed)
    np.testing.assert_allclose(planes[:, 5:].T,
                               jnp.broadcast_to(v[0], (11, 3)))


def test_fallback_gaussian_exactness():
    def logp(x):
        return -0.5 * jnp.sum(x * x)

    vals0 = jax.random.normal(KEY, (64, 2)) * 3.0
    vals, coll, accs = hmc_chains_fused(
        jax.random.PRNGKey(1), logp, vals0, n_steps=500, L=5, eps=0.5,
        collect_idx=1)
    assert vals.shape == (64, 2)
    assert coll.shape == (500, 64)
    assert accs.shape == (64,)
    s = np.asarray(coll)[100:]
    assert abs(s.mean()) < 0.05
    assert abs(s.std() - 1.0) < 0.05
    assert float(np.mean(np.asarray(accs))) / 500 > 0.8


def test_fallback_matches_flat_target_model():
    """The fused entry point accepts FlatTarget.logp of a real model and
    recovers the exact conjugate posterior (fallback path; the kernel path
    runs the same staged logp on the GPU)."""
    n = 40
    sigma = 0.5
    rng = np.random.default_rng(0)
    xs = jnp.linspace(-2.0, 2.0, n)
    X = jnp.stack([xs, jnp.ones_like(xs)], axis=1)
    beta_true = np.array([0.7, -0.4])
    ys = jnp.asarray(X @ beta_true + sigma * rng.standard_normal(n))

    @gen
    def m(X):
        slope = gt.normal(0.0, 2.0) @ "slope"
        intercept = gt.normal(0.0, 2.0) @ "intercept"
        gt.normal_linear(X, jnp.stack([slope, intercept]), sigma) @ "ys"

    obs = choicemap(ys=ys)
    sel = select("slope", "intercept")
    one, _ = m.generate(KEY, (X,), obs)
    target = FlatTarget(one, sel)
    P = np.asarray(X.T @ X) / sigma ** 2 + np.eye(2) / 4.0
    Sig = np.linalg.inv(P)
    mu = Sig @ (np.asarray(X.T @ ys) / sigma ** 2)

    vals0 = mu[None, :] + 0.3 * np.asarray(
        jax.random.normal(KEY, (128, 2)))
    vals, coll, accs = hmc_chains_fused(
        jax.random.PRNGKey(2), target.logp, jnp.asarray(vals0),
        n_steps=400, L=8, eps=0.05)
    paths = [p for p, _ in one.get_choices().filter(sel).leaf_items()]
    i_s, i_i = paths.index(("slope",)), paths.index(("intercept",))
    vv = np.asarray(vals)
    est = np.array([vv[:, i_s].mean(), vv[:, i_i].mean()])
    np.testing.assert_allclose(
        est, mu,
        atol=float(4 * np.sqrt(np.diag(Sig).max()) / np.sqrt(128) + 2e-3))
    sd = np.array([vv[:, i_s].std(), vv[:, i_i].std()])
    np.testing.assert_allclose(sd, np.sqrt(np.diag(Sig)), rtol=0.3)


@pytest.mark.gpu
def test_pallas_kernel_gaussian_exactness(gpu):
    def logp(x):
        return -0.5 * jnp.sum(x * x)

    vals0 = jax.random.normal(KEY, (4096, 2)) * 2.0
    vals, coll, accs = hmc_chains_fused(
        jax.random.PRNGKey(1), logp, vals0, n_steps=400, L=5, eps=0.5)
    s = np.asarray(coll)[100:]
    assert abs(s.mean()) < 0.02
    assert abs(s.std() - 1.0) < 0.02


def test_scalarize_matches_logp_and_grad():
    """stage_scalarized: plane evaluation of the full assess-logp matches
    per-chain evaluation exactly, and the data-only subgraph partial-
    evaluates down to a handful of residual scalars."""
    from gen_tpu.ops.scalarize import stage_scalarized

    n = 50
    xs = jnp.linspace(-3.0, 3.0, n)
    rng = np.random.default_rng(0)
    ys = 0.7 * xs - 0.4 + 0.5 * jnp.asarray(rng.standard_normal(n))
    X = jnp.stack([xs, jnp.ones_like(xs)], axis=1)

    @gen
    def m(X):
        slope = gt.normal(0.0, 2.0) @ "slope"
        intercept = gt.normal(0.0, 2.0) @ "intercept"
        log_noise = gt.normal(0.0, 1.0) @ "log_noise"
        gt.normal_linear(X, jnp.stack([slope, intercept]),
                         jnp.exp(log_noise)) @ "ys"

    one, _ = m.generate(KEY, (X,), choicemap(ys=ys))
    target = FlatTarget(one, select("slope", "intercept", "log_noise"))
    plane_fn, res = stage_scalarized(target.logp, 3)
    # the 50-point dataset must NOT survive into the kernel
    assert res.shape[0] < 32

    V = jnp.asarray(np.random.default_rng(9).standard_normal((3, 8, 16)),
                    jnp.float32)
    res_list = [res[i] for i in range(res.shape[0])]
    lp = plane_fn(V, res_list)
    assert lp.shape == (8, 16)
    f = lambda vv: plane_fn(vv, res_list)
    lpv, pb = jax.vjp(f, V)
    g = pb(jnp.ones_like(lpv))[0]
    for i in range(8):
        for j in range(0, 16, 5):
            ref = float(target.logp(V[:, i, j]))
            np.testing.assert_allclose(float(lp[i, j]), ref,
                                       rtol=5e-4, atol=1e-3)
            gref = np.asarray(jax.grad(target.logp)(V[:, i, j]))
            np.testing.assert_allclose(np.asarray(g[:, i, j]), gref,
                                       rtol=5e-3, atol=5e-3)


def test_scalarize_streams_data_dependent_residual():
    """A likelihood whose x-dependent part touches the raw data STREAMS:
    the dataset becomes a data table, the per-point arithmetic a lazy DAG
    evaluated by an in-kernel loop, and plane_vag assembles exact
    gradients without differentiating through the loop. With streaming
    disabled staging refuses with clear advice (XLA path)."""
    from gen_tpu.ops.scalarize import stage_scalarized
    data = jnp.asarray(np.random.default_rng(0).standard_normal(5000),
                       jnp.float32)

    def logp(x):
        # per-point student-t likelihood: no sufficient statistics, the
        # residual touches all 5000 points
        z = (data - x[0]) / jnp.exp(x[1])
        return jnp.sum(-jnp.log1p(z * z)) - x[1] * 5000

    staged = stage_scalarized(logp, 2)
    assert staged.stream_data is not None
    # the table pads to a whole number of STREAM_BLOCK-point evaluation
    # blocks (edge values, masked out of the sums)
    from gen_tpu.ops.scalarize import STREAM_BLOCK
    assert staged.stream_data.shape[0] == 1
    assert staged.stream_data.shape[1] >= 5000
    assert staged.stream_data.shape[1] % STREAM_BLOCK == 0
    # the unrolled residual stayed tiny — the dataset did NOT unroll
    assert staged.res_consts.shape[0] < 32
    res = [staged.res_consts[i]
           for i in range(int(staged.res_consts.shape[0]))]
    V = jnp.asarray(np.random.default_rng(1).standard_normal((2, 8, 8)),
                    jnp.float32) * 0.5
    lp, g = staged.plane_vag(V, res, staged.stream_data)
    lp2 = staged.plane_fn(V, res, staged.stream_data)
    np.testing.assert_allclose(np.asarray(lp), np.asarray(lp2), rtol=1e-6)
    for i in range(0, 8, 3):
        for j in range(0, 8, 3):
            ref = float(logp(V[:, i, j]))
            gref = np.asarray(jax.grad(logp)(V[:, i, j]))
            np.testing.assert_allclose(float(lp[i, j]), ref, rtol=2e-5,
                                       atol=1e-4)
            np.testing.assert_allclose(np.asarray(g[:, i, j]), gref,
                                       rtol=1e-3, atol=1e-3)

    with pytest.raises(ValueError, match="use the XLA path"):
        stage_scalarized(logp, 2, allow_stream=False)

    # a data sum re-entering per-point arithmetic (non-additive) refuses
    def logp_nonadd(x):
        z = (data - x[0]) / jnp.exp(x[1])
        return jnp.exp(jnp.sum(-jnp.log1p(z * z)) * 1e-4)

    staged2 = stage_scalarized(logp_nonadd, 2)
    with pytest.raises(NotImplementedError, match="data-sum"):
        staged2.plane_fn(V, res, staged2.stream_data)


def test_fallback_mass_matrix():
    """Diagonal mass: a badly scaled Gaussian (sd 1 and sd 30) mixes when
    inv_mass ~ posterior variance; the kernel and fallback share the
    parameterization (momenta ~ N(0, M), kinetic p^T M^-1 p / 2)."""
    sds = jnp.array([1.0, 30.0])

    def logp(x):
        return -0.5 * jnp.sum((x / sds) ** 2)

    vals0 = jax.random.normal(KEY, (128, 2)) * sds
    vals, coll, accs = hmc_chains_fused(
        jax.random.PRNGKey(3), logp, vals0, n_steps=400, L=8, eps=0.7,
        collect_idx=None, inv_mass_diag=sds ** 2)
    s = np.asarray(coll)[100:]
    assert float(np.mean(np.asarray(accs))) / 400 > 0.6
    np.testing.assert_allclose(s[..., 0].std(), 1.0, rtol=0.1)
    np.testing.assert_allclose(s[..., 1].std(), 30.0, rtol=0.1)


def _reference_hmc_injected(logp, values0, eps_steps, z, u, L, inv_mass,
                            collect_idx):
    """Plain-XLA reference consuming the same injected randomness as the
    kernel: exact comparison target for the interpret-mode tests."""
    lp_fn = jax.vmap(logp)
    g_fn = jax.vmap(jax.grad(logp))
    v = values0
    lp, g = lp_fn(v), g_fn(v)
    acc = jnp.zeros(v.shape[0])
    collected = []
    mom_scale = 1.0 / jnp.sqrt(inv_mass)

    def kin(m):
        return 0.5 * jnp.sum(inv_mass * m * m, axis=1)

    for i in range(eps_steps.shape[0]):
        eps_i = eps_steps[i]
        mom0 = mom_scale * z[i]
        vv, m, gg, llp = v, mom0, g, lp
        for _ in range(L):
            m = m + 0.5 * eps_i * gg
            vv = vv + eps_i * inv_mass * m
            llp, gg = lp_fn(vv), g_fn(vv)
            m = m + 0.5 * eps_i * gg
        alpha = llp - lp - kin(m) + kin(mom0)
        alpha = jnp.where(jnp.isnan(alpha), -jnp.inf, alpha)
        accept = jnp.log(u[i]) < alpha
        v = jnp.where(accept[:, None], vv, v)
        lp = jnp.where(accept, llp, lp)
        g = jnp.where(accept[:, None], gg, g)
        acc = acc + accept
        collected.append(v if collect_idx is None else v[:, collect_idx])
    return v, jnp.stack(collected), acc


def _injected_rng(key, n_steps, n, d, eps, jitter):
    ks = jax.random.split(key, 3)
    eps_steps = eps * (1.0 - jitter
                       + 2.0 * jitter * jax.random.uniform(ks[0], (n_steps,)))
    z = jax.random.normal(ks[1], (n_steps, n, d))
    u = jnp.maximum(jax.random.uniform(ks[2], (n_steps, n)), 1e-30)
    return eps_steps, z, u


def test_interpret_kernel_matches_reference_exactly():
    """The ACTUAL kernel (Pallas interpret mode on the CPU) with injected
    randomness must match the plain-XLA reference step for step — leapfrog
    arithmetic, diagonal mass, MH accept, layout, collection. x64 is
    disabled locally: the kernel is an f32 program, and the suite-wide
    x64 default would promote staged literals to f64."""
    with jax.enable_x64(False):
        _run_interpret_gaussian_case()


def _run_interpret_gaussian_case():
    sds = jnp.array([1.0, 4.0, 0.5])

    def logp(x):
        return -0.5 * jnp.sum((x / sds) ** 2)

    n, d, n_steps, L = 1024, 3, 30, 4
    vals0 = jax.random.normal(KEY, (n, d)) * sds
    inv_mass = sds ** 2
    rng = _injected_rng(jax.random.PRNGKey(7), n_steps, n, d, 0.5, 0.2)

    vals_k, coll_k, acc_k = hmc_chains_fused(
        jax.random.PRNGKey(1), logp, vals0, n_steps=n_steps, L=L, eps=0.5,
        collect_idx=1, inv_mass_diag=inv_mass, injected_rng=rng,
        interpret=True)
    vals_r, coll_r, acc_r = _reference_hmc_injected(
        logp, vals0, *rng, L, inv_mass, 1)

    np.testing.assert_allclose(np.asarray(acc_k), np.asarray(acc_r))
    np.testing.assert_allclose(np.asarray(vals_k), np.asarray(vals_r),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.asarray(coll_k), np.asarray(coll_r),
                               rtol=1e-5, atol=1e-5)
    assert 0.3 < float(jnp.mean(acc_k)) / n_steps


def test_interpret_kernel_scalarized_model():
    """Interpret-mode kernel on the full GFI assess-logp via the
    scalarization pass (the exact production configuration of bench.py),
    collect_idx=None (all coordinates)."""
    with jax.enable_x64(False):
        _run_interpret_scalarized_case()


def _run_interpret_scalarized_case():
    n_pts = 50
    xs = jnp.linspace(-3.0, 3.0, n_pts)
    rng0 = np.random.default_rng(0)
    ys = 0.7 * xs - 0.4 + 0.5 * jnp.asarray(rng0.standard_normal(n_pts))
    X = jnp.stack([xs, jnp.ones_like(xs)], axis=1)

    @gen
    def m(X):
        slope = gt.normal(0.0, 2.0) @ "slope"
        intercept = gt.normal(0.0, 2.0) @ "intercept"
        log_noise = gt.normal(0.0, 1.0) @ "log_noise"
        gt.normal_linear(X, jnp.stack([slope, intercept]),
                         jnp.exp(log_noise)) @ "ys"

    one, _ = m.generate(KEY, (X,), choicemap(ys=ys))
    target = FlatTarget(one, select("slope", "intercept", "log_noise"))

    n, d, n_steps, L = 1024, 3, 12, 3
    vals0 = 0.1 * jax.random.normal(KEY, (n, d))
    rng = _injected_rng(jax.random.PRNGKey(3), n_steps, n, d, 0.035, 0.2)

    vals_k, coll_k, acc_k = hmc_chains_fused(
        jax.random.PRNGKey(1), target.logp, vals0, n_steps=n_steps, L=L,
        eps=0.035, collect_idx=None, injected_rng=rng, interpret=True)
    vals_r, coll_r, acc_r = _reference_hmc_injected(
        target.logp, vals0, *rng, L, jnp.ones(d), None)

    np.testing.assert_allclose(np.asarray(acc_k), np.asarray(acc_r))
    np.testing.assert_allclose(np.asarray(vals_k), np.asarray(vals_r),
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(np.asarray(coll_k), np.asarray(coll_r),
                               rtol=2e-4, atol=2e-4)
    assert float(jnp.mean(acc_k)) / n_steps > 0.5


def _kalman_logp(T=6, seed=0):
    """Collapsed AR(2)-style LGSSM posterior logp: priors on (phi, log_q,
    log_r), likelihood = exact Kalman marginal via a lax.scan of matmuls +
    cholesky + cho_solve — the scalarize extension (unrolled scan /
    cholesky / triangular_solve / static gather)."""
    from gen_tpu.models.lgssm import LGSSMParams, kalman_filter
    rng = np.random.default_rng(seed)
    ys = jnp.asarray(rng.standard_normal((T, 1)), jnp.float32)
    I2 = jnp.eye(2, dtype=jnp.float32)

    def logp(x):
        phi, log_q, log_r = x[0], x[1], x[2]
        A = jnp.array([[0.0, 1.0], [0.0, 0.0]], jnp.float32) + phi * I2
        Q = jnp.exp(log_q) * I2
        C = jnp.array([[1.0, 0.0]], jnp.float32)
        R = jnp.exp(log_r) * jnp.eye(1, dtype=jnp.float32)
        params = LGSSMParams(A, Q, C, R, jnp.zeros(2, jnp.float32), I2)
        return (kalman_filter(params, ys).log_ml
                - 0.5 * (phi ** 2 + log_q ** 2 + log_r ** 2))

    return logp


def test_scalarize_scan_kalman_exact():
    """Scalarized collapsed-Kalman logp (scan unrolled, cholesky and
    triangular solves as explicit arithmetic) matches direct evaluation
    and autodiff."""
    from gen_tpu.ops.scalarize import stage_scalarized
    logp = _kalman_logp()
    plane_fn, res = stage_scalarized(logp, 3)
    assert res.shape[0] < 64
    V = jnp.asarray(np.random.default_rng(1).standard_normal(
        (3, 8, 16)) * 0.3, jnp.float32)
    res_list = [res[i] for i in range(res.shape[0])]
    lp = plane_fn(V, res_list)
    f = lambda vv: plane_fn(vv, res_list)
    lpv, pb = jax.vjp(f, V)
    g = pb(jnp.ones_like(lpv))[0]
    for i in range(0, 8, 3):
        for j in range(0, 16, 7):
            ref = float(logp(V[:, i, j]))
            np.testing.assert_allclose(float(lp[i, j]), ref, rtol=1e-4,
                                       atol=1e-3)
            gref = np.asarray(jax.grad(logp)(V[:, i, j]))
            np.testing.assert_allclose(np.asarray(g[:, i, j]), gref,
                                       rtol=3e-3, atol=3e-3)


def test_interpret_kernel_kalman_scan_model():
    """The ACTUAL fused HMC kernel on a scan-based (Kalman) logp in
    Pallas interpret mode, exact against the plain-XLA reference."""
    with jax.enable_x64(False):
        _run_interpret_kalman_case()


def _run_interpret_kalman_case():
    # tiny budget: interpret mode executes each of the unrolled Kalman
    # plane ops through the interpreter, so op count is the cost
    logp = _kalman_logp(T=3)
    n, d, n_steps, L = 256, 3, 3, 2
    vals0 = 0.2 * jax.random.normal(KEY, (n, d))
    rng = _injected_rng(jax.random.PRNGKey(5), n_steps, n, d, 0.1, 0.2)
    vals_k, coll_k, acc_k = hmc_chains_fused(
        jax.random.PRNGKey(1), logp, vals0, n_steps=n_steps, L=L,
        eps=0.1, collect_idx=0, injected_rng=rng, interpret=True)
    vals_r, coll_r, acc_r = _reference_hmc_injected(
        logp, vals0, *rng, L, jnp.ones(d), 0)
    agree = np.mean(np.asarray(acc_k) == np.asarray(acc_r))
    assert agree > 0.99, agree
    match = np.isclose(np.asarray(vals_k), np.asarray(vals_r),
                       rtol=2e-3, atol=2e-3).all(axis=1)
    assert np.mean(match) > 0.99, np.mean(match)


def test_interpret_kernel_streamed_likelihood():
    """The ACTUAL kernel (interpret mode) running a STREAMED
    non-collapsible likelihood (robust-t regression, n = 2560): the
    dataset is a table in device memory, the logp runs the in-kernel
    data loop with hand-assembled gradients, and the result matches the
    plain-XLA reference consuming the same injected randomness."""
    with jax.enable_x64(False):
        _run_interpret_streamed()


def _run_interpret_streamed():
    n_pts = 2560
    rng = np.random.default_rng(0)
    xd = jnp.asarray(rng.standard_normal(n_pts), jnp.float32)
    yd = jnp.asarray(0.7 * np.asarray(xd) - 0.4
                     + 0.5 * rng.standard_normal(n_pts), jnp.float32)

    @gen
    def m():
        slope = gt.normal(0.0, 2.0) @ "slope"
        intercept = gt.normal(0.0, 2.0) @ "intercept"
        gt.student_t(4.0, slope * xd + intercept, 0.5) @ "ys"

    one, _ = m.generate(KEY, (), choicemap(ys=yd))
    target = FlatTarget(one, select("slope", "intercept"))

    from gen_tpu.ops.scalarize import stage_scalarized
    staged = stage_scalarized(target.logp, 2)
    assert staged.stream_data is not None   # really streaming

    n, d, n_steps, L = 64, 2, 4, 3
    vals0 = jnp.asarray([0.7, -0.4], jnp.float32)[None, :] \
        + 0.1 * jax.random.normal(KEY, (n, d))
    eps_steps, z, u = _injected_rng(jax.random.PRNGKey(5), n_steps, n, d,
                                    0.02, 0.2)
    vals_k, coll_k, acc_k = hmc_chains_fused(
        jax.random.PRNGKey(1), target.logp, vals0, n_steps=n_steps, L=L,
        eps=0.02, collect_idx=0, injected_rng=(eps_steps, z, u),
        interpret=True)
    vals_r, coll_r, acc_r = _reference_hmc_injected(
        target.logp, vals0, eps_steps, z, u, L, jnp.ones(d), 0)
    np.testing.assert_array_equal(np.asarray(acc_k), np.asarray(acc_r))
    np.testing.assert_allclose(np.asarray(vals_k), np.asarray(vals_r),
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(np.asarray(coll_k), np.asarray(coll_r),
                               rtol=2e-4, atol=2e-4)


# ---- the in-kernel generator, padding, shapes, backend decision ----------

def _interp_kernel(body, out_shape, *inputs):
    """Run ``body(*input_refs, *output_refs)`` as a one-program
    Triton-route kernel in interpret mode."""
    import jax.experimental.pallas as pl
    return pl.pallas_call(body, grid=(1,), backend="triton",
                          out_shape=out_shape, interpret=True)(*inputs)


@pytest.mark.parametrize("seed,count_shape", [
    (0, (8,)), (1234567, (64,)), (2 ** 31 - 1, (4, 32))])
def test_threefry_matches_jax(seed, count_shape):
    """The kernel's Threefry-2x32 (add/rotate/xor only) gives the same
    bits as jax.random's threefry primitive, in jnp and inside an
    interpret-mode Triton kernel."""
    from jax.extend.random import threefry2x32_p
    from gen_tpu.ops.hmc_fused import threefry2x32
    k0, k1 = jax.random.key_data(jax.random.PRNGKey(seed)).astype(jnp.uint32)
    n = int(np.prod(count_shape))
    x0 = jnp.arange(n, dtype=jnp.uint32).reshape(count_shape) * 7919
    x1 = jnp.full(count_shape, seed % 1000, jnp.uint32) + 3
    want = threefry2x32_p.bind(k0, k1, x0, x1)
    got = threefry2x32(k0, k1, x0, x1)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    if len(count_shape) == 1:
        def body(k_ref, x0_ref, x1_ref, o0, o1):
            o0[...], o1[...] = threefry2x32(k_ref[0], k_ref[1], x0_ref[...],
                                            x1_ref[...])
        spec = jax.ShapeDtypeStruct(count_shape, jnp.uint32)
        got_k = _interp_kernel(body, (spec, spec), jnp.stack([k0, k1]),
                               x0, x1)
        for a, b in zip(got_k, want):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_kernel_normals_pass_ks():
    """Momentum draws as the kernel makes them (Box-Muller on Threefry
    counters, inside an interpret-mode kernel) are standard normal (KS),
    the accept uniforms uniform on (0, 1], the jitter draw shared."""
    from scipy import stats
    from gen_tpu.ops.hmc_fused import step_draws
    with jax.enable_x64(False):
        n, d = 4096, 3

        def body(k_ref, z_ref, u_ref, e_ref):
            lane = jax.lax.iota(jnp.int32, n).astype(jnp.uint32)
            e, z, u = step_draws(k_ref[0], k_ref[1], lane, 5, d)
            for k in range(d):
                z_ref[k, :] = z[k]
            u_ref[...] = u
            e_ref[...] = e + jnp.zeros((n,), jnp.float32)

        z, u, e = _interp_kernel(body, (
            jax.ShapeDtypeStruct((d, n), jnp.float32),
            jax.ShapeDtypeStruct((n,), jnp.float32),
            jax.ShapeDtypeStruct((n,), jnp.float32)),
            jnp.asarray([17, 4242], jnp.uint32))
    z, u, e = np.asarray(z), np.asarray(u), np.asarray(e)
    for k in range(d):
        assert stats.kstest(z[k], "norm").pvalue > 1e-3
    assert stats.kstest(u, "uniform").pvalue > 1e-3
    assert u.min() > 0.0 and u.max() <= 1.0
    assert np.all(e == e[0]) and 0.0 <= e[0] < 1.0


def test_kernel_own_generator_matches_reproduced_draws():
    """Without injected randomness the kernel draws from its own
    generator; step_draws reproduces those draws outside the kernel, so
    the reference consuming them matches the kernel exactly."""
    from gen_tpu.ops.hmc_fused import step_draws
    with jax.enable_x64(False):
        sds = jnp.array([1.0, 2.0])

        def logp(x):
            return -0.5 * jnp.sum((x / sds) ** 2)

        n, d, n_steps, L, eps, jit = 256, 2, 6, 3, 0.4, 0.2
        key = jax.random.PRNGKey(9)
        vals0 = jax.random.normal(KEY, (n, d)) * sds
        vk, ck, ak = hmc_chains_fused(key, logp, vals0, n_steps=n_steps,
                                      L=L, eps=eps, eps_jitter=jit,
                                      collect_idx=None, interpret=True)
        k0, k1 = jax.random.key_data(key).astype(jnp.uint32)
        lane = jnp.arange(n, dtype=jnp.uint32)
        eps_s, zs, us = [], [], []
        for i in range(n_steps):
            e, z, u = step_draws(k0, k1, lane, i, d)
            eps_s.append(eps * (1.0 - jit + 2.0 * jit * e))
            zs.append(jnp.stack(z, axis=1))
            us.append(u)
        vr, cr, ar = _reference_hmc_injected(
            logp, vals0, jnp.stack(eps_s), jnp.stack(zs), jnp.stack(us), L,
            jnp.ones(d), None)
    np.testing.assert_array_equal(np.asarray(ak), np.asarray(ar))
    np.testing.assert_allclose(np.asarray(ck), np.asarray(cr), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("n", [200, 70])
def test_padding_gives_unpadded_result(n):
    """A chain count that is not a multiple of the block pads with copies
    of chain 0; the un-padded result equals the run over a whole number
    of blocks restricted to its first n chains."""
    from gen_tpu.ops.hmc_fused import _BLOCK
    with jax.enable_x64(False):
        def logp(x):
            return -0.5 * jnp.sum(x * x)

        n_full = -(-n // _BLOCK) * _BLOCK
        d, n_steps = 2, 3
        vals = jax.random.normal(KEY, (n_full, d))
        rng = _injected_rng(jax.random.PRNGKey(2), n_steps, n_full, d,
                            0.3, 0.2)
        full = hmc_chains_fused(KEY, logp, vals, n_steps=n_steps, L=2,
                                eps=0.3, collect_idx=1, injected_rng=rng,
                                interpret=True)
        part = hmc_chains_fused(
            KEY, logp, vals[:n], n_steps=n_steps, L=2, eps=0.3,
            collect_idx=1, interpret=True,
            injected_rng=(rng[0], rng[1][:, :n], rng[2][:, :n]))
    assert part[0].shape == (n, d) and part[1].shape == (n_steps, n)
    np.testing.assert_array_equal(np.asarray(part[0]),
                                  np.asarray(full[0][:n]))
    np.testing.assert_array_equal(np.asarray(part[1]),
                                  np.asarray(full[1][:, :n]))
    np.testing.assert_array_equal(np.asarray(part[2]),
                                  np.asarray(full[2][:n]))


@pytest.mark.parametrize("collect_idx", [None, 0, 2])
def test_kernel_collected_shapes(collect_idx):
    """collect_idx=None records every coordinate ((steps, n, d)); an int
    records one ((steps, n)) — and it is that coordinate of the full
    record."""
    with jax.enable_x64(False):
        def logp(x):
            return -0.5 * jnp.sum(x * x)

        n, d, n_steps = 96, 3, 4
        vals = jax.random.normal(KEY, (n, d))
        rng = _injected_rng(jax.random.PRNGKey(4), n_steps, n, d, 0.3, 0.2)
        v, c, a = hmc_chains_fused(KEY, logp, vals, n_steps=n_steps, L=2,
                                   eps=0.3, collect_idx=collect_idx,
                                   injected_rng=rng, interpret=True)
        _, c_all, _ = hmc_chains_fused(KEY, logp, vals, n_steps=n_steps,
                                       L=2, eps=0.3, collect_idx=None,
                                       injected_rng=rng, interpret=True)
    assert v.shape == (n, d) and a.shape == (n,)
    if collect_idx is None:
        assert c.shape == (n_steps, n, d)
    else:
        assert c.shape == (n_steps, n)
        np.testing.assert_array_equal(np.asarray(c),
                                      np.asarray(c_all[..., collect_idx]))
    np.testing.assert_array_equal(np.asarray(c_all[-1]), np.asarray(v))


@pytest.mark.parametrize("platform,expect", [
    ("gpu", True), ("cpu", False), ("rocm", None), ("metal", None)])
def test_backend_decision(platform, expect):
    """One decision: the kernel on 'gpu', the XLA reference on 'cpu',
    and any other platform raises."""
    from gen_tpu.ops.backend import kernel_platform
    if expect is None:
        with pytest.raises(NotImplementedError, match="platform"):
            kernel_platform(platform)
    else:
        assert kernel_platform(platform) is expect


@pytest.mark.parametrize("d", [1, 3, 16])
def test_d_crossover_rule(d):
    """The kernel serves d up to HMC_KERNEL_MAX_D on the GPU; past it (and
    on the CPU) the XLA sampler runs."""
    from gen_tpu.ops.backend import HMC_KERNEL_MAX_D, hmc_kernel_route
    assert hmc_kernel_route(d, "gpu") is (d <= HMC_KERNEL_MAX_D)
    assert hmc_kernel_route(HMC_KERNEL_MAX_D * d + 1, "gpu") is False
    assert hmc_kernel_route(d, "cpu") is False


def test_unstaged_logp_runs_xla_path():
    """A logp the kernel cannot stage (a sort) is reported by
    stage_for_kernel, refused by the kernel's interpret hook, and sampled
    by the XLA path where it is dispatched."""
    from gen_tpu.ops.hmc_fused import stage_for_kernel

    def logp(x):
        return -0.5 * jnp.sum(jnp.sort(x) ** 2)

    staged, reason = stage_for_kernel(logp, 2)
    assert staged is None and "sort" in reason
    with pytest.raises(ValueError, match="does not stage"):
        hmc_chains_fused(KEY, logp, jnp.zeros((8, 2)), n_steps=2,
                         interpret=True)
    v, c, a = hmc_chains_fused(KEY, logp, jnp.zeros((8, 2)), n_steps=2)
    assert v.shape == (8, 2) and c.shape == (2, 8)
