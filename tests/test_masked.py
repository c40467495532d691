"""Masked (dynamically-present) constraints — per-element observation
patterns under vmap, the accelerator-side extension the reference cannot express
(its constraint structure is always host-concrete)."""

import jax
import jax.numpy as jnp
import numpy as np
from scipy import stats

import gen_tpu as gt
from gen_tpu import ChoiceMap, Unfold, gen, vector_choicemap
from gen_tpu.combinators import UnfoldArena, smc_run
from gen_tpu.masked import MaskedValue, mask
from gen_tpu import masked_select

KEY = jax.random.PRNGKey(0)


@gen
def m():
    x = gt.normal(0.0, 1.0) @ "x"
    gt.normal(x, 0.5) @ "y"


def test_masked_generate_present_and_absent():
    c = ChoiceMap().set_value("y", mask(1.0, True))
    tr, w = m.generate(KEY, (), c)
    x = float(tr["x"])
    np.testing.assert_allclose(float(w), stats.norm.logpdf(1.0, x, 0.5),
                               rtol=1e-10)
    np.testing.assert_allclose(float(tr["y"]), 1.0)

    c2 = ChoiceMap().set_value("y", mask(1.0, False))
    tr2, w2 = m.generate(KEY, (), c2)
    np.testing.assert_allclose(float(w2), 0.0, atol=1e-12)
    assert not np.allclose(float(tr2["y"]), 1.0)


def test_masked_vmapped_flags():
    flags = jnp.array([True, False, True, False])

    def gen_one(k, flag):
        c = ChoiceMap().set_value("y", mask(1.0, flag))
        tr, w = m.generate(k, (), c)
        return w, tr["y"]

    ws, ys = jax.jit(jax.vmap(gen_one))(jax.random.split(KEY, 4), flags)
    ws, ys = np.asarray(ws), np.asarray(ys)
    np.testing.assert_allclose(ys[[0, 2]], 1.0)
    np.testing.assert_allclose(ws[[1, 3]], 0.0, atol=1e-12)
    assert (ws[[0, 2]] != 0).all()


def test_masked_update():
    c = ChoiceMap().set_value("y", mask(1.0, True))
    tr, _ = m.generate(KEY, (), c)
    x = float(tr["x"])
    tr3, w3, _, disc = tr.update(None, ChoiceMap().set_value(
        "y", mask(2.0, True)))
    np.testing.assert_allclose(
        float(w3), stats.norm.logpdf(2.0, x, 0.5)
        - stats.norm.logpdf(1.0, x, 0.5), rtol=1e-10)
    assert isinstance(disc.get_value("y"), MaskedValue)
    tr4, w4, _, _ = tr.update(None, ChoiceMap().set_value(
        "y", mask(2.0, False)))
    np.testing.assert_allclose(float(w4), 0.0, atol=1e-12)
    np.testing.assert_allclose(float(tr4["y"]), 1.0)


def test_smc_with_missing_observations():
    """SSM where some timesteps have no observation: masked constraints in
    one arena SMC program; log-ML equals the Kalman value computed with
    skipped measurement updates."""
    import math

    @gen
    def kern(t, prev):
        x = gt.normal(0.8 * prev, 0.5) @ "x"
        gt.normal(x, 0.3) @ "y"
        return x

    arena = UnfoldArena(kern, max_length=8)
    T = 6
    rng = np.random.default_rng(0)
    ys = rng.standard_normal(T) * 0.5
    present = np.array([True, False, True, True, False, True])

    inner = ChoiceMap().set_value(
        "y", MaskedValue(jnp.asarray(ys), jnp.asarray(present)))
    obs = gt.VectorChoiceMap(inner, T)
    lmls = []
    run = jax.jit(lambda k: smc_run(k, arena, 0.0, (), obs, 4000)[2])
    for s in range(6):
        lmls.append(float(run(jax.random.PRNGKey(s))))

    # Kalman with missing observations
    A, Q, R = 0.8, 0.25, 0.09
    mmean, v, lml = 0.0, 0.0, 0.0
    for t in range(T):
        pm, pv = (A * mmean, A * A * v + Q) if t else (0.0, Q)
        if present[t]:
            S = pv + R
            lml += (-0.5 * math.log(2 * math.pi * S)
                    - 0.5 * (ys[t] - pm) ** 2 / S)
            K = pv / S
            mmean, v = pm + K * (ys[t] - pm), (1 - K) * pv
        else:
            mmean, v = pm, pv
    np.testing.assert_allclose(np.mean(lmls), lml, atol=0.05)


def test_masked_selection_random_scan():
    """Random-scan MH: one branchless regenerate pass per step with a
    traced coordinate choice; matches the exact Gaussian posterior."""
    from gen_tpu.inference import mh_accept, select_trace

    @gen
    def m2():
        a = gt.normal(0.0, 1.0) @ "a"
        b = gt.normal(0.0, 1.0) @ "b"
        gt.normal(a + b, 0.5) @ "y"

    obs = gt.choicemap(y=1.0)
    tr, _ = m2.generate(KEY, (), obs)

    def step(trace, k):
        k_pick, k_reg, k_acc = jax.random.split(k, 3)
        which = jax.random.bernoulli(k_pick)
        sel = masked_select(a=which, b=~which)
        new_tr, w, _ = trace.regenerate(k_reg, sel)
        acc = mh_accept(k_acc, w)
        out = select_trace(acc, new_tr, trace)
        return out, out["a"]

    final, as_ = jax.lax.scan(step, tr,
                              jax.random.split(jax.random.PRNGKey(1), 6000))
    as_ = np.asarray(as_)[1500:]
    P = np.array([[5.0, 4.0], [4.0, 5.0]])
    mean = np.linalg.solve(P, np.array([4.0, 4.0]))
    np.testing.assert_allclose(as_.mean(), mean[0], atol=0.05)
