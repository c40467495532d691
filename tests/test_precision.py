"""Every f32 dot that feeds a log density, a metric or an accept ratio
asks for full f32 precision (``Precision.HIGHEST``): a GPU otherwise runs
f32 matmuls in TF32 (10-bit mantissa). Checked in the jaxpr, so the CPU
suite sees what the card would compile."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

HI = jax.lax.Precision.HIGHEST


def _dots(jaxpr):
    """All dot_general equations of a (closed) jaxpr, sub-jaxprs included."""
    out = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            out.append(eqn)
        for p in eqn.params.values():
            subs = p if isinstance(p, (list, tuple)) else [p]
            for sub in subs:
                inner = getattr(sub, "jaxpr", None)
                if inner is not None and hasattr(inner, "eqns"):
                    out += _dots(inner)
                elif hasattr(sub, "eqns"):
                    out += _dots(sub)
    return out


def _sites():
    from gen_tpu.dists import mvnormal, normal_linear
    from gen_tpu.inference import mass
    from gen_tpu.models.gp import gp_log_ml, rbf
    from gen_tpu.models.hmm import HMMParams, hmm_forward_batched
    from gen_tpu.models.lgssm import (LGSSMParams, kalman_filter,
                                      lgssm_batch_weights)
    from gen_tpu.ops.mvn import (mvn_logpdf_rows, mvn_precompute,
                                 mvn_sample_rows)
    f32 = jnp.float32
    X = jnp.ones((5, 2), f32)
    eye2 = jnp.eye(2, dtype=f32)
    lg = LGSSMParams(0.9 * eye2, 0.1 * eye2, eye2, 0.2 * eye2,
                     jnp.zeros(2, f32), eye2)
    prec = mvn_precompute(eye2)
    L = jnp.linalg.cholesky(2.0 * eye2)
    U = jnp.eye(3, 1, dtype=f32)
    return {
        "normal_linear (Gram)": lambda: normal_linear.logpdf(
            jnp.ones(5, f32), X, jnp.ones(2, f32), f32(0.5)),
        "mvnormal": lambda: mvnormal.logpdf(
            jnp.ones(2, f32), jnp.zeros(2, f32), eye2),
        "mvn_logpdf_rows": lambda: mvn_logpdf_rows(
            jnp.ones((4, 2), f32), jnp.zeros(2, f32), prec),
        "mvn_sample_rows": lambda: mvn_sample_rows(
            jax.random.PRNGKey(0), jnp.zeros(2, f32), eye2, 4),
        "gp_log_ml": lambda: gp_log_ml(
            rbf, jnp.linspace(0, 1, 4, dtype=f32), jnp.ones(4, f32),
            (f32(1.0), f32(0.5)), f32(0.1)),
        "kalman_filter": lambda: kalman_filter(
            lg, jnp.ones((3, 2), f32)).log_ml,
        "lgssm_batch_weights": lambda: lgssm_batch_weights(
            jnp.ones((4, 2), f32), jnp.ones(2, f32), eye2, prec),
        "hmm_forward_batched": lambda: hmm_forward_batched(
            HMMParams(jnp.full(2, 0.5, f32), jnp.full((2, 2), 0.5, f32),
                      jnp.full((2, 3), 1 / 3, f32)),
            jnp.zeros((4, 3), jnp.int32))[0],
        "mass.dense_mass_chol": lambda: mass.dense_mass_chol(
            jnp.ones((8, 2), f32)),
        "mass.whiten_logp": lambda: mass.whiten_logp(
            lambda x: -0.5 * jnp.sum(x * x), L)(jnp.ones(2, f32)),
        "mass.lowrank_transform": lambda: mass.lowrank_transform(
            jnp.ones(3, f32), U, jnp.ones(1, f32), f32(1.0),
            jnp.ones((4, 3), f32)),
    }


@pytest.mark.parametrize("site", sorted(_sites()))
def test_dot_carries_highest(site):
    fn = _sites()[site]
    with jax.enable_x64(False):
        closed = jax.make_jaxpr(fn)()
    dots = _dots(closed.jaxpr)
    assert dots, f"{site}: no dot_general traced"
    for eqn in dots:
        p = eqn.params["precision"]
        assert p is not None, f"{site}: a dot runs at default precision"
        ps = p if isinstance(p, tuple) else (p, p)
        assert all(x == HI for x in ps), f"{site}: precision {p}"


def test_bf16_opt_in_keeps_default_precision():
    """The explicit low-precision path of ops/mvn keeps its stated error
    (no HIGHEST forced onto bf16 operands)."""
    from gen_tpu.ops.mvn import mvn_logpdf_rows, mvn_precompute
    prec = mvn_precompute(jnp.eye(2, dtype=jnp.float32))
    closed = jax.make_jaxpr(lambda x: mvn_logpdf_rows(
        x, jnp.zeros(2, jnp.float32), prec, dtype=jnp.bfloat16))(
        jnp.ones((4, 2), jnp.float32))
    (eqn,) = _dots(closed.jaxpr)
    assert eqn.params["precision"] is None
    np.testing.assert_equal(eqn.invars[0].aval.dtype, jnp.bfloat16)
