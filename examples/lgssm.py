"""Collapsed linear-Gaussian state-space inference: Rao-Blackwellized PMMH.

Reference family: /root/reference/examples/pmmh — MH over static parameters
of a state-space model using a particle filter's log-ML as a pseudo-
marginal likelihood. For the LINEAR-Gaussian case the marginal is exact
(Kalman filter), so the pseudo-marginal noise disappears entirely: the
collapsed distribution ``gen_tpu.models.lgssm(T)`` gives HMC over the
transition matrix on the exact collapsed posterior — every leapfrog step
differentiates through the Kalman scan (jax.grad; a (T x D x D) matmul
pipeline, matmul work).

Validation: many-chain HMC posterior mean of the transition matrix A
recovers the data-generating A, and the chains' collapsed log-ML agrees
with an independent particle-filter estimate.

Run: python examples/lgssm.py
"""

import jax
import jax.numpy as jnp
import numpy as np

import gen_tpu as gt
from gen_tpu import choicemap, gen, select
from gen_tpu.inference import hmc
from gen_tpu.models import LGSSMParams, kalman_filter, lgssm, lgssm_kernel

D, P = 2, 2
Q = 0.3 * jnp.eye(D)
C = jnp.asarray(np.array([[1.0, 0.0], [0.3, 0.8]]))
R = 0.25 * jnp.eye(P)
MU0 = jnp.zeros(D)
P0 = jnp.eye(D)
A_TRUE = jnp.asarray(np.array([[0.85, -0.1], [0.12, 0.72]]))


def make_dataset(T=150, seed=0):
    dist = lgssm(T)
    return dist.sample(jax.random.PRNGKey(seed), A_TRUE, Q, C, R, MU0, P0)


def make_model(T):
    dist = lgssm(T)

    @gen
    def model():
        a_flat = gt.normal(jnp.zeros(D * D), 1.0) @ "a"
        dist(a_flat.reshape(D, D), Q, C, R, MU0, P0) @ "ys"

    return model


def run_collapsed_hmc(key, ys, n_chains=64, n_steps=150, L=10, eps=0.02):
    T = ys.shape[0]
    model = make_model(T)
    obs = choicemap(ys=ys)
    sel = select("a")

    @jax.jit
    def run(key):
        k_init, k_chain = jax.random.split(key)
        trs, _ = jax.vmap(lambda k: model.generate(k, (), obs))(
            jax.random.split(k_init, n_chains))

        def step(trs, ks):
            new, acc = jax.vmap(lambda t, k: hmc(k, t, sel, L=L, eps=eps))(
                trs, jax.random.split(ks, n_chains))
            return new, (new.get_choices()["a"], acc)

        keys = jax.random.split(k_chain, n_steps)
        trs, (a_hist, accs) = jax.lax.scan(step, trs, keys)
        return a_hist, jnp.mean(accs)

    a_hist, acc = run(key)  # (n_steps, n_chains, D*D)
    burn = n_steps // 2
    a_post = np.asarray(a_hist[burn:]).reshape(-1, D, D)
    return a_post, float(acc)


def map_estimate(ys, n_iters=400, lr=0.02):
    """Gradient-ascent MAP of the collapsed posterior over A (oracle for
    the HMC check; exact gradients through the Kalman scan)."""
    T = ys.shape[0]

    def logpost(a_flat):
        a = a_flat.reshape(D, D)
        lml = kalman_filter(LGSSMParams(a, Q, C, R, MU0, P0), ys).log_ml
        return lml - 0.5 * jnp.sum(a_flat ** 2)

    import optax
    tx = optax.adam(lr)

    @jax.jit
    def run(a0):
        def step(carry, _):
            a, st = carry
            g = jax.grad(logpost)(a)
            upd, st = tx.update(-g, st, a)
            return (optax.apply_updates(a, upd), st), None

        (a, _), _ = jax.lax.scan(step, (a0, tx.init(a0)), None,
                                 length=n_iters)
        return a

    return np.asarray(run(jnp.zeros(D * D))).reshape(D, D)


def main(T=400, n_chains=64, n_steps=150, seed=0):
    ys = make_dataset(T)
    a_post, acc = run_collapsed_hmc(jax.random.PRNGKey(seed), ys,
                                    n_chains=n_chains, n_steps=n_steps)
    a_mean = a_post.mean(axis=0)
    a_map = map_estimate(ys)
    print("HMC accept rate:", acc)
    print("posterior mean A:\n", a_mean)
    print("MAP A:\n", a_map)
    print("true A:\n", np.asarray(A_TRUE))

    # cross-check the collapsed likelihood against an independent PF
    params = LGSSMParams(A_TRUE, Q, C, R, MU0, P0)
    exact = float(kalman_filter(params, ys).log_ml)
    from gen_tpu.inference.smc import smc_genealogy
    obs = gt.vector_choicemap(T, y=ys)
    _, _, _, pf_lml = smc_genealogy(jax.random.PRNGKey(7), lgssm_kernel,
                                    jnp.zeros(D), tuple(params), obs, 4096)
    print(f"exact log-ML {exact:.3f}  PF estimate {float(pf_lml):.3f}")

    # chains agree with the deterministic MAP oracle (posterior mode);
    # with T=400 the posterior also concentrates near the generating A
    assert np.max(np.abs(a_mean - a_map)) < 0.1, (a_mean, a_map)
    assert np.max(np.abs(a_mean - np.asarray(A_TRUE))) < 0.25, a_mean
    assert abs(float(pf_lml) - exact) < 1.5
    return a_mean


if __name__ == "__main__":
    main()
