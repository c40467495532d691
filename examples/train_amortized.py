"""Amortized inference: train a proposal q(z | x) on prior samples of the
model, then use it for importance sampling.

Reference workload family: /root/reference/examples/train.jl (train! on a
conditional proposal; the simple p/q pair at train.jl:7-12, 50-56).
accelerator-native formulation: the reference trains on one (x, z) pair per
gradient step through per-example ``generate`` calls; here the whole
minibatch is one vmapped, jitted gradient of the mean conditional
log-likelihood — the `lecture_batched` estimator as a single fused program.

The model is linear-Gaussian, so the trained proposal has a closed form:
p: z ~ N(0,1), x ~ N(z+2, 0.3)  =>  z - x = -(2 + 0.3 eps) ~ N(-2, 0.3^2),
so q*(z|x) = N(z; x + theta, sigma) is exact at theta = -2, sigma = 0.3 —
and importance sampling with q* has ZERO weight variance.
"""

import jax
import jax.numpy as jnp
import numpy as np

import gen_tpu as gt
from gen_tpu import choicemap, gen, init_param, param
from gen_tpu.inference import importance_sampling
from gen_tpu.learning import ADAM, ParamUpdate


@gen
def p():
    z = gt.normal(0.0, 1.0) @ "z"
    gt.normal(z + 2.0, 0.3) @ "x"
    return z


@gen
def q(x):
    theta = param("theta")
    log_std = param("log_std")
    z = gt.normal(x + theta, jnp.exp(log_std)) @ "z"
    return z


def train_proposal(key, n_steps=400, batch=4096, lr=0.05):
    init_param(q, "theta", 0.0)
    init_param(q, "log_std", 0.0)
    update = ParamUpdate(ADAM(lr), q)

    from gen_tpu.dynamic.params import override_params
    from gen_tpu.utils import combine, partition_inexact
    from gen_tpu.learning.variational import (_bundle, _overrides,
                                              collect_params_targets)

    fns = collect_params_targets(q)
    bdyn, bstatic = partition_inexact(_bundle(fns))

    @jax.jit
    def grad_step(key, bdyn):
        ks = jax.random.split(key, batch)
        p_traces = jax.vmap(lambda k: p.simulate(k, ()))(ks)
        xs, zs = p_traces["x"], p_traces["z"]

        # objective = mean conditional log-likelihood; ParamUpdate ASCENDS
        # accumulated gradients (Gen's convention)
        def objective(bdyn_):
            b = combine(bdyn_, bstatic)
            with override_params(_overrides(fns, b)):
                def one(x, z):
                    w, _ = q.assess((x,), choicemap(z=z))
                    return w
                return jnp.mean(jax.vmap(one)(xs, zs))

        return jax.value_and_grad(objective)(bdyn)

    for step in range(n_steps):
        key, sub = jax.random.split(key)
        loss, g = grad_step(sub, bdyn)
        from gen_tpu.learning.variational import _distribute_grads
        _distribute_grads(fns, g)
        update.apply()
        bdyn, bstatic = partition_inexact(_bundle(fns))
    return float(q.params["theta"]), float(jnp.exp(q.params["log_std"]))


def main(seed=0):
    key = jax.random.PRNGKey(seed)
    k_train, k_is1, k_is2 = jax.random.split(key, 3)

    theta, sigma = train_proposal(k_train)
    print(f"trained proposal: theta={theta:.3f} (exact -2.0), "
          f"sigma={sigma:.3f} (exact 0.3)")
    assert abs(theta - (-2.0)) < 0.05 and abs(sigma - 0.3) < 0.05

    # use the trained proposal for importance sampling
    x_obs = 1.7
    obs = choicemap(x=x_obs)
    _, lnw_prior, lml_prior = importance_sampling(k_is1, p, (), obs, 2000)
    _, lnw_q, lml_q = importance_sampling(k_is2, p, (), obs, 2000,
                                          proposal=q,
                                          proposal_args=(x_obs,))
    # exact log marginal: x ~ N(2, sqrt(1 + 0.09))
    from scipy import stats
    exact = stats.norm.logpdf(x_obs, 2.0, np.sqrt(1.09))
    var_prior = float(jnp.var(lnw_prior))
    var_q = float(jnp.var(lnw_q))
    print(f"log-ML: exact {exact:.4f}, prior-IS {float(lml_prior):.4f}, "
          f"trained-q IS {float(lml_q):.4f}")
    print(f"normalized log-weight variance: prior {var_prior:.4f} -> "
          f"trained q {var_q:.6f}")
    assert abs(float(lml_q) - exact) < 0.01
    assert var_q < var_prior / 50, (var_q, var_prior)
    print("train_amortized example OK")


if __name__ == "__main__":
    main()
