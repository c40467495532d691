"""Black-box variational inference on a two-parameter Gaussian model with
exact-posterior assertions.

Reference: /root/reference/examples/bbvi.jl:30-79 (tolerance 0.01 on the
recovered variational parameters).

Run: python examples/bbvi.py
"""

import jax
import jax.numpy as jnp
import numpy as np

import gen_tpu as gt
from gen_tpu import choicemap, gen, init_param, param
from gen_tpu.learning import (ADAM, ParamUpdate, black_box_vi, reparam_vi)


@gen
def model():
    mu = gt.normal(0.0, 1.0) @ "mu"
    gt.normal(mu, 1.0) @ "y"


OBS = choicemap(y=1.0)
# exact posterior: N(0.5, 1/sqrt(2))
EXACT_MU, EXACT_STD = 0.5, float(1.0 / np.sqrt(2.0))


def make_var_model():
    @gen
    def var_model():
        loc = param("mu_loc")
        log_std = param("mu_log_std")
        gt.normal(loc, jnp.exp(log_std)) @ "mu"

    init_param(var_model, "mu_loc", 0.0)
    init_param(var_model, "mu_log_std", 0.0)
    return var_model


def main(seed=0):
    key = jax.random.PRNGKey(seed)

    # score-function estimator (the reference's black_box_vi!)
    vm = make_var_model()
    update = ParamUpdate(ADAM(0.02), vm)
    _, _, hist = black_box_vi(key, model, (), OBS, vm, (), update,
                              iters=1500, samples_per_iter=1000)
    loc = float(vm.params["mu_loc"])
    std = float(jnp.exp(vm.params["mu_log_std"]))
    print(f"BBVI:   loc={loc:.4f} (exact {EXACT_MU}), "
          f"std={std:.4f} (exact {EXACT_STD:.4f})")
    assert abs(loc - EXACT_MU) < 0.02, loc
    assert abs(std - EXACT_STD) < 0.03, std

    # reparameterized (pathwise) estimator — accelerator-native addition
    vm2 = make_var_model()
    update2 = ParamUpdate(ADAM(0.03), vm2)
    _, _, hist2 = reparam_vi(jax.random.PRNGKey(seed + 1), model, (), OBS,
                             vm2, (), update2, iters=300, samples_per_iter=64)
    loc2 = float(vm2.params["mu_loc"])
    std2 = float(jnp.exp(vm2.params["mu_log_std"]))
    print(f"reparam: loc={loc2:.4f}, std={std2:.4f}")
    assert abs(loc2 - EXACT_MU) < 0.01, loc2
    assert abs(std2 - EXACT_STD) < 0.02, std2
    print("bbvi example OK")


if __name__ == "__main__":
    main()
