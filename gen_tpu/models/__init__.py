"""Model families with accelerator-native fast paths.

The reference ships model families as examples (examples/regression,
examples/pmmh's state-space model, ...). This package hosts the ones whose
accelerator-native formulation is a reusable library component in its own right:
linear-Gaussian state-space models with exact Kalman inference and an
matmul-path batched-weight formulation.
"""

from .lgssm import (LGSSMParams, KalmanResult, kalman_filter, kalman_smoother,
                    lgssm_kernel, LinearGaussianSSM, lgssm,
                    lgssm_batch_weights)
from .hmm import (HMMParams, hmm_forward, hmm_forward_batched, hmm_smoother,
                  hmm_ffbs, hmm_kernel, HiddenMarkovModel, hmm)
from .gp import (pairwise_sq_dists, rbf, matern12, matern32, matern52,
                 linear_kernel, periodic, KERNELS, gp_log_ml, gp_posterior,
                 gp_predict, gp_sample, GPMarginal, gp_marginal,
                 gp_latent_rbf)
from .gp_iterative import (mbcg, pmbcg, pivoted_cholesky,
                           woodbury_preconditioner, lanczos_tridiag_from_cg,
                           slq_logdet_from_tridiag, gp_log_ml_cg,
                           gp_posterior_cg, GPMarginalCG, gp_marginal_cg)

__all__ = ["LGSSMParams", "KalmanResult", "kalman_filter", "kalman_smoother",
           "lgssm_kernel", "LinearGaussianSSM", "lgssm",
           "lgssm_batch_weights",
           "HMMParams", "hmm_forward", "hmm_forward_batched", "hmm_smoother",
           "hmm_ffbs",
           "hmm_kernel", "HiddenMarkovModel", "hmm",
           "pairwise_sq_dists", "rbf", "matern12", "matern32", "matern52",
           "linear_kernel", "periodic", "KERNELS", "gp_log_ml",
           "gp_posterior", "gp_predict", "gp_sample", "GPMarginal",
           "gp_marginal", "gp_latent_rbf",
           "mbcg", "pmbcg", "pivoted_cholesky", "woodbury_preconditioner",
           "lanczos_tridiag_from_cg", "slq_logdet_from_tridiag",
           "gp_log_ml_cg", "gp_posterior_cg", "GPMarginalCG",
           "gp_marginal_cg"]
