"""Dense mass matrices via Cholesky whitening.

Reference semantics: Gen.jl's HMC takes a scalar/diagonal metric only
(/root/reference/src/inference/hmc.jl:25-73); a dense metric is the
standard extension (Stan's dense_e). Instead of teaching the fused
samplers (ops/hmc_fused.py, ops/nuts_fused.py) a dense M^-1 — triangular
solves per leapfrog — we WHITEN THE COORDINATES once:

  Sigma ~ cross-chain covariance of the warmed population, Sigma = L L^T
  y = L^-1 x  =>  pi_y(y) = pi_x(L y) (+ const log|L|),

and run the existing samplers on ``pi_y`` with IDENTITY mass. HMC on y with
identity mass is exactly HMC on x with dense mass M = (L L^T)^-1 = Sigma^-1
(the optimal Gaussian-approximation metric). The wrapped logp's ``L @ y``
matmul stages through :mod:`gen_tpu.ops.scalarize` like any other residual
``dot_general`` (unrolled multiply-adds; L's d^2 entries ride in as staged
residual constants), so the kernel is untouched — no in-kernel
triangular solves.

Workflow (see benchmarks/bench_hard_targets.py ``mass="dense"`` and
``sample_posterior(..., mass="dense")``):

1. diagonal ChEES warmup -> warmed population ``flat`` (chains, d)
2. ``L = dense_mass_chol(flat)``; ``ys = whiten(L, flat)``
3. short second ChEES warmup on ``whiten_logp(logp, L)`` with
   ``adapt_mass=False`` (the whitened target is ~isotropic; only the step
   size / trajectory length need re-adapting)
4. fused sampler on the whitened target, identity mass
5. ``unwhiten(L, draws)`` back to x.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# whitening matmuls feed the log density: full f32 precision, not TF32
_HI = jax.lax.Precision.HIGHEST


def dense_mass_chol(flat, jitter_rel: float = 1e-5):
    """Cholesky factor L of the cross-chain covariance (+ relative jitter):
    ``Sigma = L L^T``. ``flat``: (chains, d) warmed population."""
    flat = jnp.asarray(flat, jnp.float32)
    n, d = flat.shape
    x = flat - jnp.mean(flat, axis=0)
    sigma = jnp.matmul(x.T, x, precision=_HI) / jnp.maximum(n - 1, 1)
    jitter = jitter_rel * (jnp.trace(sigma) / d)
    return jnp.linalg.cholesky(sigma + jitter * jnp.eye(d, dtype=sigma.dtype))


def whiten_logp(logp, L):
    """``pi_y(y) = pi_x(L y)``. The additive log|L| constant is dropped —
    it cancels in every MH/NUTS energy difference."""
    L = jnp.asarray(L)

    def logp_w(y):
        return logp(jnp.matmul(L, y, precision=_HI))

    return logp_w


def whiten(L, x):
    """x -> y = L^-1 x, batched over a leading chain axis."""
    return jax.scipy.linalg.solve_triangular(
        L, jnp.asarray(x).T, lower=True).T


def unwhiten(L, y):
    """y -> x = L y; works on (chains, d) and (steps, chains, d)."""
    y = jnp.asarray(y)
    return jnp.einsum("ij,...j->...i", L, y, precision=_HI)


# -- diagonal + low-rank metric ----------------------------------------------
# A dense L stages d^2 residual scalars into the kernel; the scalarization
# residual cap (ops/scalarize.py, 1024 scalars) limits that to d <~ 30.
# The production-standard fallback is diag + rank-k: Sigma ~ D^1/2 (s0^2 I
# + U diag(lam_k - s0^2) U^T) D^1/2, whose whitening transform costs
# d + d*k + k + 1 staged scalars.

def lowrank_mass_factors(flat, k: int, inv_mass_diag=None):
    """Estimate a diag + rank-k metric from the warmed population.

    Returns ``(sqrt_d, U, sk, s0)``: ``sqrt_d = sqrt(inv_mass_diag)^-1``
    standardizes per-coordinate scale first (pass the ChEES diagonal);
    ``U (d, k)`` top-k eigenvectors of the standardized covariance,
    ``sk (k,)`` their singular values (sqrt eigenvalues), ``s0`` the sqrt
    of the average residual eigenvalue."""
    flat = jnp.asarray(flat, jnp.float32)
    n, d = flat.shape
    if not 0 < k < d:
        raise ValueError(f"lowrank rank k={k} must be in (0, {d})")
    sqrt_d = (jnp.ones(d, jnp.float32) if inv_mass_diag is None
              else jnp.sqrt(jnp.asarray(inv_mass_diag, jnp.float32)))
    x = (flat - jnp.mean(flat, axis=0)) / jnp.maximum(sqrt_d, 1e-12)
    # right singular vectors of X/sqrt(n-1) are eigenvectors of Sigma_std
    _, s, vt = jnp.linalg.svd(x / jnp.sqrt(jnp.maximum(n - 1, 1)),
                              full_matrices=False)
    lam = s ** 2
    lam_k = lam[:k]
    lam_bar = (jnp.sum(lam) - jnp.sum(lam_k)) / jnp.maximum(d - k, 1)
    lam_bar = jnp.maximum(lam_bar, 1e-10)
    return sqrt_d, vt[:k].T, jnp.sqrt(lam_k), jnp.sqrt(lam_bar)


def lowrank_transform(sqrt_d, U, sk, s0, y):
    """x = A y with A = diag(sqrt_d) (s0 I + U diag(sk - s0) U^T):
    A A^T = diag(sqrt_d) (s0^2 I + U diag(sk^2 - s0^2) U^T) diag(sqrt_d)
    = the estimated metric. Works on (..., d)."""
    inner = jnp.einsum("dk,...d->...k", U, y, precision=_HI)
    z = s0 * y + jnp.einsum("dk,...k->...d", U, (sk - s0) * inner,
                            precision=_HI)
    return sqrt_d * z


def lowrank_inverse_transform(sqrt_d, U, sk, s0, x):
    """y = A^-1 x (A is simultaneously diagonalized by (I, U))."""
    z = x / jnp.maximum(sqrt_d, 1e-12)
    inner = jnp.einsum("dk,...d->...k", U, z, precision=_HI)
    return z / s0 + jnp.einsum("dk,...k->...d", U,
                               (1.0 / sk - 1.0 / s0) * inner,
                               precision=_HI)


def lowrank_whiten_logp(logp, sqrt_d, U, sk, s0):
    """pi_y(y) = pi_x(A y); log|A| constant dropped (cancels in MH)."""
    sqrt_d, U = jnp.asarray(sqrt_d), jnp.asarray(U)
    sk, s0 = jnp.asarray(sk), jnp.asarray(s0)

    def logp_w(y):
        return logp(lowrank_transform(sqrt_d, U, sk, s0, y))

    return logp_w


# -- partial selections ---------------------------------------------------------
# With a partial selection the flat engines freeze the unselected
# coordinates (inv_mass 0, per-chain conditioning values riding in kernel
# state). A structured metric must then whiten ONLY the free subspace and
# be exactly the identity on the frozen one — otherwise the transform
# would remix each chain's conditioning values. Two properties make this
# compatible with the kernels unchanged:
#   * dense: embed chol(cov_free) at the (sorted) free indices of an
#     identity matrix — the result is still lower-triangular, the frozen
#     rows are e_i (identity pass-through), and ``L @ y`` stages through
#     scalarize as a plain unrolled matmul (no gathers);
#   * lowrank: zero the frozen rows of U and set sqrt_d = 1 there, then
#     blend ``x = mask * A y + (1 - mask) * y`` with the constant 0/1
#     mask — elementwise, stages fine.
# Frozen coordinates keep inv_mass 0 in the whitened space (identity
# there, so freezing y_i IS freezing x_i). Estimation uses only the free
# columns: the frozen columns DO vary across chains (each chain's own
# conditioning values), and a full-matrix estimate would hallucinate
# couplings to them.

def partial_dense_chol(flat, free_idx, d, jitter_rel: float = 1e-5):
    """Identity-embedded Cholesky factor for a partial selection: the
    (sorted) ``free_idx`` block is chol of the free-subset cross-chain
    covariance; every other row/column is identity."""
    import numpy as np
    free_idx = np.asarray(free_idx)
    assert np.all(np.diff(free_idx) > 0), "free_idx must be sorted"
    L_sub = dense_mass_chol(jnp.asarray(flat)[:, free_idx], jitter_rel)
    L = jnp.eye(d, dtype=L_sub.dtype)
    return L.at[jnp.ix_(free_idx, free_idx)].set(L_sub)


def partial_lowrank_factors(flat, free_idx, d, k: int,
                            inv_mass_diag=None):
    """Diag + rank-k factors estimated on the free subset and embedded at
    the full dimension: U rows and sqrt_d entries off ``free_idx`` are
    zeroed/one'd, so :func:`partial_lowrank_transform` is the identity on
    frozen coordinates. ``inv_mass_diag``: FULL-d diagonal (frozen
    entries 0, as the ChEES warmup returns for partial selections)."""
    import numpy as np
    free_idx = np.asarray(free_idx)
    sub_inv = (None if inv_mass_diag is None
               else jnp.asarray(inv_mass_diag)[free_idx])
    sqrt_d_f, U_f, sk, s0 = lowrank_mass_factors(
        jnp.asarray(flat)[:, free_idx], k, inv_mass_diag=sub_inv)
    sqrt_d = jnp.ones((d,), jnp.float32).at[free_idx].set(sqrt_d_f)
    U = jnp.zeros((d, U_f.shape[1]), jnp.float32).at[free_idx].set(U_f)
    mask = jnp.zeros((d,), jnp.float32).at[free_idx].set(1.0)
    return sqrt_d, U, sk, s0, mask


def partial_lowrank_transform(sqrt_d, U, sk, s0, mask, y):
    x = lowrank_transform(sqrt_d, U, sk, s0, y)
    return mask * x + (1.0 - mask) * y


def partial_lowrank_inverse_transform(sqrt_d, U, sk, s0, mask, x):
    y = lowrank_inverse_transform(sqrt_d, U, sk, s0, x)
    return mask * y + (1.0 - mask) * x


def partial_lowrank_whiten_logp(logp, sqrt_d, U, sk, s0, mask):
    sqrt_d, U = jnp.asarray(sqrt_d), jnp.asarray(U)
    sk, s0, mask = jnp.asarray(sk), jnp.asarray(s0), jnp.asarray(mask)

    def logp_w(y):
        return logp(partial_lowrank_transform(sqrt_d, U, sk, s0, mask, y))

    return logp_w
