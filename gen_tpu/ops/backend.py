"""The one backend decision of the package: where the hand-written kernels
run.

On the GPU the fused kernels (``ops/hmc_fused.py``) are compiled through
Pallas' Triton route. On the CPU the XLA reference formulation runs (the
kernels still run there in interpret mode when a test asks for it). Any
other platform has no measured rule and raises, rather than silently
picking one.

The fused HMC kernel keeps each chain's whole state (position, momentum,
gradient, logp) in registers for every leapfrog, about ``3d + 2`` words
per chain plus the staged logp's temporaries, and unrolls the staged logp
and its gradient per coordinate, so its compile time grows steeply with
d. Past ``HMC_KERNEL_MAX_D`` coordinates the XLA sampler wins one call
end to end; the crossover and the times it rests on are in ``PERF.md``.
"""

from __future__ import annotations

import jax

# Largest dimension the fused HMC kernel serves: the d-crossover of one
# cold call at the headline scale (524,288 chains x 500 steps, compile
# included) on one H100 (benchmarks/hmc_kernel_crossover.py): kernel 3.79 s
# vs XLA 4.15 s at d=8, 6.06 s vs 2.97 s at d=10, 20.07 s vs 3.94 s at
# d=16. Compiled once, the kernel is 5-8x faster at every d measured up to
# 16, but the step size and leapfrog count are compiled into it, and
# sample_posterior adapts them anew on every call, so a call pays the
# kernel's compile: the cold ranking decides.
HMC_KERNEL_MAX_D = 8


def kernel_platform(platform=None) -> bool:
    """True where the fused kernels run (``"gpu"``), False where the XLA
    reference runs (``"cpu"``). ``platform`` defaults to
    ``jax.default_backend()``; any other platform raises."""
    platform = platform or jax.default_backend()
    if platform == "gpu":
        return True
    if platform == "cpu":
        return False
    raise NotImplementedError(
        f"no kernel rule for platform {platform!r}: the fused kernels run "
        "on 'gpu' and the XLA reference on 'cpu'")


def hmc_kernel_route(d: int, platform=None) -> bool:
    """Whether :func:`gen_tpu.ops.hmc_fused.hmc_chains_fused` runs the
    kernel for a ``d``-dimensional target on ``platform``: the kernel
    platform and ``d <= HMC_KERNEL_MAX_D``."""
    return kernel_platform(platform) and d <= HMC_KERNEL_MAX_D
