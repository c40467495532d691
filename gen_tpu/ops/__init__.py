"""The framework's hot ops: the fused HMC kernel (GPU, Pallas through
Triton) with its XLA reference, the logp staging pass it runs on, and
systematic resampling. ``ops.backend`` holds the one decision of where the
kernel runs."""

from .resample import systematic_resample
from .hmc_fused import hmc_chains_fused
from .scalarize import stage_scalarized

__all__ = ["systematic_resample", "hmc_chains_fused", "stage_scalarized"]
