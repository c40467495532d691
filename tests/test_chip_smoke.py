"""chip_smoke.py: refuses to run without a GPU (non-zero exit, no result
line), and its phase functions work at tiny sizes on the CPU (the kernel
in interpret mode; statistical gates recorded, not enforced, since tiny
runs cannot meet them)."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


@pytest.mark.parametrize("alone", [False, True])
def test_exits_nonzero_without_gpu(tmp_path, alone):
    """On the CPU, and in a directory holding chip_smoke.py and nothing
    else of the repo, the script fails and prints no ok line."""
    script = os.path.join(ROOT, "chip_smoke.py")
    if alone:
        shutil.copy(script, tmp_path / "chip_smoke.py")
        script = str(tmp_path / "chip_smoke.py")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    p = subprocess.run([sys.executable, script], cwd=str(tmp_path),
                       env=env, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert '"ok"' not in p.stdout


def test_phase_kernel_tiny():
    import jax
    import chip_smoke as C
    g = C.Gates(strict=False)
    with jax.enable_x64(False):
        out = C.phase_kernel(g, n_exact=128, exact_steps=3, n_time=256,
                             time_steps=2, reps=1, interpret=True)
    # exactness gates hold at any size
    assert all(ok for _, _, _, ok in g.rows), g.rows
    assert out["flips"] == 0 and out["dx"] <= C.KERNEL_DX_LIMIT
    # the control (a 1e-4 relative error in the log density) reads larger
    assert out["dx_control"] > out["dx"]


def test_phase_hmc_tiny():
    import jax
    import chip_smoke as C
    g = C.Gates(strict=False)
    with jax.enable_x64(False):
        out = C.phase_hmc(g, n_chains=256, warmup=20, steps=10,
                          rhat_chains=64, rhat_steps=10, interpret=True)
    assert [r[0] for r in g.rows][-1].startswith("split-rhat")
    assert all(np.isfinite(r[1]) for r in g.rows)
    assert out["ess"] > 0


def test_phase_nuts_tiny():
    import jax
    import chip_smoke as C
    g = C.Gates(strict=False)
    with jax.enable_x64(False):
        res = C.phase_nuts(g, sizes=((8, 16, 0), (8, 16, 40)), warmup=40,
                           ticks=60, reps=1, rhat_chains=8)
    assert g.rows[0][0] == "engine is nuts_fused" and g.rows[0][3]
    names = [r[0] for r in g.rows]
    assert "split-rhat(draws)" in names
    assert "split-rhat(draws + 40 more ticks)" in names
    assert all(np.isfinite(r[1]) for r in g.rows)
    assert res[0]["us_per_tick"] > 0
    assert res[0]["samples"]["theta_std"].shape[1:] == (16, 8)


def test_phase_hmc_fused_tiny(capsys):
    import jax
    import chip_smoke as C
    g = C.Gates(strict=False)
    with jax.enable_x64(False):
        C.phase_hmc_fused(g, sizes=((6, 16),), warmup=20, samples=10)
    assert [r[0] for r in g.rows][-1] == "split-rhat(draws)"
    assert all(np.isfinite(r[1]) for r in g.rows)
    # the CPU runs the XLA sampler: the route is printed
    assert "-> XLA sampler" in capsys.readouterr().out


def test_phase_four_cards_tiny(capsys):
    """The multi-device phase on 4 virtual CPU devices: the NUTS engine
    on identical inputs gives the same draws sharded or not, and every
    gate is reported."""
    import jax
    import chip_smoke as C
    g = C.Gates(strict=False)
    with jax.enable_x64(False):
        out = C.phase_four_cards(g, n_hmc=64, hmc_steps=4, warmup=4,
                                 nuts_size=(8, 16), nuts_warmup=20,
                                 ticks=80, n_smc=256, T=6, reps=1,
                                 interpret=True)
    assert out["nuts_early"] == 1.0
    assert "chains equal at every tick pair 1.0000" in capsys.readouterr().out
    assert len(out["smc"]["ring"]) == len(out["smc_one"]) == 4
    assert all(np.isfinite(r[1]) for r in g.rows)


def test_phase_smc_tiny():
    import jax
    import chip_smoke as C
    g = C.Gates(strict=False)
    with jax.enable_x64(False):
        out = C.phase_smc(g, n=512, T=8, seeds=2, resample_ns=(64,),
                          reps=1)
    assert len(out["lmls"]) == 2 and np.isfinite(out["exact"])
    assert abs(np.mean(out["lmls"]) - out["exact"]) < 2.0
