"""The on-card bring-up check (chip_smoke.py) refuses to run without a GPU,
and the package's compile-cache placement follows JAX_COMPILATION_CACHE_DIR."""

import json
import os
import subprocess
import sys

import jax
import pytest

import delphy_tpu

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402


def _cpu_env(**extra):
    env = dict(os.environ, JAX_PLATFORMS="cpu", **extra)
    env.pop("XLA_FLAGS", None)
    return env


def test_chip_smoke_device_check_refuses_cpu():
    assert jax.default_backend() == "cpu"
    with pytest.raises(chip_smoke.SmokeError, match="no GPU"):
        chip_smoke.check_device()


def test_chip_smoke_exits_nonzero_without_gpu():
    r = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")],
                       cwd=ROOT, env=_cpu_env(), capture_output=True,
                       text=True, timeout=300)
    assert r.returncode != 0
    assert "no GPU" in r.stderr
    for line in r.stdout.splitlines():   # no result line
        with pytest.raises(ValueError):
            json.loads(line)


@pytest.mark.gpu
def test_gpu_boundary_matches_cpu(gpu):
    """One partitioned boundary on the card equals the CPU's: same counts,
    times to 1e-6 days, log_G to 1e-9 relative (chip_smoke phase 4 at a
    small shape)."""
    import numpy as np
    from delphy_tpu.sim import simulate_dataset
    from delphy_tpu.init_tree import build_initial_tree
    from delphy_tpu.run import Run
    ref, deltas, miss, dates, names, _ = simulate_dataset(
        20, 300, mu=1e-3, sample_window_days=300.0, missing_fraction=0.02,
        seed=23)
    tree = build_initial_tree(ref, deltas, miss, dates, names=names,
                              rng=np.random.default_rng(23))
    chip_smoke.phase_gpu_vs_cpu(Run(tree, seed=23, num_cells=200,
                                    device_partitions=4,
                                    topology_moves_enabled=False))


def test_compile_cache_default_is_fixed_checkout_path():
    assert delphy_tpu.compile_cache_dir({}) == os.path.join(ROOT, ".jax_cache")
    expected = (os.environ.get("JAX_COMPILATION_CACHE_DIR")
                or os.path.join(ROOT, ".jax_cache"))
    assert jax.config.jax_compilation_cache_dir == expected


def test_compile_cache_env_var_wins(tmp_path):
    assert delphy_tpu.compile_cache_dir(
        {"JAX_COMPILATION_CACHE_DIR": str(tmp_path)}) is None
    r = subprocess.run(
        [sys.executable, "-c",
         "import delphy_tpu, jax; print(jax.config.jax_compilation_cache_dir)"],
        cwd=ROOT, env=_cpu_env(JAX_COMPILATION_CACHE_DIR=str(tmp_path)),
        capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == str(tmp_path)


def test_cli_path_does_not_import_dphy():
    """The .dphy writer (and its flatbuffers runtime) is imported lazily,
    only by .dphy output and the server: the CLI and driver modules must
    not import it at top level."""
    code = ("import sys, delphy_tpu.cli, delphy_tpu.run, "
            "delphy_tpu.io.beast_out; print('delphy_tpu.io.dphy' in sys.modules)")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=_cpu_env(),
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "False"
