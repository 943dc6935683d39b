import os
import subprocess
import sys

# Tests run single-device by default (the dry-run and the simulated-mesh
# parity suite run their multi-device workloads in subprocesses; the CI
# mesh leg exports XLA_FLAGS itself so the in-process mesh tests unskip).
os.environ.setdefault("JAX_PLATFORMS", "cpu")

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
sys.path.insert(0, SRC)

import numpy as np
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "gpu: needs a CUDA device and nvcc (repro_torch kernels); skips "
        "without one")


@pytest.fixture
def rng():
    return np.random.RandomState(0)


@pytest.fixture(scope="session")
def forced_mesh_run():
    """Run a python script in a subprocess with a forced host device count.

    The CPU device count is fixed at jax init, so multi-device coverage on
    a single-device host needs a fresh process with
    ``XLA_FLAGS=--xla_force_host_platform_device_count=N`` exported before
    jax imports.  Returns the CompletedProcess; asserts success.
    """

    from repro.hostdevices import force_host_device_count

    def run(script_path, n_devices=8, timeout=600, argv=()):
        env = force_host_device_count(dict(os.environ), n_devices)
        env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
        out = subprocess.run(
            [sys.executable, script_path, *argv], capture_output=True,
            text=True, env=env, timeout=timeout,
        )
        assert out.returncode == 0, (
            f"forced-mesh subprocess failed\n--- stdout ---\n"
            f"{out.stdout[-2000:]}\n--- stderr ---\n{out.stderr[-3000:]}"
        )
        return out

    return run


def make_sparse(rng, m, k, density=0.05, n_dense_rows=0, dtype=np.float32):
    """Random sparse matrix with optional dense rows (power-law-ish mix)."""
    a = (rng.rand(m, k) < density).astype(dtype) * rng.randn(m, k).astype(dtype)
    if n_dense_rows:
        rows = rng.choice(m, n_dense_rows, replace=False)
        a[rows] = rng.randn(n_dense_rows, k).astype(dtype)
    rows, cols = np.nonzero(a)
    return a, rows.astype(np.int64), cols.astype(np.int64), a[rows, cols]
