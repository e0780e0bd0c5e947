"""Checkpoint + profiling utils tests."""
import os

import numpy as np

from partitionedarrays_tpu import (
    PRange,
    collect,
    psparse,
    pvector_from_own,
    spmv,
    to_global_scipy,
    uniform_partition,
)
from partitionedarrays_tpu.backends import SerialBackend
from partitionedarrays_tpu.utils import checkpoint


def test_pvector_roundtrip(tmp_path, backend4):
    pr = PRange(uniform_partition(4, 20, ghost=1))
    vals = [li.own_to_global.astype(np.float64) * 1.5 for li in pr.partition()]
    v = pvector_from_own(vals, pr, backend4, dtype=np.float64)
    path = str(tmp_path / "v.npz")
    checkpoint.save_pvector(path, v)
    v2 = checkpoint.load_pvector(path, SerialBackend(4))
    assert np.allclose(collect(v2), collect(v))
    assert v2.layout.pr.n_global == 20


def test_psparse_roundtrip(tmp_path, backend4):
    pr = PRange(uniform_partition(4, 16))
    Is = [li.own_to_global for li in pr.partition()]
    Vs = [np.full(li.n_own, 3.0) for li in pr.partition()]
    A = psparse(Is, Is, Vs, pr, pr, backend4, assembled=True)
    path = str(tmp_path / "A.npz")
    checkpoint.save_psparse(path, A)
    B = checkpoint.load_psparse(path, SerialBackend(4))
    assert np.allclose(
        to_global_scipy(B).toarray(), to_global_scipy(A).toarray()
    )


def _run_example(name: str, expect: str) -> None:
    import subprocess, sys

    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["JAX_PLATFORMS"] = "cpu"
    out = subprocess.run(
        [sys.executable, f"examples/{name}.py"],
        capture_output=True, text=True, env=env,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    )
    assert out.returncode == 0, out.stderr[-2000:]
    assert expect in out.stdout


def test_example_jacobi_runs():
    _run_example("jacobi_tutorial", "max|err|")


def test_example_fdm_runs():
    _run_example("fdm_example", "|x-x*|")


def test_example_fem_runs():
    _run_example("fem_example", "|x-x*|")


def test_example_amg_runs():
    _run_example("amg_example", "|x-x*|")


def test_example_failure_propagates(tmp_path):
    """Parity: test/mpi_array/exception_tests.jl — a failing driver must
    propagate a nonzero exit code."""
    import subprocess, sys

    bad = tmp_path / "bad_driver.py"
    bad.write_text(
        "import partitionedarrays_tpu as pat\n"
        "raise RuntimeError('boom')\n"
    )
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run(
        [sys.executable, str(bad)], capture_output=True, text=True, env=env,
        cwd=root,
    )
    assert out.returncode != 0
    assert "boom" in out.stderr


def test_example_per_process_runs():
    _run_example("per_process_example", "|x-x*|")


def test_example_reuse_runs():
    _run_example("reuse_example", "zero re-setup")
