"""chip_smoke.py: refuses to run without a GPU or outside a checkout, and
its phases (run here at tiny sizes on the CPU) agree with their numpy and
scipy references."""
import os
import shutil
import subprocess
import sys

import jax
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(REPO, "chip_smoke.py")


def _run(script, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    return subprocess.run(
        [sys.executable, script], capture_output=True, text=True, env=env,
        cwd=cwd, timeout=300,
    )


def test_chip_smoke_refuses_cpu():
    out = _run(SCRIPT, REPO)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "no GPU" in out.stderr


def test_chip_smoke_refuses_outside_checkout(tmp_path):
    shutil.copy(SCRIPT, tmp_path / "chip_smoke.py")
    out = _run(str(tmp_path / "chip_smoke.py"), str(tmp_path))
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


@pytest.fixture(scope="module")
def cs():
    sys.path.insert(0, REPO)
    import chip_smoke

    chip_smoke.CARD = "cpu test"
    return chip_smoke


@pytest.fixture
def one():
    from partitionedarrays_tpu.backends import MeshBackend

    return MeshBackend(devices=jax.devices()[:1])


def test_chip_smoke_hpcg_and_kernel_phases(cs, one):
    mg, rep, gshape = cs.phase_hpcg(one, (32, 32, 32), (1, 1, 1), ref_sets=1, timed_sets=1)
    assert rep.solution is not None and gshape == (32, 32, 32)
    cs.phase_dia_spmv(mg, gshape)
    cs.phase_layouts(mg)
    cs.phase_dots(mg)


def test_chip_smoke_gs_sweep_phase(cs, one):
    cs.phase_gs_sweep(one, 10)


def test_chip_smoke_amg_phases(cs, one):
    M = cs.phase_amg_pcg(one, (12, 12, 12), (1, 1, 1), cs.CompileClock())
    cs.phase_amg_layouts(M)


def test_chip_smoke_unstructured_phase(cs, one):
    cs.phase_unstructured(one, (6, 6, 6))


def test_chip_smoke_df64_phase(cs, one):
    cs.phase_df64(one, 8)


def test_chip_smoke_four_part_checks(cs):
    from partitionedarrays_tpu.backends import MeshBackend

    four = MeshBackend(devices=jax.devices()[:4])
    M = cs.phase_amg_pcg(four, (12, 12, 12), (1, 2, 2), cs.CompileClock())
    cs.check_distinct_devices([M.levels[0].A.device().oo.vals], 4, "AMG")
    with pytest.raises(cs.SmokeFailure):
        cs.check_distinct_devices([jax.numpy.zeros((4, 3))], 4, "unsharded")


def test_stencil_reference_matches_scipy(cs):
    import numpy as np

    n = 7
    x = np.random.default_rng(0).standard_normal((n, n, n))
    np.testing.assert_allclose(
        cs.stencil27(x).reshape(-1), cs.hpcg_scipy(n) @ x.reshape(-1), atol=1e-12
    )
    G = cs.hpcg_scipy(n)
    np.testing.assert_allclose(
        cs.abs_stencil27(x).reshape(-1), abs(G) @ np.abs(x).reshape(-1), atol=1e-12
    )
