"""AMG tests (reference analogue: PartitionedSolvers/test/amg_tests.jl)."""
import numpy as np
import pytest
import scipy.sparse as sp

from partitionedarrays_tpu.backends import SerialBackend
from partitionedarrays_tpu.models.gallery import (
    laplacian_fdm,
    linear_elasticity_fem,
    node_coordinates_unit_cube,
    nullspace_linear_elasticity,
)
from partitionedarrays_tpu.parallel.p_range import PRange
from partitionedarrays_tpu.psparse import psparse, spmv, to_global_scipy
from partitionedarrays_tpu.pvector import collect, pvector_from_own
from partitionedarrays_tpu.solvers.amg import (
    AMGParams,
    AMGPreconditioner,
    aggregate,
    amg,
    default_nullspace,
)
from partitionedarrays_tpu.solvers.krylov import cg, _as_col_vector


def test_aggregate_1d_laplacian():
    n = 9
    A = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(n, n)).tocsr()
    agg = aggregate(A)
    # every node aggregated, aggregates are contiguous runs
    assert (agg >= 0).all()
    assert agg[0] == 0
    assert agg.max() + 1 <= n // 2 + 1


def build_fdm(backend, nodes, parts):
    I, J, V, rows, cols = laplacian_fdm(nodes, parts)
    return psparse(I, J, V, PRange(rows), PRange(cols), backend, assembled=True)


def manufactured(A, backend):
    n = A.shape[0]
    x_exact = np.sin(np.linspace(0.1, 3.0, n))
    xparts = [x_exact[li.own_to_global] for li in A.row_prange.partition()]
    x = pvector_from_own(xparts, A.row_prange, backend, dtype=np.float64)
    b = spmv(A, _as_col_vector(A, x))
    return x_exact, b


def test_amg_hierarchy_and_stats(backend4):
    A = build_fdm(backend4, (16, 16), (2, 2))
    M = AMGPreconditioner(A, AMGParams(coarse_size=20, max_levels=5))
    st = M.statistics()
    assert st["levels"] >= 2
    assert st["rows_per_level"][0] == 256
    assert st["rows_per_level"][-1] <= 20 or st["levels"] == 5
    assert st["operator_complexity"] < 3.0


def test_amg_preconditioned_cg(backend4):
    A = build_fdm(backend4, (16, 16), (2, 2))
    x_exact, b = manufactured(A, backend4)
    base = int(cg(A, b, rtol=1e-10, maxiter=500)[1].iterations)
    M = amg(A, AMGParams(coarse_size=20))
    x, info = cg(A, b, M=M, rtol=1e-10, maxiter=200)
    assert np.linalg.norm(collect(x) - x_exact) < 1e-5
    assert int(info.iterations) < base
    assert int(info.iterations) <= 25  # AMG should converge in few iters


def test_amg_update_fixed_sparsity(backend4):
    """Parity: amg_update! (amg.jl:925-942) — refresh the hierarchy for
    new matrix values at fixed sparsity (aggregation reused)."""
    A = build_fdm(backend4, (16, 16), (2, 2))
    x_exact, b = manufactured(A, backend4)
    M = amg(A, AMGParams(coarse_size=20))
    aggs_before = [entry[0] for entry in M._aggs]
    # scale the operator values: same sparsity, different values
    from partitionedarrays_tpu import psparse
    from partitionedarrays_tpu.parallel.p_range import PRange

    I, J, V, rows, cols = __import__(
        "partitionedarrays_tpu.models.gallery", fromlist=["laplacian_fdm"]
    ).laplacian_fdm((16, 16), (2, 2))
    A2 = psparse(
        I, J, [2.0 * v for v in V], PRange(rows), PRange(cols),
        backend4, assembled=True,
    )
    M.update(A2)
    for a0, entry in zip(aggs_before, M._aggs):
        assert a0 is entry[0]  # aggregation really was reused
    x2_exact, b2 = manufactured(A2, backend4)
    x, info = cg(A2, b2, M=M, rtol=1e-10, maxiter=200)
    assert np.linalg.norm(collect(x) - x2_exact) < 1e-5
    assert int(info.iterations) <= 25


def test_amg_structured_box_aggregation(backend4):
    """Stencil (DIA) operators take the box-aggregation path: every level
    stays a constant-offset stencil (colored-DIA smoother fast path) and
    the transfers apply P as upsample/pool + one SpMV."""
    A = build_fdm(backend4, (18, 18), (2, 2))
    x_exact, b = manufactured(A, backend4)
    M = amg(A, AMGParams(coarse_size=10))
    assert M.levels[0].struct is not None
    (fsh, csh, omega, dinv) = M.levels[0].struct
    assert fsh == (1, 9, 9) or fsh == (9, 9, 1) or fsh == (9, 9)
    x, info = cg(A, b, M=M, rtol=1e-10, maxiter=100)
    assert np.linalg.norm(collect(x) - x_exact) < 1e-5
    assert int(info.iterations) <= 25
    # structured transfers must equal the materialized P action
    from partitionedarrays_tpu.psparse import spmtv
    from partitionedarrays_tpu.solvers.amg import _row_view

    lev = M.levels[0]
    cl = M.levels[1].A.row_layout()
    rc_struct = M._restrict_struct(lev, b, cl)
    rc_mat = spmtv(lev.P, _row_view(lev.P, b))
    n0 = min(rc_struct.own.shape[1], rc_mat.own.shape[1])
    assert np.allclose(
        np.asarray(rc_struct.own)[:, :n0],
        np.asarray(rc_mat.own)[:, :n0],
        atol=1e-5,
    )


def test_amg_wcycle(backend4):
    A = build_fdm(backend4, (12, 12), (2, 2))
    x_exact, b = manufactured(A, backend4)
    M = amg(A, AMGParams(coarse_size=20, cycle="w"))
    x, info = cg(A, b, M=M, rtol=1e-10, maxiter=100)
    assert np.linalg.norm(collect(x) - x_exact) < 1e-5


def test_amg_3d(backend4):
    A = build_fdm(backend4, (6, 6, 6), (2, 2, 1))
    x_exact, b = manufactured(A, backend4)
    M = amg(A, AMGParams(coarse_size=30))
    x, info = cg(A, b, M=M, rtol=1e-12, maxiter=200)
    assert np.linalg.norm(collect(x) - x_exact) < 1e-5


@pytest.mark.slow
def test_amg_elasticity_with_nullspace():
    backend = SerialBackend(4)
    nodes = (6, 6)
    parts = (2, 2)
    I, J, V, rows, cols = linear_elasticity_fem(nodes, parts)
    A = psparse(I, J, V, PRange(rows), PRange(cols), backend)
    G = to_global_scipy(A)
    assert abs(G - G.T).max() < 1e-10
    coords, node_part = node_coordinates_unit_cube(nodes, parts)
    ns = nullspace_linear_elasticity(coords, A.row_prange)
    # nullspace modes have near-zero energy except boundary terms
    x_exact, b = manufactured(A, backend)
    M = amg(A, AMGParams(coarse_size=30, block_size=2), nullspace=ns)
    x, info = cg(A, b, M=M, rtol=1e-10, maxiter=300)
    assert np.linalg.norm(collect(x) - x_exact) < 1e-4
    # with nullspace AMG, CG beats unpreconditioned
    base = int(cg(A, b, rtol=1e-10, maxiter=500)[1].iterations)
    assert int(info.iterations) < base
    # values-only update at fixed sparsity on the BLOCK-SYSTEM hierarchy
    # (exercises the Galerkin reuse plans + smoother refresh_values on
    # whatever smoother tier the elasticity levels selected)
    A2 = psparse(I, J, [2.0 * v for v in V], PRange(rows), PRange(cols),
                 backend)
    M.update(A2)
    x2, info2 = cg(A2, b, M=M, rtol=1e-10, maxiter=300)
    assert np.linalg.norm(2.0 * collect(x2) - x_exact) < 1e-4
    assert int(info2.iterations) <= int(info.iterations) + 5


def test_default_nullspace(backend4):
    A = build_fdm(backend4, (8, 8), (2, 2))
    ns = default_nullspace(A)
    assert len(ns) == 4
    assert all(len(m) == 1 for m in ns)


def test_strength_graph_thresholded():
    """Parity: the public strength_graph(A, bs; epsilon) 0/1 graph
    (amg.jl:605-745; test values from PartitionedSolvers/test/amg_tests.jl:
    blockdiag of a dense 3x3 block -> identity node graph)."""
    from partitionedarrays_tpu.solvers.amg import strength_graph

    rng = np.random.default_rng(0)
    M = sp.csr_matrix(rng.choice([-2.0, -1.0, 1.0, 2.0], (3, 3)))
    A = sp.block_diag([M, M, M]).tocsr()
    G = strength_graph(A, 3, epsilon=0.02)
    assert abs(G - sp.eye(3)).max() == 0
    # minimal size: one node
    G1 = strength_graph(M, 3, epsilon=0.02)
    assert G1.shape == (1, 1) and G1[0, 0] == 1.0
    # off-diagonal blocks above/below threshold
    B = sp.lil_matrix((6, 6))
    B[:3, :3] = M; B[3:, 3:] = M
    B[0, 3] = 1e-6      # weak coupling node0 -> node1
    B[3:, :3] = M.toarray()  # strong coupling node1 -> node0
    G = strength_graph(sp.csr_matrix(B), 3, epsilon=0.02)
    assert G[0, 1] == 0 and G[1, 0] == 1.0
    # epsilon > 1 drops the diagonal
    G = strength_graph(A, 3, epsilon=1.5)
    assert G.diagonal().max() == 0
    with pytest.raises(ValueError):
        strength_graph(A, 3, epsilon=-1.0)
    with pytest.raises(ValueError):
        strength_graph(sp.csr_matrix((4, 4)), 3, epsilon=0.1)


def test_spectral_radius_power_method(backend4):
    """Power-method omega estimator (parity: spectral_radius,
    amg.jl:508-521) vs the known spectrum of Dinv*A for the 1-D
    Laplacian: lambda_max = (2 - 2 cos(n pi/(n+1)))/2."""
    from partitionedarrays_tpu.solvers.amg import spectral_radius

    import scipy.sparse as sps

    n = 64
    A = build_fdm(backend4, (n,), (4,))
    G = to_global_scipy(A)
    Dinv = sps.diags(1.0 / np.asarray(G.diagonal()))
    # spectrum of Dinv*A for the (scaled) 1-D Laplacian is scale-free
    exact = (2 - 2 * np.cos(np.pi * n / (n + 1))) / 2.0
    rho = spectral_radius(A, Dinv, iters=60)
    assert abs(rho - exact) / exact < 0.05


def test_large_coarse_space_uses_lu_apply(backend4):
    """Coarse spaces above 512 dofs keep backward-stable LU application
    instead of a replicated explicit inverse (VERDICT r2 item #5; the
    reference keeps a sparse LU on one rank, amg.jl:523-542)."""
    import numpy as np

    from partitionedarrays_tpu import PRange, psparse
    from partitionedarrays_tpu.models.gallery import laplacian_fdm
    from partitionedarrays_tpu.pvector import pones
    from partitionedarrays_tpu.solvers.amg import AMGParams, AMGPreconditioner
    from partitionedarrays_tpu.solvers.krylov import cg

    I, J, V, rows, cols = laplacian_fdm((26, 26, 26), (2, 2, 1), dtype=np.float32)
    A = psparse(I, J, V, PRange(rows), PRange(cols), backend4, assembled=True)
    # force a large coarse space: stop coarsening immediately below 2000
    M = AMGPreconditioner(A, AMGParams(coarse_size=2000, max_levels=2))
    assert M.coarse_kind == "lu"
    assert M.levels[-1].A.shape[0] > 512
    b = pones(A.row_prange, backend4, dtype=np.float32)
    x, info = cg(A, b, M=M, rtol=1e-6, maxiter=60)
    from partitionedarrays_tpu.pvector import pdot
    import numpy as _np

    nb = float(_np.sqrt(_np.asarray(pdot(b, b)).max()))
    from partitionedarrays_tpu.psparse import spmv
    from partitionedarrays_tpu.pvector import axpy

    r = axpy(-1.0, spmv(A, x), b)
    assert float(_np.sqrt(_np.asarray(pdot(r, r)).max())) / nb < 1e-5


def test_amg_schwarz_smoother(backend4):
    """AMGParams(smoother="schwarz"): additive Schwarz (the reference's
    default smoother family, amg.jl:770) as the level smoother — cycle,
    preconditioned CG and the fixed-sparsity update all work."""
    A = build_fdm(backend4, (16, 16), (2, 2))
    x_exact, b = manufactured(A, backend4)
    M = amg(A, AMGParams(coarse_size=20, smoother="schwarz"))
    from partitionedarrays_tpu.solvers.smoothers import AdditiveSchwarz

    assert isinstance(M.levels[0].smoother, AdditiveSchwarz)
    x, info = cg(A, b, M=M, rtol=1e-10, maxiter=200)
    assert np.linalg.norm(collect(x) - x_exact) < 1e-5
    assert int(info.iterations) <= 25
    # values-only update keeps the Schwarz factors fresh
    from partitionedarrays_tpu import psparse as _psparse_mod  # noqa
    from partitionedarrays_tpu.models.gallery import laplacian_fdm
    from partitionedarrays_tpu.parallel.p_range import PRange
    from partitionedarrays_tpu.psparse import psparse

    I, J, V, rows, cols = laplacian_fdm((16, 16), (2, 2))
    A2 = psparse(I, J, [3.0 * v for v in V], PRange(rows), PRange(cols),
                 backend4, assembled=True)
    M.update(A2)
    x2, info2 = cg(A2, b, M=M, rtol=1e-10, maxiter=200)
    assert np.linalg.norm(3.0 * collect(x2) - x_exact) < 1e-5
