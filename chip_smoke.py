#!/usr/bin/env python3
"""Smoke test of the solve path on an NVIDIA GPU.

    python chip_smoke.py              # one GPU: phases 1-5 below
    python chip_smoke.py --chips 4    # four GPUs: the multi-device path only

One card runs, through the user entry points and at full size:

1. HPCG at 128^3 (``hpcg_benchmark``, 3-phase protocol), the returned
   solution checked in f64 against a numpy 27-point stencil;
2. kernel checks at real widths: DIA SpMV, one symmetric colored GS sweep,
   the exact layout moves (GS de/interleave, HPCG restriction, AMG box
   pool/upsample) and the dots;
3. AMG-preconditioned CG on the 3-D FDM Laplacian at 96^3;
4. the unstructured path on 3-D Q1 elasticity (ELL SpMV, generic GS and
   ILU(0) Schwarz preconditioned CG);
5. df64 CG with an f32 AMG preconditioner at 64^3.

``--chips 4`` runs HPCG at 128^3 per card and AMG-PCG at 96^3 per card on
one flat 4-device mesh, each against its scipy/numpy reference, beside a
one-card HPCG run at the same local size.

Every reference is plain numpy/scipy on the host in f64.  Any failed
check exits non-zero; the last line of a passing run is one JSON object.
The script refuses to run without a GPU, and outside a checkout of this
repository.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
CARD = "unknown card"


class SmokeFailure(Exception):
    pass


def check(cond, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def say(msg: str) -> None:
    """A measurement line, with the card's name and power limit beside it."""
    print(f"{msg}  [{CARD}]", flush=True)


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        ).stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        out = ""
    return out or "nvidia-smi unavailable"


class CompileClock:
    """Seconds JAX spent tracing, lowering and compiling (from jax.monitoring)."""

    def __init__(self):
        import jax

        self.total = 0.0
        jax.monitoring.register_event_duration_secs_listener(self._on)

    def _on(self, event, duration, **kwargs):
        if event.startswith("/jax/core/compile/"):
            self.total += float(duration)


# -- numpy / scipy references ---------------------------------------------


def stencil27(v: np.ndarray) -> np.ndarray:
    """HPCG's operator on a 3-D grid in f64: 26 on the diagonal, -1 for each
    of the 26 neighbours, zero outside the box (HPCG sparse_matrix.jl)."""
    p = np.pad(np.asarray(v, np.float64), 1)
    s = p[:-2] + p[1:-1] + p[2:]
    s = s[:, :-2] + s[:, 1:-1] + s[:, 2:]
    s = s[:, :, :-2] + s[:, :, 1:-1] + s[:, :, 2:]
    return 27.0 * p[1:-1, 1:-1, 1:-1] - s


def abs_stencil27(v: np.ndarray) -> np.ndarray:
    """|A| |v| for the HPCG operator."""
    a = np.abs(np.asarray(v, np.float64))
    return stencil27(-a) + 27.0 * a + 25.0 * a


def hpcg_scipy(n: int):
    import scipy.sparse as sp

    t = sp.diags([1.0, 1.0, 1.0], [-1, 0, 1], shape=(n, n))
    k = sp.kron(sp.kron(t, t), t)
    return (27.0 * sp.identity(n ** 3) - k).tocsr()


def global_of(own, prange) -> np.ndarray:
    """Stacked own values [P, n_own_pad] -> global vector (host, f64)."""
    own = np.asarray(own, np.float64)
    parts = prange.partition()
    n = sum(li.n_own for li in parts)
    out = np.zeros(n)
    for p, li in enumerate(parts):
        out[li.own_to_global] = own[p, : li.n_own]
    return out


def own_of(glob: np.ndarray, prange, n_own_pad: int, dtype=np.float32) -> np.ndarray:
    parts = prange.partition()
    out = np.zeros((len(parts), n_own_pad), dtype)
    for p, li in enumerate(parts):
        out[p, : li.n_own] = glob[li.own_to_global]
    return out


def relres(G, x, b) -> float:
    return float(np.linalg.norm(b - G @ x) / np.linalg.norm(b))


def triplets_scipy(I, J, V, n: int):
    import scipy.sparse as sp

    return sp.csr_matrix(
        (np.concatenate(V).astype(np.float64), (np.concatenate(I), np.concatenate(J))),
        shape=(n, n),
    )


# -- phases -----------------------------------------------------------------


def phase_hpcg(backend, local_shape, parts_per_dir, n_levels=4, ref_sets=2, timed_sets=3):
    """HPCG through hpcg_benchmark; returns the MG hierarchy, the report
    and the global grid shape."""
    from partitionedarrays_tpu.models.hpcg.driver import hpcg_benchmark
    from partitionedarrays_tpu.models.hpcg.mg import HPCGMGPreconditioner

    t0 = time.perf_counter()
    mg = HPCGMGPreconditioner(
        local_shape, parts_per_dir, backend, n_levels=n_levels, dtype=np.float32
    )
    setup_s = time.perf_counter() - t0
    rep = hpcg_benchmark(
        backend, local_shape=local_shape, parts_per_dir=parts_per_dir,
        n_levels=n_levels, ref_sets=ref_sets, timed_sets=timed_sets,
        mg=mg, setup_time=setup_s,
    )
    s = rep.summary()
    gshape = tuple(int(l) * int(p) for l, p in zip(local_shape, parts_per_dir))
    tag = f"hpcg {local_shape} x parts {tuple(parts_per_dir)} ({s['nrow']} rows, {s['nnz']} nnz)"
    say(
        f"{tag}: raw {s['GFLOPs']['raw']} GFLOP/s, rated {s['GFLOPs']['rated']} GFLOP/s, "
        f"{rep.time_solve / rep.n_sets:.6f} s per CG set of {rep.iterations} iterations, "
        f"setup {setup_s:.1f} s, compile {rep.time_optimization:.1f} s, "
        f"final relres {s['final_relres']:.3e}"
    )
    check(s["validation_passed"], f"{tag}: phase-2 validation failed")
    check(s["chain_consistent"], f"{tag}: chained sets diverged from one set")
    pr = mg.A.row_prange
    b_ref = stencil27(np.ones(gshape)).reshape(-1)
    b_lib = global_of(mg.b.own, pr)
    check(np.array_equal(b_lib, b_ref), f"{tag}: rhs differs from the stencil's A @ 1")
    x = global_of(rep.solution, pr).reshape(gshape)
    rr = float(
        np.linalg.norm(b_ref - stencil27(x).reshape(-1)) / np.linalg.norm(b_ref)
    )
    say(f"{tag}: true relative residual (f64 stencil) {rr:.3e}")
    if np.prod(parts_per_dir) == 1:
        check(rr <= 1e-5, f"{tag}: true relative residual {rr:.3e} > 1e-5")
    else:
        # 50 iterations of HPCG's 4-level MG do not reach 1e-5 on the
        # larger global grid (its coarsest level is only smoothed; one
        # part on the same global grid ends near the same residual), so
        # the distributed solve is held to its own claim: the returned x
        # has the residual the CG recurrence reports
        fr = s["final_relres"]
        check(
            abs(rr - fr) <= 0.05 * fr + 2e-6,
            f"{tag}: true relative residual {rr:.3e} differs from the CG's {fr:.3e}",
        )
    return mg, rep, gshape


def phase_dia_spmv(mg, gshape, seed=0):
    """DIA SpMV on the finest HPCG operator against the f64 stencil."""
    import jax
    from partitionedarrays_tpu.psparse import spmv
    from partitionedarrays_tpu.pvector import PVector

    A = mg.A
    clay = A.col_layout()
    check(A.device().oo.kind == "dia", "HPCG operator did not freeze to DIA")
    pr = A.row_prange
    rng = np.random.default_rng(seed)
    xg = rng.standard_normal(A.shape[0]).astype(np.float32)
    xo = own_of(xg, A.col_prange, clay.n_own_pad)
    xv = PVector(
        A.backend.shard(jax.numpy.asarray(xo)),
        A.backend.shard(jax.numpy.zeros((clay.n_parts, clay.n_ghost_pad), np.float32)),
        clay, A.backend,
    )
    y = global_of(spmv(A, xv).own, pr)
    x3 = xg.astype(np.float64).reshape(gshape)
    ref = stencil27(x3).reshape(-1)
    bound = 1e-5 * abs_stencil27(x3).reshape(-1)
    worst = float(np.max(np.abs(y - ref) / bound))
    say(f"DIA SpMV {A.shape[0]} rows: max |y - y_ref| / (1e-5 |A||x|) = {worst:.3e}")
    check(worst <= 1.0, "DIA SpMV exceeds 1e-5 |A||x|")

    # symmetric colored GS sweep against the SpMV, both on this operator
    gs = mg.gss[-1]
    t_spmv = per_call(
        lambda u: spmv(A, PVector(u, xv.ghost, clay, A.backend)).own * (1.0 / 64), xv.own
    )
    bd = gs.make_bd(PVector(xv.own, xv.ghost, clay, A.backend))
    t_gs = per_call(lambda u: gs.smooth_bd(u, bd), gs.smooth_bd(None, bd))
    nbytes = A.device().oo.nbytes() + 2 * 4 * A.shape[0]
    say(
        f"DIA SpMV {t_spmv * 1e6:.1f} us ({nbytes / t_spmv / 1e9:.0f} GB/s of values + x + y); "
        f"symmetric {gs.colored.m}-color GS sweep {t_gs * 1e6:.1f} us = "
        f"{t_gs / t_spmv:.2f}x the SpMV"
    )


def per_call(f, x, k=50):
    """Seconds per call of f, from a jitted chain of k dependent calls."""
    import jax

    g = jax.jit(lambda v: jax.lax.fori_loop(0, k, lambda i, u: f(u), v))
    jax.block_until_ready(g(x))
    t0 = time.perf_counter()
    jax.block_until_ready(g(x))
    return (time.perf_counter() - t0) / k


def phase_gs_sweep(backend, n=64, seed=1):
    """One symmetric colored GS sweep against scipy triangular solves in
    the color ordering."""
    import jax
    import scipy.sparse as sp
    from scipy.sparse.linalg import spsolve_triangular

    from partitionedarrays_tpu.models.hpcg.problem import build_hpcg_problem
    from partitionedarrays_tpu.pvector import PVector
    from partitionedarrays_tpu.solvers.smoothers import GaussSeidel

    A, _ = build_hpcg_problem((n, n, n), (1, 1, 1), backend, dtype=np.float32)
    gs = GaussSeidel(A, iterations=1, sweep="symmetric")
    check(gs.colored is not None, "HPCG operator did not take the colored GS")
    m = gs.colored.m
    lay = A.row_layout()
    rng = np.random.default_rng(seed)
    x0 = rng.standard_normal(n ** 3).astype(np.float32)
    b = rng.standard_normal(n ** 3).astype(np.float32)

    def pv(v):
        o = np.zeros((1, lay.n_own_pad), np.float32)
        o[0, : v.size] = v
        return PVector(
            backend.shard(jax.numpy.asarray(o)),
            backend.shard(jax.numpy.zeros((1, lay.n_ghost_pad), np.float32)),
            lay, backend,
        )

    z = np.asarray(gs.apply(pv(x0), pv(b)).own)[0, : n ** 3].astype(np.float64)
    G = hpcg_scipy(n)
    perm = np.concatenate([np.arange(c, n ** 3, m) for c in range(m)])
    Gp = G[perm][:, perm].tocsr()
    bp = b.astype(np.float64)[perm]
    x1 = spsolve_triangular(
        sp.tril(Gp).tocsr(), bp - sp.triu(Gp, 1) @ x0.astype(np.float64)[perm], lower=True
    )
    x2 = spsolve_triangular(sp.triu(Gp).tocsr(), bp - sp.tril(Gp, -1) @ x1, lower=False)
    ref = np.empty_like(x2)
    ref[perm] = x2
    err = float(np.linalg.norm(z - ref) / np.linalg.norm(ref))
    say(f"symmetric colored GS sweep {n}^3 ({m} colors): relative error {err:.3e}")
    check(err <= 1e-5, f"GS sweep relative error {err:.3e} > 1e-5")


def phase_layouts(mg, seed=2):
    """GS de/interleave and HPCG restriction, bit-exact against numpy."""
    import jax

    gs = mg.gss[-1]
    col = gs.colored
    lay = mg.A.row_layout()
    rng = np.random.default_rng(seed)
    own = rng.standard_normal((lay.n_parts, lay.n_own_pad)).astype(np.float32)
    own_d = mg.backend.shard(jax.numpy.asarray(own))
    d = np.asarray(gs.flat_deinterleave(own_d))
    m, Lq, R = col.m, col.Lq, col.R
    xp = np.zeros((lay.n_parts, m * Lq), np.float32)
    xp[:, :R] = own[:, :R]
    ref = xp.reshape(lay.n_parts, Lq, m).transpose(0, 2, 1)
    check(np.array_equal(d, ref), "GS de-interleave is not the exact permutation")
    back = np.asarray(gs.flat_interleave_core(mg.backend.shard(jax.numpy.asarray(d))))
    check(np.array_equal(back, own[:, :R]), "GS interleave does not invert de-interleave")
    say(f"GS de/interleave {lay.n_parts}x{R} (m={m}, Lq={Lq}): bit-exact")
    l = mg.n_levels - 1
    nx, ny, nz = mg.level_shapes[l]
    rc = np.asarray(mg._restrict(l, own_d).own)
    ncoarse = (nx // 2) * (ny // 2) * (nz // 2)
    r3 = own[:, : nx * ny * nz].reshape(-1, nx, ny, nz)
    ref = r3[:, ::2, ::2, ::2].reshape(lay.n_parts, -1)
    check(np.array_equal(rc[:, :ncoarse], ref), "HPCG restriction not exact")
    check(not np.any(rc[:, ncoarse:]), "HPCG restriction padding not zero")
    say(f"HPCG restriction {mg.level_shapes[l]} -> {mg.level_shapes[l - 1]}: bit-exact")


def np_box_pool3(v, shapes):
    (fx, fy, fz), (cx, cy, cz) = shapes
    f = v[:, : fx * fy * fz].reshape(-1, fx, fy, fz)
    f = np.pad(f, ((0, 0), (0, 3 * cx - fx), (0, 3 * cy - fy), (0, 3 * cz - fz)))
    f = f.reshape(-1, cx, 3, 3 * cy, 3 * cz)
    f = (f[:, :, 0] + f[:, :, 1]) + f[:, :, 2]
    f = f.reshape(-1, cx, cy, 3, 3 * cz)
    f = (f[:, :, :, 0] + f[:, :, :, 1]) + f[:, :, :, 2]
    f = f.reshape(-1, cx, cy, cz, 3)
    f = (f[..., 0] + f[..., 1]) + f[..., 2]
    return f.reshape(f.shape[0], -1)


def np_box_up3(c, shapes):
    (fx, fy, fz), (cx, cy, cz) = shapes
    f = c[:, : cx * cy * cz].reshape(-1, cx, cy, cz)
    f = f.repeat(3, 1)[:, :fx].repeat(3, 2)[:, :, :fy].repeat(3, 3)[:, :, :, :fz]
    return f.reshape(f.shape[0], -1)


def phase_amg_layouts(M, seed=3):
    """AMG box pool/upsample bit-exact, and the coarse apply within 1e-6."""
    import jax
    from partitionedarrays_tpu.pvector import PVector
    from partitionedarrays_tpu.solvers.amg import box_pool3, box_up3

    lev = next((lv for lv in M.levels if lv.struct is not None), None)
    check(lev is not None, "AMG on the FDM Laplacian took no box-aggregated level")
    shapes = lev.struct[:2]
    P = lev.A.row_layout().n_parts
    rng = np.random.default_rng(seed)
    nf = int(np.prod(shapes[0]))
    nc = int(np.prod(shapes[1]))
    v = rng.standard_normal((P, nf)).astype(np.float32)
    c = rng.standard_normal((P, nc)).astype(np.float32)
    backend = lev.A.backend
    pool = np.asarray(
        jax.jit(lambda a: box_pool3(a, shapes))(backend.shard(jax.numpy.asarray(v)))
    )
    up = np.asarray(jax.jit(lambda a: box_up3(a, shapes))(backend.shard(jax.numpy.asarray(c))))
    check(np.array_equal(pool, np_box_pool3(v, shapes)), "AMG box pool not bit-exact")
    check(np.array_equal(up, np_box_up3(c, shapes)), "AMG box upsample not bit-exact")
    say(f"AMG box pool/upsample {shapes[0]} <-> {shapes[1]}: bit-exact")

    check(M.coarse_kind == "inv", f"coarse solve kind {M.coarse_kind}, expected the dense inverse")
    clev = M.levels[-1].A
    lay = clev.row_layout()
    # positive input: the check measures the product's accumulation error,
    # not cancellation in the input
    g = rng.uniform(0.5, 1.5, clev.shape[0])
    own = own_of(g, clev.row_prange, lay.n_own_pad)
    bv = PVector(
        backend.shard(jax.numpy.asarray(own)),
        backend.shard(jax.numpy.zeros((lay.n_parts, lay.n_ghost_pad), np.float32)),
        lay, backend,
    )
    z = global_of(M._coarse_solve(bv).own, clev.row_prange)
    Minv = np.asarray(M.coarse_inv, np.float64)
    ref = Minv @ global_of(own, clev.row_prange)
    err = float(np.linalg.norm(z - ref) / np.linalg.norm(ref))
    say(f"AMG coarse apply n={clev.shape[0]}: relative error {err:.3e}")
    check(err <= 1e-6, f"AMG coarse apply relative error {err:.3e} > 1e-6")


def phase_dots(mg, seed=4):
    """The vdot-based dots at the finest HPCG width against f64 numpy."""
    import jax
    from partitionedarrays_tpu.pvector import PVector, pdot, vdot

    lay = mg.A.row_layout()
    pr = mg.A.row_prange
    n = mg.A.shape[0]
    rng = np.random.default_rng(seed)
    # positive entries: the bound is relative to sum |x_i y_i| = x . y
    xg = rng.uniform(0.5, 1.5, n).astype(np.float32)
    yg = rng.uniform(0.5, 1.5, n).astype(np.float32)
    zg = np.zeros((lay.n_parts, lay.n_ghost_pad), np.float32)

    def pv(g):
        return PVector(
            mg.backend.shard(jax.numpy.asarray(own_of(g, pr, lay.n_own_pad))),
            mg.backend.shard(jax.numpy.asarray(zg)), lay, mg.backend,
        )

    ref = float(xg.astype(np.float64) @ yg.astype(np.float64))
    got = float(pdot(pv(xg), pv(yg)))
    err = abs(got - ref) / ref
    x1 = jax.numpy.asarray(xg)
    err1 = abs(float(jax.jit(vdot)(x1, jax.numpy.asarray(yg))) - ref) / ref
    say(f"dots over {n} entries: pdot relative error {err:.3e}, vdot {err1:.3e}")
    check(err <= 1e-6 and err1 <= 1e-6, "a dot exceeds 1e-6 relative")


def phase_amg_pcg(backend, nodes, parts_per_dir, clock, seed=5):
    """AMG-PCG on the 3-D FDM Laplacian; returns the AMG hierarchy."""
    import jax
    from partitionedarrays_tpu import PRange, psparse
    from partitionedarrays_tpu.models.gallery import laplacian_fdm
    from partitionedarrays_tpu.pvector import pvector_from_own
    from partitionedarrays_tpu.solvers.amg import AMGParams, amg
    from partitionedarrays_tpu.solvers.krylov import cg

    t0 = time.perf_counter()
    I, J, V, rows, cols = laplacian_fdm(nodes, parts_per_dir, dtype=np.float32)
    A = psparse(I, J, V, PRange(rows), PRange(cols), backend, assembled=True)
    n = A.shape[0]
    t_build = time.perf_counter() - t0
    G = triplets_scipy(I, J, V, n)
    rng = np.random.default_rng(seed)
    b = (G @ rng.standard_normal(n)).astype(np.float32)
    bv = pvector_from_own(
        [b[li.own_to_global] for li in A.row_prange.partition()], A.row_prange, backend,
        dtype=np.float32,
    )
    c0, t0 = clock.total, time.perf_counter()
    M = amg(A, AMGParams())
    A.device()
    setup = time.perf_counter() - t0
    comp = clock.total - c0
    c0, t0 = clock.total, time.perf_counter()
    x, info = cg(A, bv, M=M, rtol=1e-6, maxiter=200)
    jax.block_until_ready(x.own)
    first = time.perf_counter() - t0
    comp_solve = clock.total - c0
    t0 = time.perf_counter()
    x, info = cg(A, bv, M=M, rtol=1e-6, maxiter=200)
    jax.block_until_ready(x.own)
    solve = time.perf_counter() - t0
    rr = relres(G, global_of(x.own, A.row_prange), b.astype(np.float64))
    say(
        f"AMG-PCG FDM {tuple(nodes)} ({n} rows, {len(M.levels)} levels): "
        f"matrix build {t_build:.1f} s, setup {setup:.1f} s "
        f"(host {setup - comp:.1f} s, compile {comp:.1f} s), "
        f"first solve {first:.2f} s (compile {comp_solve:.1f} s), "
        f"solve {solve:.4f} s, {int(info.iterations)} iterations, true relres {rr:.3e}"
    )
    check(rr <= 1e-5, f"AMG-PCG true relative residual {rr:.3e} > 1e-5")
    return M


def elasticity_renumbered(nodes, seed=6, window=64):
    """3-D Q1 elasticity triplets with a seeded local shuffle of the dof
    numbering: no constant diagonals survive (so the own block freezes to
    ELL) while locality stays within ``window``."""
    from partitionedarrays_tpu.models.gallery import linear_elasticity_fem

    I, J, V, rows, cols = linear_elasticity_fem(nodes, (1, 1, 1), dtype=np.float32)
    n = sum(li.n_own for li in rows)
    rng = np.random.default_rng(seed)
    order = np.argsort(np.arange(n) + rng.uniform(0, window, n), kind="stable")
    new_of = np.empty(n, np.int64)
    new_of[order] = np.arange(n)
    return [new_of[i] for i in I], [new_of[j] for j in J], V, n


def phase_unstructured(backend, nodes, seed=7):
    import jax
    import jax.numpy as jnp
    from partitionedarrays_tpu import PRange, psparse
    from partitionedarrays_tpu.parallel.p_range import uniform_partition
    from partitionedarrays_tpu.psparse import spmv
    from partitionedarrays_tpu.pvector import PVector, pvector_from_own
    from partitionedarrays_tpu.solvers.krylov import cg
    from partitionedarrays_tpu.solvers.smoothers import AdditiveSchwarz, GaussSeidel

    I, J, V, n = elasticity_renumbered(nodes)
    rows = PRange(uniform_partition(1, n))
    A = psparse(I, J, V, rows, PRange(uniform_partition(1, n)), backend, assembled=True)
    dev = A.device()
    check(dev.oo.kind == "ell", "renumbered elasticity did not freeze to ELL")
    G = triplets_scipy(I, J, V, n)
    clay = A.col_layout()
    rng = np.random.default_rng(seed)
    xg = rng.standard_normal(n).astype(np.float32)
    xv = PVector(
        backend.shard(jnp.asarray(own_of(xg, A.col_prange, clay.n_own_pad))),
        backend.shard(jnp.zeros((1, clay.n_ghost_pad), np.float32)), clay, backend,
    )
    y = global_of(spmv(A, xv).own, A.row_prange)
    ref = G @ xg.astype(np.float64)
    bound = 1e-5 * (abs(G) @ np.abs(xg.astype(np.float64)))
    worst = float(np.max(np.abs(y - ref) / np.maximum(bound, 1e-30)))
    check(worst <= 1.0, "ELL SpMV exceeds 1e-5 |A||x|")

    f = jax.jit(lambda d, o: jax.lax.fori_loop(
        0, 100, lambda i, v: spmv(A, PVector(v, xv.ghost, clay, backend), dev=d).own * 1e-2, o
    ))
    f(dev, xv.own).block_until_ready()
    t0 = time.perf_counter()
    f(dev, xv.own).block_until_ready()
    dt = (time.perf_counter() - t0) / 100
    moved = dev.nbytes() + 2 * n * 4
    say(
        f"ELL SpMV elasticity {n} dofs (K={dev.oo.cols.shape[-1]}, nnz {G.nnz}): "
        f"max err / (1e-5 |A||x|) {worst:.3e}, {dt * 1e6:.1f} us, "
        f"{moved / dt / 1e9:.1f} GB/s of ELL arrays + x + y"
    )

    b = (G @ rng.standard_normal(n)).astype(np.float32)
    bv = pvector_from_own([b], A.row_prange, backend, dtype=np.float32)
    for name, make in (
        ("GaussSeidel (tile engine)", lambda: GaussSeidel(A, 1, "symmetric")),
        ("AdditiveSchwarz ilu0", lambda: AdditiveSchwarz(A, mode="ilu0")),
    ):
        t0 = time.perf_counter()
        Mp = make()
        setup = time.perf_counter() - t0
        if name.startswith("Gauss"):
            check(Mp.colored is None and Mp.slot_gs is not None, "GS did not take the tile engine")
        x, info = cg(A, bv, M=Mp, rtol=1e-6, maxiter=3000)
        jax.block_until_ready(x.own)
        t0 = time.perf_counter()
        x, info = cg(A, bv, M=Mp, rtol=1e-6, maxiter=3000)
        jax.block_until_ready(x.own)
        solve = time.perf_counter() - t0
        rr = relres(G, global_of(x.own, A.row_prange), b.astype(np.float64))
        it = int(info.iterations)
        say(
            f"CG + {name} on elasticity {n} dofs: setup {setup:.1f} s, "
            f"{it} iterations, solve {solve:.3f} s, true relres {rr:.3e}"
        )
        check(it < 3000, f"CG + {name} did not converge")
        check(rr <= 1e-5, f"CG + {name}: true relative residual {rr:.3e} > 1e-5")


def phase_df64(backend, n=64, seed=8):
    from partitionedarrays_tpu import PRange, psparse
    from partitionedarrays_tpu.models.gallery import laplacian_fdm
    from partitionedarrays_tpu.pvector import collect_df64, pvector_df64
    from partitionedarrays_tpu.solvers.amg import AMGParams, amg
    from partitionedarrays_tpu.solvers.krylov import cg_df64

    I, J, V, rows, cols = laplacian_fdm((n, n, n), (1, 1, 1), dtype=np.float64)
    A = psparse(I, J, V, PRange(rows), PRange(cols), backend, assembled=True, dtype=np.float64)
    G = triplets_scipy(I, J, V, A.shape[0])
    rng = np.random.default_rng(seed)
    b = G @ rng.standard_normal(A.shape[0])
    bv = pvector_df64([b[li.own_to_global] for li in A.row_prange.partition()],
                      A.row_prange, backend)
    M = amg(A.astype(np.float32), AMGParams())
    t0 = time.perf_counter()
    x_pair, info = cg_df64(A, bv, M=M, rtol=1e-11, maxiter=200)
    x = collect_df64(x_pair)
    t = time.perf_counter() - t0
    rr = relres(G, x, b)
    say(f"df64 CG + f32 AMG, FDM {n}^3: {int(info.iterations)} iterations, "
        f"{t:.2f} s incl. compile, true relres (f64) {rr:.3e}")
    check(rr <= 1e-10, f"df64 CG true relative residual {rr:.3e} > 1e-10")


def check_distinct_devices(arrays, n: int, what: str) -> None:
    for a in arrays:
        devs = [s.device for s in a.addressable_shards]
        idx = sorted(s.index[0].start or 0 for s in a.addressable_shards)
        check(
            len(set(devs)) == n and idx == list(range(n)),
            f"{what}: the {n} parts' shards are not on {n} distinct devices",
        )
    say(f"{what}: {n} parts on {n} distinct devices")


# problem sizes of the one-card run (HPCG local box, GS sweep edge, AMG
# FDM nodes, elasticity nodes (3 dofs each), df64 FDM edge)
FULL = dict(hpcg=128, gs=64, amg=96, elast=33, df64=64)


def run_one_card(devices, clock, sizes=FULL):
    from partitionedarrays_tpu.backends import MeshBackend

    backend = MeshBackend(devices=devices[:1])
    h = sizes["hpcg"]
    mg, rep, gshape = phase_hpcg(backend, (h, h, h), (1, 1, 1))
    phase_dia_spmv(mg, gshape)
    phase_layouts(mg)
    phase_dots(mg)
    del rep, mg
    phase_gs_sweep(backend, sizes["gs"])
    M = phase_amg_pcg(backend, (sizes["amg"],) * 3, (1, 1, 1), clock)
    phase_amg_layouts(M)
    del M
    phase_df64(backend, sizes["df64"])
    phase_unstructured(backend, (sizes["elast"],) * 3)


def run_four_cards(devices, clock, sizes=FULL):
    from partitionedarrays_tpu.backends import MeshBackend
    from partitionedarrays_tpu.models.hpcg.opt3d import compute_optimal_shape_xyz

    check(len(devices) >= 4, f"--chips 4 needs 4 GPUs, found {len(devices)}")
    h = (sizes["hpcg"],) * 3
    one = MeshBackend(devices=devices[:1])
    _, rep1, _ = phase_hpcg(one, h, (1, 1, 1), ref_sets=1, timed_sets=3)
    t1 = rep1.time_solve / rep1.n_sets
    del rep1
    four = MeshBackend(devices=devices[:4])
    ppd = tuple(int(p) for p in compute_optimal_shape_xyz(4))
    mg, rep4, _ = phase_hpcg(four, h, ppd, ref_sets=1, timed_sets=3)
    t4 = rep4.time_solve / rep4.n_sets
    check_distinct_devices([mg.A.device().oo.vals, rep4.solution], 4, "HPCG")
    say(
        f"HPCG {h} per card: {t1:.6f} s per CG set on 1 card, {t4:.6f} s on 4 cards "
        f"(weak-scaling efficiency {t1 / t4:.3f})"
    )
    del mg, rep4
    a = sizes["amg"]
    M = phase_amg_pcg(four, (a * ppd[0], a * ppd[1], a * ppd[2]), ppd, clock)
    check_distinct_devices([M.levels[0].A.device().oo.vals], 4, "AMG")


def main(argv=None) -> int:
    global CARD
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--chips", type=int, choices=(1, 4), default=1)
    args = ap.parse_args(argv)

    sys.path.insert(0, HERE)
    try:
        import partitionedarrays_tpu
    except ImportError:
        print("chip_smoke: run from a checkout of the repository", file=sys.stderr)
        return 2
    pkg = os.path.dirname(os.path.abspath(partitionedarrays_tpu.__file__))
    if os.path.dirname(pkg) != HERE:
        print("chip_smoke: the package does not come from this checkout", file=sys.stderr)
        return 2
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: no GPU (JAX platform {devices[0].platform!r})", file=sys.stderr)
        return 1
    CARD = " | ".join(card_line().splitlines())
    print(CARD, flush=True)
    print(
        f"device_kind={devices[0].device_kind} count={len(devices)} "
        f"jax={jax.__version__} XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}",
        flush=True,
    )
    from partitionedarrays_tpu import config

    print(f"compilation cache: {config.enable_compilation_cache()}", flush=True)
    clock = CompileClock()
    t0 = time.perf_counter()
    try:
        if args.chips == 4:
            run_four_cards(devices, clock)
        else:
            run_one_card(devices, clock)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr, flush=True)
        return 1
    say(f"chip_smoke total {time.perf_counter() - t0:.1f} s")
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": devices[0].platform,
            "kind": devices[0].device_kind,
            "count": len(devices),
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
