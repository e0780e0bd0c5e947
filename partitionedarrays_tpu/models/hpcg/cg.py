"""HPCG reference/optimized CG: fixed-iteration PCG with residual history.

Capability parity: HPCG/src/ref_cg.jl (preconditioned CG iterator,
:40-71) and opt_cg.jl (:25-32 — the optimized variant; here both run the
same compiled path, the "optimization" being the whole device stack).
The per-kernel timing buckets of the reference are replaced by the
analytical FLOP/byte model in report.py plus one wall-clock measurement of
the full compiled set (per-op timers are meaningless under XLA fusion).
"""
from __future__ import annotations

from typing import Callable, Optional

import jax
import jax.numpy as jnp

from ...psparse import PSparseMatrix, spmv
from ...pvector import PVector, axpy, pdot, vdot
from ...solvers.krylov import _as_col_vector, _as_row_vector


def hpcg_cg(
    A: PSparseMatrix,
    b: PVector,
    M: Optional[Callable[[PVector], PVector]] = None,
    iterations: int = 50,
):
    """Run exactly ``iterations`` PCG iterations from x0 = 0.

    Returns (x, resnorms[iterations+1]) with resnorms[k] = |r_k|_2.
    Traceable; jit at the call site with (A, M, b) as arguments.
    """
    Mfn = M if M is not None else (lambda r: r)
    x = PVector(jnp.zeros_like(b.own), jnp.zeros_like(b.ghost), b.layout, b.backend)
    r = b.copy()
    norm0 = jnp.sqrt(pdot(r, r))

    z = Mfn(r)
    p = _as_row_vector(A, z)
    rz = pdot(r, z)

    def body(k, state):
        x, r, p, rz, norms = state
        Ap = _as_row_vector(A, spmv(A, _as_col_vector(A, p)))
        pAp = pdot(p, Ap)
        alpha = rz / pAp
        x = axpy(alpha, p, x)
        r = axpy(-alpha, Ap, r)
        z = Mfn(r)
        rz_new = pdot(r, z)
        beta = rz_new / rz
        p = PVector(z.own + beta * p.own, z.ghost + beta * p.ghost, p.layout, p.backend)
        norms = norms.at[k + 1].set(jnp.sqrt(pdot(r, r)))
        return (x, r, p, rz_new, norms)

    norms = jnp.zeros((iterations + 1,), dtype=b.own.dtype).at[0].set(norm0)
    x, r, p, rz, norms = jax.lax.fori_loop(
        0, iterations, body, (x, r, p, rz, norms)
    )
    return x, norms


def hpcg_cg_flat_g(mg, b: PVector, iterations: int = 50):
    """PCG in the GS de-interleaved flat space for GHOSTED (multi-part)
    meshes.  Vectors, dots and axpys live in the core form; the A-apply is
    the fused core kernel plus the ghost-column contribution (one halo
    exchange, folded through an interleave/deinterleave pair);
    the preconditioner is the ghosted flat V-cycle.  Standard row order
    appears only at the exchange boundary and the level transfers."""
    gs = mg.gss[-1]
    col = gs.colored
    backend = b.backend
    lay = b.layout

    ax_name = backend.axis_name()
    dot = backend.spmd_cached(
        ("cgf_dot", col),
        lambda: (lambda a, b: jax.lax.psum(vdot(a, b), ax_name)),
    )

    def a_apply(p):
        gc = gs.ghost_contrib(gs.flat_interleave(p))
        return gs.flat_ax(p) + gs.flat_deinterleave(gc)

    def m_apply(r):
        r_std = gs.flat_interleave(r)
        rv = PVector(
            r_std,
            jnp.zeros((r_std.shape[0], lay.n_ghost_pad), r_std.dtype),
            lay,
            backend,
        )
        return mg._cycle_flat_g(mg.n_levels - 1, rv)

    bf = gs.make_bd(b)
    x = jnp.zeros_like(bf)
    r = bf
    norm0 = jnp.sqrt(dot(r, r)[0])
    z = m_apply(r)
    p = z
    rz = dot(r, z)[0]

    def body(k, state):
        x, r, p, rz, norms = state
        Ap = a_apply(p)
        alpha = rz / dot(p, Ap)[0]
        x = x + alpha * p
        r = r - alpha * Ap
        z = m_apply(r)
        rz_new = dot(r, z)[0]
        beta = rz_new / rz
        p = z + beta * p
        norms = norms.at[k + 1].set(jnp.sqrt(dot(r, r)[0]))
        return (x, r, p, rz_new, norms)

    norms = jnp.zeros((iterations + 1,), dtype=bf.dtype).at[0].set(norm0)
    x, r, p, rz, norms = jax.lax.fori_loop(
        0, iterations, body, (x, r, p, rz, norms)
    )
    x_own = gs.flat_interleave(x)
    xv = PVector(
        x_own,
        jnp.zeros((x_own.shape[0], lay.n_ghost_pad), x_own.dtype),
        lay,
        backend,
    )
    return xv, norms


def hpcg_cg_flat(mg, b: PVector, iterations: int = 50):
    """PCG with every vector living in the GS de-interleaved FLAT space.

    Single-part-per-device fast path (valid when the finest level smooths
    in flat space): the A-apply is the flat-space DIA product,
    the MG preconditioner runs via ``apply_flat`` (its input is a zero-cost
    VIEW of the flat residual), and dots/axpys are permutation- and
    zero-padding-invariant, so they run directly on the flat buffers.
    Standard row order appears exactly twice per solve: b in, x out —
    eliminating the per-iteration layout transforms.
    """
    gs = mg.gss[-1]
    col = gs.colored
    backend = b.backend
    lay = b.layout

    ax = backend.axis_name()
    dot = backend.spmd_cached(
        ("cgf_dot", col),
        lambda: (lambda a, b: jax.lax.psum(vdot(a, b), ax)),
    )

    bf = gs.make_bd(b)  # (P, m, Lq) core — the only std->flat transform
    x = jnp.zeros_like(bf)
    r = bf
    norm0 = jnp.sqrt(dot(r, r)[0])
    z = mg.apply_flat(r)
    p = z
    rz = dot(r, z)[0]

    def body(k, state):
        x, r, p, rz, norms = state
        Ap = gs.flat_ax(p)
        pAp = dot(p, Ap)[0]
        alpha = rz / pAp
        x = x + alpha * p
        r = r - alpha * Ap
        z = mg.apply_flat(r)
        rz_new = dot(r, z)[0]
        beta = rz_new / rz
        p = z + beta * p
        norms = norms.at[k + 1].set(jnp.sqrt(dot(r, r)[0]))
        return (x, r, p, rz_new, norms)

    norms = jnp.zeros((iterations + 1,), dtype=bf.dtype).at[0].set(norm0)
    x, r, p, rz, norms = jax.lax.fori_loop(
        0, iterations, body, (x, r, p, rz, norms)
    )
    x_own = gs.flat_interleave(x)
    xv = PVector(
        x_own,
        jnp.zeros((x_own.shape[0], lay.n_ghost_pad), x_own.dtype),
        lay,
        backend,
    )
    return xv, norms


def hpcg_cg_df64(
    A: PSparseMatrix,
    b_pair,
    M: Optional[Callable[[PVector], PVector]] = None,
    iterations: int = 50,
):
    """Official-precision PCG: matrix, vectors, dots and updates in df64
    (two-float ~f64 arithmetic, ops/df64.py); the MG preconditioner stays
    f32.  A preconditioner is an approximate inverse — its precision only
    moves the convergence RATE; the residual recurrence (A@p, the dots,
    x/r updates) is what bounds the achievable relative residual, and
    those all run compensated here.  Validated against true f64 CG on CPU
    (tests/test_df64.py::test_hpcg_cg_df64_matches_f64).

    ``b_pair``: (hi, lo) PVectors on ``A.row_prange``.  Returns
    ((x_hi, x_lo), resnorms[iterations+1]).
    """
    from ...ops import df64 as df
    from ...psparse import spmv_df64

    bh, bl = b_pair
    backend = bh.backend
    lay = bh.layout
    ax = backend.axis_name()
    Mfn = M if M is not None else (lambda r: r)

    ddot = backend.spmd_cached(
        ("hpcg_df_dot",),
        lambda: (lambda ah, al, ch, cl: df.dot_spmd((ah, al), (ch, cl), ax)),
    )

    def dot(a, c):
        h, l = ddot(a[0], a[1], c[0], c[1])
        return h[0], l[0]  # identical on every part

    def as_pvec_pair(v):
        zg = jnp.zeros((v[0].shape[0], lay.n_ghost_pad), v[0].dtype)
        return (
            PVector(v[0], zg, lay, backend),
            PVector(v[1], zg, lay, backend),
        )

    if M is None:
        # identity preconditioner: z = r EXACTLY (both words).  Truncating
        # to hi here f32-quantizes every search direction and the x built
        # from them stalls at f32 eps even though the (df64) residual
        # recurrence keeps converging — the round-2 red-test bug.
        def precond(r):
            return r
    else:
        # A real (f32) preconditioner is an approximate inverse; its output
        # legitimately has no lo word.  Seeding lo with the residual's lo
        # scaled by a diagonal estimate would be possible but unnecessary:
        # M only moves the convergence rate.
        def precond(r):
            z = Mfn(PVector(
                r[0], jnp.zeros((r[0].shape[0], lay.n_ghost_pad), r[0].dtype),
                lay, backend,
            ))
            return (z.own, jnp.zeros_like(z.own))

    def a_apply(p):
        ph, pl = as_pvec_pair(p)
        # x lives on the row partition; re-home to the column layout
        clay = A.col_layout()
        zgc = jnp.zeros((p[0].shape[0], clay.n_ghost_pad), p[0].dtype)
        yh, yl = spmv_df64(
            A,
            (PVector(ph.own, zgc, clay, backend), PVector(pl.own, zgc, clay, backend)),
        )
        return (yh.own, yl.own)

    x = (jnp.zeros_like(bh.own), jnp.zeros_like(bh.own))
    r = (bh.own, bl.own)
    norm0 = jnp.sqrt(dot(r, r)[0])
    z = precond(r)
    p = z
    rz = dot(r, z)

    def body(k, state):
        x, r, p, rz, norms = state
        Ap = a_apply(p)
        pAp = dot(p, Ap)
        alpha = df.div(rz, pAp)
        x = df.add(x, df.scale(p, alpha))
        r = df.sub(r, df.scale(Ap, alpha))
        z = precond(r)
        rz_new = dot(r, z)
        beta = df.div(rz_new, rz)
        p = df.add(z, df.scale(p, beta))
        norms = norms.at[k + 1].set(jnp.sqrt(dot(r, r)[0]))
        return (x, r, p, rz_new, norms)

    norms = jnp.zeros((iterations + 1,), dtype=bh.own.dtype).at[0].set(norm0)
    x, r, p, rz, norms = jax.lax.fori_loop(
        0, iterations, body, (x, r, p, rz, norms)
    )
    return x, norms
