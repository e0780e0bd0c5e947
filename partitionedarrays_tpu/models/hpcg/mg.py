"""Geometric multigrid preconditioner for HPCG.

Capability parity: HPCG/src/mg_preconditioner.jl — l levels (default 4),
each level a fresh 27-pt operator at half resolution per dim (:137-185),
restriction by injection of the even-coordinate points (restrict_operator
:81-101), V-cycle with symmetric-GS pre/post smoothing and smooth-only
coarsest solve (pc_solve! :314-328).

The fine->coarse injection is a stride-2 slice of each part's C-ordered
own box; restrict = slice, prolongate = interior-padded add — no
communication (injection points are interior to each part's box).
The V-cycle is unrolled over levels (static shapes per level) and fully
jittable; smoothing uses the colored-DIA GS sweep.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ...psparse import PSparseMatrix, spmv
from ...pvector import PVector
from ...solvers.smoothers import GaussSeidel, _register_identity_pytree
from .problem import build_hpcg_problem

OOB = np.int32(np.iinfo(np.int32).max - 255)


def restrict_operator(nx: int, ny: int, nz: int) -> np.ndarray:
    """Coarse own-local index -> fine own-local index (C-order boxes),
    taking the even-coordinate fine points
    (parity: restrict_operator, HPCG/src/mg_preconditioner.jl:81-101)."""
    assert nx % 2 == 0 and ny % 2 == 0 and nz % 2 == 0
    nxc, nyc, nzc = nx // 2, ny // 2, nz // 2
    # our boxes are C-ordered as (d0, d1, d2) = (x, y, z) axes of the
    # partition builder; fine local index = (ix * ny + iy) * nz + iz
    ix, iy, iz = np.meshgrid(
        np.arange(nxc), np.arange(nyc), np.arange(nzc), indexing="ij"
    )
    fine = ((2 * ix) * ny + (2 * iy)) * nz + (2 * iz)
    return fine.reshape(-1).astype(np.int32)


class HPCGMGPreconditioner:
    """V-cycle geometric MG over ``n_levels`` 27-pt operators."""

    def __init__(
        self,
        local_shape: Sequence[int],
        parts_per_dir: Sequence[int],
        backend,
        n_levels: int = 4,
        dtype=np.float64,
        smoother_iters: int = 1,
        precond_dtype=None,
    ):
        """``precond_dtype``: optional reduced-precision storage (e.g.
        jnp.bfloat16) for the matrix values streamed INSIDE the V-cycle
        (GS sweeps + the Axf residual SpMV).  Vectors, dots and the outer
        CG operator stay in ``dtype``; updates accumulate in ``dtype`` —
        standard mixed-precision multigrid: the preconditioner is an
        approximate inverse, so value precision only nudges the
        convergence rate while halving the dominant HBM stream."""
        nx, ny, nz = (int(v) for v in local_shape)
        assert min(nx, ny, nz) % (2 ** (n_levels - 1)) == 0, (
            "local shape must be divisible by 2^(levels-1)"
        )
        self.n_levels = n_levels
        self.As: List[PSparseMatrix] = []
        self.gss: List[GaussSeidel] = []
        self.bs = []
        shapes = []
        for l in range(n_levels):
            shapes.append((nx >> l, ny >> l, nz >> l))
        # level order: index 0 = coarsest ... n_levels-1 = finest
        self.devs_pc: List = []  # per-level device blocks for the Axf SpMV
        for shape in reversed(shapes):
            A, b = build_hpcg_problem(shape, parts_per_dir, backend, dtype=dtype)
            self.As.append(A)
            self.gss.append(
                GaussSeidel(
                    A,
                    iterations=smoother_iters,
                    sweep="symmetric",
                    values_dtype=precond_dtype,
                )
            )
            self.devs_pc.append(
                A.device().astype(precond_dtype)
                if precond_dtype is not None
                else A.device()
            )
            self.bs.append(b)
        # local box shape of each level (index = As index; 0 = coarsest).
        # The injection map is a pure stride-2 slice of the C-ordered box:
        # restrict = stride-2 slice on all three dims; prolongate =
        # interior-padded (x2 dilated) add via lax.pad.
        self.level_shapes: List[Tuple[int, int, int]] = [
            shapes[n_levels - 1 - l] for l in range(n_levels)
        ]
        self.backend = backend

    @property
    def A(self) -> PSparseMatrix:
        return self.As[-1]

    @property
    def b(self) -> PVector:
        return self.bs[-1]

    def nnz_per_level(self) -> List[int]:
        return [A.nnz() for A in self.As]

    # -- V-cycle -------------------------------------------------------
    def _restrict(self, l: int, r_own: jnp.ndarray) -> PVector:
        """Injection restrict: the even-coordinate points (an exact
        stride-2 slice)."""
        nx, ny, nz = self.level_shapes[l]
        P = r_own.shape[0]
        clay = self.As[l - 1].row_layout()
        r3 = r_own[:, : nx * ny * nz].reshape(P, nx, ny, nz)
        rc_own = _pad_to(r3[:, ::2, ::2, ::2].reshape(P, -1), clay.n_own_pad)
        return PVector(
            rc_own,
            jnp.zeros((P, clay.n_ghost_pad), rc_own.dtype),
            clay,
            self.backend,
        )

    def _prolong(self, l: int, xc_own: jnp.ndarray, n_own_pad: int) -> jnp.ndarray:
        """Injection prolongate: interior-padded (x2 dilated) correction in
        standard order, zero elsewhere."""
        nx, ny, nz = self.level_shapes[l]
        nxc, nyc, nzc = self.level_shapes[l - 1]
        P = xc_own.shape[0]
        c3 = xc_own[:, : nxc * nyc * nzc].reshape(P, nxc, nyc, nzc)
        dil = jax.lax.pad(
            c3,
            jnp.zeros((), c3.dtype),
            ((0, 0, 0), (0, 1, 1), (0, 1, 1), (0, 1, 1)),
        )
        return _pad_to(dil.reshape(P, -1), n_own_pad)

    def _cycle(self, l: int, b: PVector) -> PVector:
        gs = self.gss[l]
        A = self.As[l]
        if l == 0 or gs.colored is None:
            # generic path (coarsest level / non-colored smoother)
            x = gs(b)  # zero-guess pre-smooth (coarsest: this IS the solve)
            if l == 0:
                return x
            Axf = spmv(A, _col_view(A, x), dev=self.devs_pc[l])
            rc = self._restrict(l, b.own - Axf.own)
            xc = self._cycle(l - 1, rc)
            corr = self._prolong(l, xc.own, x.own.shape[1])
            x = PVector(x.own + corr, x.ghost, x.layout, self.backend)
            return gs.apply(x, b)  # post-smooth

        # flat pipeline: enter the de-interleaved sweep space once and run
        # the whole V-cycle there (see _cycle_flat_bd / _cycle_flat_g)
        rlay = A.row_layout()
        if gs.flat_viable():
            bd = gs.make_bd(b)
            xflat = self._cycle_flat_bd(l, bd)
        else:
            xflat = self._cycle_flat_g(l, b)
        x_own = gs.flat_interleave(xflat)
        return PVector(
            x_own,
            jnp.zeros((x_own.shape[0], rlay.n_ghost_pad), x_own.dtype),
            rlay,
            self.backend,
        )

    def _cycle_flat_g(self, l: int, b: PVector) -> jnp.ndarray:
        """GHOSTED flat V-cycle level: smoothing and the level state stay
        in the de-interleaved core space; the frozen ghost-column
        contribution is folded into the core rhs per smoother application
        (hybrid-GS semantics, identical to the generic path).  Two ghost
        exchanges per level per cycle — the pre-smooth starts from a zero
        guess whose ghosts are zero, so it needs none (the reference pays
        three: one per consistent! in each smooth plus the Axf mul!)."""
        gs = self.gss[l]
        bd0 = gs.make_bd(b)  # zero-guess: ghost contribution is zero
        xflat = gs.smooth_bd(None, bd0)  # pre-smooth
        # true level residual: r = b - A_oo x - A_oh g (fresh ghosts)
        gc = gs.ghost_contrib(gs.flat_interleave(xflat))
        rd = gs.flat_residual(xflat, bd0)  # bd0 - A_oo x, core form
        r_std = gs.flat_interleave_core(rd) - gc
        rc = self._restrict(l, r_std)
        xc = self._cycle(l - 1, rc)
        corr = self._prolong(l, xc.own, r_std.shape[1])
        xflat = gs.flat_add_std(xflat, corr)
        # post-smooth with refreshed frozen ghosts
        gc2 = gs.ghost_contrib(gs.flat_interleave(xflat))
        bd2 = gs.flat_deinterleave(b.own - gc2)
        return gs.smooth_bd(xflat, bd2)

    def flat_viable(self) -> bool:
        return self.gss[-1].flat_viable()

    def flat_viable_ghosted(self) -> bool:
        """True when the finest level can run the GHOSTED flat pipeline
        (colored smoother; halo exchanges folded through the core form)."""
        return self.n_levels >= 2 and self.gss[-1].colored is not None

    def apply_flat(self, bd) -> jnp.ndarray:
        """The preconditioner acting entirely in the de-interleaved space:
        takes the de-interleaved residual bd (P, m, Lq), returns the flat
        correction buffer (P, n_flat).  Used by the flat-space CG — no
        full-size layout transforms at the preconditioner boundary."""
        return self._cycle_flat_bd(self.n_levels - 1, bd)

    def _cycle_flat_bd(self, l: int, bd) -> jnp.ndarray:
        """V-cycle below the interleave boundary.  x and the smoothing all
        live in the de-interleaved space; standard order appears only for
        the level transfer (residual interleave at the FINE size, then the
        coarse-level transforms cost 1/8th of that)."""
        gs = self.gss[l]
        xflat = gs.smooth_bd(None, bd)          # zero-guess pre-smooth
        if l == 0:
            return xflat                        # coarsest: smooth-only
        rd = gs.flat_residual(xflat, bd)        # (P, m, Lq), fused Ax
        r_std = gs.flat_interleave_core(rd)     # (P, n_own_pad)
        rc = self._restrict(l, r_std)
        gs_c = self.gss[l - 1]
        if gs_c.flat_viable():
            bd_c = gs_c.make_bd(rc)             # coarse-size transform
            xfc = self._cycle_flat_bd(l - 1, bd_c)
            xc_own = gs_c.flat_interleave(xfc)  # coarse-size transform
        else:
            xc_own = self._cycle(l - 1, rc).own
        corr = self._prolong(l, xc_own, r_std.shape[1])
        xflat = gs.flat_add_std(xflat, corr)
        return gs.smooth_bd(xflat, bd)          # post-smooth

    def __call__(self, r: PVector) -> PVector:
        return self._cycle(self.n_levels - 1, r)


def _col_view(A: PSparseMatrix, v: PVector) -> PVector:
    clay = A.col_layout()
    if v.layout is clay:
        return v
    return PVector(
        v.own,
        jnp.zeros((v.own.shape[0], clay.n_ghost_pad), v.own.dtype),
        clay,
        v.backend,
    )


def _pad_to(a: jnp.ndarray, n: int) -> jnp.ndarray:
    if a.shape[1] == n:
        return a
    if a.shape[1] > n:
        return a[:, :n]
    return jnp.pad(a, ((0, 0), (0, n - a.shape[1])))


_register_identity_pytree(HPCGMGPreconditioner, ("As", "gss", "devs_pc"))
