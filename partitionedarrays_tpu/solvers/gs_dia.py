"""Gauss-Seidel for DIA (banded) blocks: mod-m coloring with a
de-interleaved unknown vector.

Classic multicolor GS on a vector machine costs n_colors full SpMV-like
passes per sweep.  For a banded own_own block (diagonal offsets O) we do a
TRUE Gauss-Seidel sweep at one-SpMV data volume using contiguous ops only:

1. Pick the smallest m >= 2 such that no nonzero offset o in O is a
   multiple of m.  Then color(i) = i mod m is a valid coloring (no two
   coupled rows share a color).
2. De-interleave x into rows xd[s, i'] = x[m*i' + s]: a stride-m sample of
   a shifted sequence is a *shifted contiguous row* of xd, so every
   diagonal's contribution to the color-c rows is a contiguous slice.
3. Lay the rows out in one flat buffer (with zero margins at both ends):
   the color-c update becomes literally a DIA SpMV with static absolute
   offsets into that buffer (ops/dia.py).  Per sweep: m such updates,
   total data volume = one pass over the diagonal values.

The de-interleave and interleave are a reshape and a transpose: exact
permutations, no arithmetic.

Ghost-column contributions are frozen per sweep (hybrid processor-block
GS, identical to the reference's semantics at
PartitionedSolvers/src/smoothers.jl:104-143).
"""
from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np


def _round_up(x: int, mlt: int) -> int:
    return ((x + mlt - 1) // mlt) * mlt


def find_mod_coloring(offsets, max_m: int = 512) -> Optional[int]:
    """Smallest m >= 2 with o % m != 0 for every nonzero offset."""
    nz = [abs(int(o)) for o in offsets if o != 0]
    if not nz:
        return 2
    for m in range(2, max_m + 1):
        if all(o % m for o in nz):
            return m
    return None


class ColoredDIAGS:
    """Per-block state for the mod-m colored DIA Gauss-Seidel sweep.

    Built from the stacked DIA storage vals[P, n_off, R] of the own_own
    block; all tables host-prepared once and frozen.
    """

    def _plan(self, offsets: Tuple[int, ...], R: int):
        """Static geometry shared by the host and device constructors."""
        self.offsets = tuple(int(o) for o in offsets)
        m = find_mod_coloring(self.offsets)
        assert m is not None
        self.m = m
        self.R = R
        self.Lq = max(-(-R // m), 1)  # row length of the (m, Lq) core
        # max |de-interleaved row shift|
        self.Kp = max(
            (abs((c + o) // m) + 1 for o in self.offsets for c in range(m)),
            default=1,
        )
        # CONTIGUOUS core layout: rows have NO per-row margins; the flat
        # buffer is [Kp zeros | row0..row_{m-1} back to back | Kp
        # zeros].  Safe because any tap that strays outside its target
        # row's core multiplies a PROVABLY ZERO diagonal value (a valid
        # entry A[j, j+o] has j+o in [0, R), which lands inside the target
        # core by construction) — only margins at the two buffer ends are
        # needed.  to_flat is then a pure copy and core_of_flat one slice.
        self.n_flat = self.Kp + m * self.Lq + self.Kp
        # static ABSOLUTE offsets per color: the color-c update computes
        # ax[i] = sum_d vals_c[d, i] * xflat[offs_d + i] with
        # offs_d = s_d*Lq + Kp + k_d >= 0 — literally a DIA SpMV into the
        # flat buffer.
        self.schedule = []
        for c in range(m):
            offs = []
            for o in self.offsets:
                j = c + o
                s = j % m
                k = (j - s) // m
                offs.append(s * self.Lq + self.Kp + k)
            self.schedule.append(tuple(offs))

    def __init__(
        self,
        offsets: Tuple[int, ...],
        vals: np.ndarray,
        diag: np.ndarray,
        values_dtype=None,
    ):
        P, n_off, R = vals.shape
        self._plan(offsets, R)
        m, Lq = self.m, self.Lq
        # de-interleave diagonal values: vals_d[P, m, n_off, Lq]
        Rq = m * Lq
        vp = np.zeros((P, n_off, Rq), dtype=vals.dtype)
        vp[:, :, :R] = vals
        vals_d = vp.reshape(P, n_off, Lq, m).transpose(0, 3, 1, 2)
        self.vals_d = jnp.asarray(
            np.ascontiguousarray(vals_d),
            dtype=values_dtype if values_dtype is not None else vals_d.dtype,
        )
        # de-interleaved inverse diagonal (zero on padding -> no-op update)
        dp = np.zeros((P, Rq), dtype=diag.dtype)
        dp[:, :R] = diag
        inv = np.where(dp != 0, 1.0 / np.where(dp != 0, dp, 1.0), 0.0)
        self.invd_d = jnp.asarray(
            np.ascontiguousarray(inv.reshape(P, Lq, m).transpose(0, 2, 1))
        )

    @classmethod
    def from_device(
        cls,
        offsets: Tuple[int, ...],
        vals_dev,
        diag_dev,
        values_dtype=None,
    ) -> "ColoredDIAGS":
        """Build the sweep state WITHOUT touching the host: ``vals_dev``
        [P, n_off, R] and ``diag_dev`` [P, R] stay device-resident and the
        de-interleave reshuffle runs as one jitted XLA program.  This is
        the setup path for closed-form stencil operators (ops/stencil.py)
        where host materialization + H2D of the diagonal values would
        dominate setup time (hundreds of MB per level at HPCG scales)."""
        self = cls.__new__(cls)
        P, n_off, R = (int(s) for s in vals_dev.shape)
        self._plan(offsets, R)
        m, Lq = self.m, self.Lq
        Rq = m * Lq

        @jax.jit
        def _build(vals, diag):
            vp = jnp.zeros((P, n_off, Rq), vals.dtype).at[:, :, :R].set(vals)
            vals_d = vp.reshape(P, n_off, Lq, m).transpose(0, 3, 1, 2)
            if values_dtype is not None:
                vals_d = vals_d.astype(values_dtype)
            dp = jnp.zeros((P, Rq), diag.dtype).at[:, :R].set(diag)
            dd = dp.reshape(P, Lq, m).transpose(0, 2, 1)
            inv = jnp.where(dd != 0, 1.0 / jnp.where(dd != 0, dd, 1.0), 0.0)
            return vals_d, inv

        self.vals_d, self.invd_d = _build(vals_dev, diag_dev)
        return self

    # -- de/interleave (per-part, traceable) --------------------------
    def deinterleave(self, x: jnp.ndarray) -> jnp.ndarray:
        """x[R-padded own values] -> xd[m, Lq] with xd[s, i] = x[m*i + s]
        (zero beyond R)."""
        m, Lq = self.m, self.Lq
        xp = jnp.zeros((m * Lq,), x.dtype).at[: self.R].set(x[: self.R])
        return xp.reshape(Lq, m).T

    def to_flat(self, xd: jnp.ndarray) -> jnp.ndarray:
        """xd[m, Lq] -> flat buffer [n_flat]: pure contiguous copy between
        the two end margins."""
        z = jnp.zeros((self.Kp,), xd.dtype)
        return jnp.concatenate([z, xd.reshape(-1), z])

    # -- the sweep -----------------------------------------------------
    def _color_ax(self, xflat, vals_c, offs):
        """sum_d vals_c[d, i] * xflat[offs[d] + i] for one color: ``offs``
        are the color's absolute schedule offsets as a traced int32 row,
        all in [0, n_flat - Lq] by construction (see _plan)."""
        ax = jnp.zeros((self.Lq,), vals_c.dtype)
        for d in range(len(self.offsets)):
            seg = jax.lax.dynamic_slice(xflat, (offs[d],), (self.Lq,))
            ax = ax + vals_c[d] * seg
        return ax

    def sweep_flat(
        self,
        xflat: jnp.ndarray,
        bd: jnp.ndarray,
        vals_d: jnp.ndarray,
        invd_d: jnp.ndarray,
        order,
    ) -> jnp.ndarray:
        """GS color updates in ``order``, entirely in the flat
        de-interleaved space: one ``lax.fori_loop`` step per color, so the
        compiled program does not grow with the number of colors.  bd
        [m, Lq] = de-interleaved (b - own_ghost @ x_ghost), frozen for the
        whole smoother application (reference semantics: consistent! once
        per smooth, smoothers.jl:104-105)."""
        order = jnp.asarray(np.asarray(order, np.int32))
        table = jnp.asarray(np.asarray(self.schedule, np.int32))
        Kp, Lq = self.Kp, self.Lq

        def update(i, xflat):
            c = order[i]
            # the barrier keeps the per-diagonal products in one fusion
            # that writes only ax; without it XLA materializes every term
            # for the in-place row update (a 1.55x slower sweep, PERF.md)
            ax = jax.lax.optimization_barrier(
                self._color_ax(xflat, vals_d[c], table[c])
            )
            start = c * Lq + Kp
            xrow = jax.lax.dynamic_slice(xflat, (start,), (Lq,))
            xnew = xrow + (bd[c] - ax) * invd_d[c]
            return jax.lax.dynamic_update_slice(xflat, xnew, (start,))

        return jax.lax.fori_loop(0, order.shape[0], update, xflat)

    # -- core API (the preferred form: no padded buffers outside kernels) --
    def zeros_core(self, dtype) -> jnp.ndarray:
        return jnp.zeros((self.m, self.Lq), dtype)

    def core_of_flat(self, xflat: jnp.ndarray) -> jnp.ndarray:
        return jax.lax.dynamic_slice(
            xflat, (self.Kp,), (self.m * self.Lq,)
        ).reshape(self.m, self.Lq)

    def interleave_core(self, xcore: jnp.ndarray) -> jnp.ndarray:
        """(m, Lq) core -> standard own order [R]."""
        return xcore.T.reshape(-1)[: self.R]

    def ax_core(self, xcore: jnp.ndarray, vals_d: jnp.ndarray) -> jnp.ndarray:
        """A_own_own @ x in the de-interleaved layout, core-in core-out
        (one pass over the diagonal values; one loop step per color)."""
        xflat = self.to_flat(xcore)
        table = jnp.asarray(np.asarray(self.schedule, np.int32))
        return jax.lax.map(
            lambda c: self._color_ax(xflat, vals_d[c], table[c]),
            jnp.arange(self.m),
        )

    def sweeps_core(
        self, xcore, bd, vals_d, invd_d, order_seq, dtype=None
    ) -> jnp.ndarray:
        """Run a whole color sequence on the (m, Lq) core (``xcore=None``
        means zero initial guess): the per-color composition on the
        padded flat buffer."""
        order_seq = tuple(int(c) for c in order_seq)
        if xcore is None:
            xcore = self.zeros_core(dtype if dtype is not None else bd.dtype)
        xflat = self.sweep_flat(self.to_flat(xcore), bd, vals_d, invd_d, order_seq)
        return self.core_of_flat(xflat)
