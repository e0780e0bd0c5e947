"""Per-block device storage with automatic format selection.

Each split block (own_own, own_ghost, ...) of a PSparseMatrix freezes into
a :class:`DeviceBlock`: DIA (shifted dense diagonals — speed-of-light
stencil path, ops/dia.py) when the block is banded in local indices, else
padded ELL (gather path, ops/ell.py).  The choice is static per block and
baked into the compiled program.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import scipy.sparse as sp

from .dia import dia_spmv, dia_viable, stack_dia
from .ell import ell_spmv, stack_ell, stack_ell_values


@jax.tree_util.register_pytree_node_class
class DeviceBlock:
    """kind: "dia" (vals [P, n_off, R]) or "ell" (cols+vals [P, R, K])."""

    def __init__(self, kind, offsets, n_cols_pad, cols, vals):
        self.kind = kind
        self.offsets = offsets  # static tuple (dia) or None
        self.n_cols_pad = n_cols_pad
        self.cols = cols  # None for dia
        self.vals = vals

    def tree_flatten(self):
        return (self.cols, self.vals), (self.kind, self.offsets, self.n_cols_pad)

    @classmethod
    def tree_unflatten(cls, aux, children):
        kind, offsets, n_cols_pad = aux
        cols, vals = children
        return cls(kind, offsets, n_cols_pad, cols, vals)

    # per-part SPMD spmv: x is the per-part padded column vector
    def spmv(self, x: jnp.ndarray) -> jnp.ndarray:
        if self.kind == "dia":
            return dia_spmv(self.offsets, self.vals, x, self.n_cols_pad)
        return ell_spmv(self.cols, self.vals, x)

    def nbytes(self) -> int:
        n = int(np.prod(self.vals.shape)) * self.vals.dtype.itemsize
        if self.cols is not None:
            n += int(np.prod(self.cols.shape)) * 4
        return n

    def astype(self, dtype) -> "DeviceBlock":
        """Values-cast copy (cols/offsets shared).  Used for reduced-
        precision preconditioner copies (kernels accumulate in the x
        dtype, so bf16 values halve the dominant memory stream)."""
        return DeviceBlock(
            self.kind, self.offsets, self.n_cols_pad, self.cols,
            self.vals.astype(dtype),
        )


def make_dia_block(offsets, n_cols_pad: int, vals) -> DeviceBlock:
    """DIA DeviceBlock from device-resident logical values [P, n_off, R]."""
    return DeviceBlock(
        "dia", tuple(int(o) for o in offsets), n_cols_pad, None, vals
    )


def freeze_block(
    blocks: Sequence[sp.spmatrix],
    n_rows_pad: int,
    n_cols_pad: int,
    prefer_dia: bool = True,
    max_diags: int = 128,
    cache: Optional[dict] = None,
) -> DeviceBlock:
    """Choose DIA when every part block is banded with a small common
    diagonal set AND the dense-diagonal storage does not exceed the ELL
    footprint; else ELL.

    ``max_diags`` is 128, so every fixed-offset band structure (7/27-pt
    stencils, Q1 FEM at 27, interleaved Q1 elasticity at 81,
    box-aggregated Galerkin levels) lands on the gather-free DIA path,
    which also moves no column indices.  Whether an 81-diagonal band is
    cheaper as ELL on the GPU is not measured yet.  The storage guard below
    keeps DIA off blocks whose band is mostly empty (dense-diagonal
    storage > ELL footprint)."""
    csrs = [b.tocsr() for b in blocks]
    if prefer_dia:
        offsets = dia_viable(csrs, max_diags=max_diags)
        if offsets is not None and offsets.size:
            kmax = max(
                (int(np.diff(b.indptr).max()) if b.nnz else 0) for b in csrs
            )
            # DIA stores n_off*R values; ELL stores K*R values + K*R int32
            if offsets.size <= max(2 * kmax, 4):
                vals = stack_dia(csrs, n_rows_pad, offsets)
                return make_dia_block(
                    tuple(int(o) for o in offsets),
                    n_cols_pad,
                    jnp.asarray(vals),
                )
    # refill fast path: at FIXED sparsity (psparse_refill mutates the same
    # scipy objects' .data in place) reuse the device-resident column
    # table — only the value planes are restacked and uploaded
    sig = tuple((id(b), b.nnz) for b in csrs)
    if cache is not None and cache.get("sig") == sig:
        vals = stack_ell_values(csrs, n_rows_pad, cache["ell_K"])
        return DeviceBlock(
            "ell", None, n_cols_pad, cache["ell_cols"], jnp.asarray(vals)
        )
    cols, vals = stack_ell(csrs, n_rows_pad)
    cols_dev = jnp.asarray(cols)
    if cache is not None:
        cache.clear()
        # refs keeps the keyed csr objects alive: id() in `sig` is only
        # meaningful while the objects live (GC + id reuse could otherwise
        # false-hit the cache with a stale column table)
        cache.update(
            sig=sig, ell_cols=cols_dev, ell_K=cols.shape[-1], refs=csrs,
        )
    return DeviceBlock("ell", None, n_cols_pad, cols_dev, jnp.asarray(vals))


# -- df64 (two-float) block pairs -------------------------------------------

def freeze_block_pair(
    blocks64: Sequence[sp.spmatrix], n_rows_pad: int, n_cols_pad: int
) -> Tuple["DeviceBlock", "DeviceBlock"]:
    """Freeze f64 host blocks into a (hi, lo) pair of f32 DeviceBlocks with
    identical structure — the storage of the official-precision (df64)
    path (ops/df64.py).  DIA when banded; the ELL pair shares one
    column-index array."""
    from . import df64 as df

    csrs = [b.tocsr().astype(np.float64) for b in blocks64]
    offsets = dia_viable(csrs, max_diags=128)
    if offsets is not None and offsets.size:
        kmax = max((int(np.diff(b.indptr).max()) if b.nnz else 0) for b in csrs)
        if offsets.size <= max(2 * kmax, 4):
            vals64 = stack_dia(csrs, n_rows_pad, offsets)  # [P, n_off, R] f64
            hi, lo = df.from_f64(vals64)
            bh = make_dia_block(offsets, n_cols_pad, jnp.asarray(hi))
            bl = make_dia_block(offsets, n_cols_pad, jnp.asarray(lo))
            return bh, bl
    cols, vals64 = stack_ell(csrs, n_rows_pad)
    hi, lo = df.from_f64(vals64)
    cols_dev = jnp.asarray(cols)
    bh = DeviceBlock("ell", None, n_cols_pad, cols_dev, jnp.asarray(hi))
    bl = DeviceBlock("ell", None, n_cols_pad, cols_dev, jnp.asarray(lo))
    return bh, bl


def block_spmv_df(bh: "DeviceBlock", bl: "DeviceBlock", x_pair):
    """y = block @ x in df64; per-part SPMD kernel on a freeze_block_pair."""
    from .df64 import dia_spmv_df, ell_spmv_df

    if bh.kind == "dia":
        return dia_spmv_df(bh.offsets, bh.vals, bl.vals, x_pair, bh.n_cols_pad)
    return ell_spmv_df(bh.cols, bh.vals, bl.vals, x_pair)
