"""Padded ELL sparse format: the device-resident layout for SpMV.

The reference keeps per-part CSC/CSR blocks and runs scalar row loops
(spmv!, reference: src/sparse_utils.jl:609-690).  Dynamic row lengths
defeat static shapes under jit, so each split block (own_own, own_ghost, ...)
is frozen at setup into ELL: ``cols[int32 R, K]`` / ``vals[R, K]`` with K =
max nnz/row, padding lanes holding an out-of-bounds column (gathered as 0
via ``mode="fill"``) and zero value.  For the stencil matrices of the
benchmark suite (7-pt/27-pt Laplacians, Q1 FEM) rows are near-uniform, so
the padding waste is small.

SpMV is then a dense gather + multiply + row reduction — fully fusable by
XLA.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import jax.numpy as jnp
import numpy as np
import scipy.sparse as sp

# matches exchange_plan.OOB
OOB = np.int32(np.iinfo(np.int32).max - 255)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m if x > 0 else 0


def csr_to_ell(A: sp.csr_matrix, n_rows_pad: int, k: Optional[int] = None):
    """One CSR block -> (cols[int32 n_rows_pad, K], vals[n_rows_pad, K])."""
    A = A.tocsr()
    nnz_row = np.diff(A.indptr)
    kmax = int(nnz_row.max()) if nnz_row.size else 0
    K = kmax if k is None else k
    cols = np.full((n_rows_pad, max(K, 1)), OOB, dtype=np.int32)
    vals = np.zeros((n_rows_pad, max(K, 1)), dtype=A.dtype)
    if A.nnz:
        r = np.repeat(np.arange(A.shape[0]), nnz_row)
        c = (np.arange(A.nnz) - np.repeat(A.indptr[:-1], nnz_row)).astype(np.int64)
        cols[r, c] = A.indices
        vals[r, c] = A.data
    return cols, vals


def stack_ell(
    blocks: Sequence[sp.spmatrix], n_rows_pad: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Per-part CSR blocks -> stacked ELL arrays [P, n_rows_pad, K] with a
    common (padded) K across parts (static shape under jit)."""
    csrs = [b.tocsr() for b in blocks]
    kmax = 0
    for b in csrs:
        nnz_row = np.diff(b.indptr)
        if nnz_row.size:
            kmax = max(kmax, int(nnz_row.max()))
    K = max(kmax, 1)
    cols = np.empty((len(csrs), n_rows_pad, K), dtype=np.int32)
    vals = np.empty((len(csrs), n_rows_pad, K), dtype=csrs[0].dtype if csrs else np.float32)
    for p, b in enumerate(csrs):
        c, v = csr_to_ell(b, n_rows_pad, K)
        cols[p] = c
        vals[p] = v
    return cols, vals


def stack_ell_values(
    blocks: Sequence[sp.spmatrix], n_rows_pad: int, K: int
) -> np.ndarray:
    """Values-only restack at FIXED sparsity (the refill fast path: the
    column table is unchanged, so only the value planes are rebuilt)."""
    csrs = [b.tocsr() for b in blocks]
    vals = np.zeros(
        (len(csrs), n_rows_pad, max(K, 1)),
        dtype=csrs[0].dtype if csrs else np.float32,
    )
    for p, b in enumerate(csrs):
        if b.nnz:
            nnz_row = np.diff(b.indptr)
            r = np.repeat(np.arange(b.shape[0]), nnz_row)
            c = (np.arange(b.nnz) - np.repeat(b.indptr[:-1], nnz_row)).astype(
                np.int64
            )
            vals[p, r, c] = b.data
    return vals


def ell_spmv(cols: jnp.ndarray, vals: jnp.ndarray, x: jnp.ndarray) -> jnp.ndarray:
    """y[r] = sum_k vals[r,k] * x[cols[r,k]] — per-part SPMD kernel.

    cols/vals: [R, K]; x: [n_pad].  Padding lanes carry OOB columns
    (gather fills 0) and zero values.
    """
    if x.shape[-1] == 0 or cols.shape[-1] == 0:
        # empty block (e.g. no ghost columns): contribution is zero
        return jnp.zeros(cols.shape[:-1], dtype=vals.dtype)
    g = jnp.take(x, cols, mode="fill", fill_value=0)
    return jnp.sum(vals * g, axis=-1)


def ell_spmv_masked_diag(cols, vals, diag_idx, x):
    """SpMV excluding the diagonal lane (used by Jacobi-style sweeps)."""
    K = cols.shape[-1]
    if x.shape[-1] == 0 or K == 0:
        return jnp.zeros(cols.shape[:-1], dtype=vals.dtype)
    lane = jnp.arange(K)[None, :]
    off = jnp.where(lane == diag_idx[:, None], 0.0, vals)
    g = jnp.take(x, cols, mode="fill", fill_value=0)
    return jnp.sum(off * g, axis=-1)
