"""DIA (diagonal) sparse format: the fast-path device layout for SpMV.

The ELL path (x[cols]) gathers and moves a column index per nonzero.
After C-order block partitioning,
every stencil/FEM own_own block is *banded in local indices*: the nonzeros
sit on a small set of constant diagonals (7 for FDM-3D, 27 for HPCG, 9/27
for Q1 FEM).  Storing those diagonals densely turns SpMV into

    y = sum_d vals[d, :] * shift(x, offset_d)

— a handful of statically-shifted contiguous vector streams that XLA fuses
into one stencil pass bound by memory bandwidth.  DIA also halves traffic
vs ELL (no column indices).

The own_ghost block (box surface, irregular columns) and unstructured
matrices (e.g. AMG Galerkin products) keep the ELL gather path; the format
is chosen per block at freeze time (see psparse.DeviceSpMat).

Reference counterpart: the CSR/CSC spmv! loops (src/sparse_utils.jl:
609-690) — same math, layout re-designed for vector hardware.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import scipy.sparse as sp


def csr_diagonals(A: sp.csr_matrix) -> np.ndarray:
    """Distinct diagonal offsets (j - i) present in A."""
    coo = A.tocoo()
    if coo.nnz == 0:
        return np.zeros(0, dtype=np.int64)
    return np.unique(coo.col.astype(np.int64) - coo.row.astype(np.int64))


def dia_viable(blocks: Sequence[sp.spmatrix], max_diags: int = 48) -> Optional[np.ndarray]:
    """If every part block fits in a small common set of diagonals, return
    the union of offsets, else None."""
    offs = set()
    for b in blocks:
        offs.update(csr_diagonals(b.tocsr()).tolist())
        if len(offs) > max_diags:
            return None
    return np.array(sorted(offs), dtype=np.int64)


def stack_dia(
    blocks: Sequence[sp.spmatrix], n_rows_pad: int, offsets: np.ndarray
) -> np.ndarray:
    """Per-part blocks -> vals[P, n_off, n_rows_pad] with
    vals[p, d, i] = A_p[i, i + offsets[d]] (0 outside)."""
    P = len(blocks)
    n_off = offsets.shape[0]
    out = np.zeros((P, max(n_off, 1), n_rows_pad), dtype=blocks[0].dtype if P else np.float32)
    for p, b in enumerate(blocks):
        coo = b.tocoo()
        if coo.nnz == 0:
            continue
        off = coo.col.astype(np.int64) - coo.row.astype(np.int64)
        d = np.searchsorted(offsets, off)  # offsets is sorted by contract
        out[p, d, coo.row] = coo.data
    return out


def dia_spmv(
    offsets: Tuple[int, ...], vals: jnp.ndarray, x: jnp.ndarray, n_cols_pad: int
) -> jnp.ndarray:
    """y[i] = sum_d vals[d, i] * x[i + offsets[d]] — per-part SPMD kernel.

    ``offsets`` is a static tuple; each term is a statically-shifted slice
    of a zero-padded x, so the whole SpMV compiles to fused vector streams
    (no gathers).  vals: [n_off, R]; x: [n_cols_pad]; returns [R].
    """
    R = vals.shape[-1]
    if not offsets:
        return jnp.zeros((R,), dtype=jnp.promote_types(vals.dtype, x.dtype))
    lo = min(min(offsets), 0)
    hi = max(max(offsets) + R, n_cols_pad)
    xpad = jnp.zeros((hi - lo,), dtype=x.dtype)
    xpad = jax.lax.dynamic_update_slice(xpad, x, (-lo,))
    y = jnp.zeros((R,), dtype=vals.dtype)
    for d, off in enumerate(offsets):
        seg = jax.lax.slice(xpad, (off - lo,), (off - lo + R,))
        y = y + vals[d] * seg
    return y
