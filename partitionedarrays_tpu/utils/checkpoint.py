"""Checkpoint / resume for partitioned containers.

The reference serializes nothing (SURVEY §5: checkpoint/resume absent);
this module is an addition: PVector and PSparseMatrix round-trip
through a single ``.npz`` (values + partition metadata), so long solver
runs can snapshot state and restart on a possibly different backend.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from ..backends import Backend
from ..parallel.p_range import LocalIndices, PRange
from ..psparse import PSparseMatrix, psparse_from_global, to_global_scipy
from ..pvector import PVector, pvector_from_own


def _partition_arrays(pr: PRange) -> dict:
    out = {"n_parts": np.int64(pr.n_parts), "n_global": np.int64(pr.n_global)}
    for p, li in enumerate(pr.partition()):
        out[f"own_{p}"] = li.own_to_global
        out[f"ghost_{p}"] = li.ghost_to_global
        out[f"gowner_{p}"] = li.ghost_to_owner
    return out


def _partition_from_arrays(d: dict, prefix: str = "") -> PRange:
    P = int(d[prefix + "n_parts"])
    n = int(d[prefix + "n_global"])
    owner = np.empty(n, dtype=np.int64)
    parts = []
    for p in range(P):
        owner[d[prefix + f"own_{p}"]] = p
    g2o = lambda q: np.where(
        np.asarray(q) >= 0, owner[np.clip(np.asarray(q), 0, n - 1)], -1
    )
    for p in range(P):
        parts.append(
            LocalIndices(
                n, p, P,
                d[prefix + f"own_{p}"],
                d[prefix + f"ghost_{p}"],
                d[prefix + f"gowner_{p}"],
                global_to_owner=g2o,
            )
        )
    return PRange(parts)


def save_pvector(path: str, v: PVector) -> None:
    arrays = _partition_arrays(v.layout.pr)
    for p, vals in enumerate(v.own_values()):
        arrays[f"vals_{p}"] = np.asarray(vals)
    np.savez_compressed(path, **arrays)


def load_pvector(path: str, backend: Backend, dtype=None) -> PVector:
    d = np.load(path)
    pr = _partition_from_arrays(d)
    vals = [d[f"vals_{p}"] for p in range(pr.n_parts)]
    return pvector_from_own(vals, pr, backend, dtype=dtype)


def save_psparse(path: str, A: PSparseMatrix) -> None:
    G = to_global_scipy(A)
    arrays = {
        "indptr": G.indptr,
        "indices": G.indices,
        "data": G.data,
        "shape": np.array(G.shape, dtype=np.int64),
    }
    rows = _partition_arrays(A.row_prange)
    cols_pr = PRange([li.remove_ghost() for li in A.col_prange.partition()])
    cols = _partition_arrays(cols_pr)
    arrays.update({"r_" + k: v for k, v in rows.items()})
    arrays.update({"c_" + k: v for k, v in cols.items()})
    np.savez_compressed(path, **arrays)


def load_psparse(path: str, backend: Backend) -> PSparseMatrix:
    import scipy.sparse as sp

    d = np.load(path)
    shape = tuple(d["shape"])
    G = sp.csr_matrix((d["data"], d["indices"], d["indptr"]), shape=shape)
    rows = _partition_from_arrays(d, "r_")
    cols = _partition_from_arrays(d, "c_")
    return psparse_from_global(G, rows, cols, backend)
