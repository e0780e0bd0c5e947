"""Unit tests for the host-side local storage & sparse kernels (L2).

Parity with the reference suites test/jagged_array_tests.jl and
test/sparse_utils_tests.jl (0-based indices here).
"""
import numpy as np
import pytest
import scipy.sparse as sp

from partitionedarrays_tpu.ops.jagged import (
    JaggedArray,
    GenericJaggedArray,
    jagged_array,
    length_to_ptrs,
    ptrs_to_lengths,
    rewind_ptrs,
)
from partitionedarrays_tpu.ops.sparse_host import (
    compresscoo,
    indextype,
    nzindex,
    nziterator,
    precompute_nzindex,
    sparse_matrix,
    sparse_matrix_refill,
    split_locally,
    spmtv,
    spmv,
    sub_sparse_matrix,
)


# -- jagged arrays ------------------------------------------------------


def test_length_to_ptrs_roundtrip():
    lengths = [3, 0, 2, 5]
    ptrs = length_to_ptrs(lengths)
    assert list(ptrs) == [0, 3, 3, 5, 10]
    assert list(ptrs_to_lengths(ptrs)) == lengths


def test_rewind_ptrs():
    # after a fill pass each ptr has advanced by its item's length;
    # rewinding restores the offsets (reference: rewind_ptrs!,
    # src/jagged_array.jl:26)
    ptrs = length_to_ptrs([2, 1, 3])
    advanced = ptrs.copy()
    advanced[:-1] = ptrs[1:]  # simulate fill pass on ptrs[:-1]
    rewound = rewind_ptrs(advanced[:-1].tolist() + [advanced[-2]])
    assert list(rewound[: len(ptrs) - 1]) == list(ptrs[:-1])


def test_jagged_from_lists_and_views():
    a = JaggedArray.from_lists([[1, 2], [], [3, 4, 5]])
    assert len(a) == 3
    assert list(a[0]) == [1, 2]
    assert list(a[1]) == []
    assert list(a[2]) == [3, 4, 5]
    assert list(a.lengths()) == [2, 0, 3]
    # __getitem__ returns views of the flat buffer
    a[2] = [7, 8, 9]
    assert list(a.data) == [1, 2, 7, 8, 9]
    assert a == jagged_array(a.data, a.ptrs)
    assert a.copy() == a
    assert GenericJaggedArray is JaggedArray


def test_jagged_empty_alloc():
    a = JaggedArray.empty([4, 1], dtype=np.float32)
    assert a.data.dtype == np.float32
    assert a.data.shape == (5,)
    assert (a.data == 0).all()


# -- compresscoo / nzindex / refill -------------------------------------


def test_compresscoo_sums_duplicates_and_filters_negatives():
    I = np.array([0, 0, 1, 2, -1, 0])
    J = np.array([0, 0, 1, 2, 1, -3])
    V = np.array([1.0, 2.0, 3.0, 4.0, 99.0, 99.0])
    A = compresscoo(I, J, V, 3, 3)
    assert A.shape == (3, 3)
    assert A[0, 0] == 3.0  # duplicates summed
    assert A[1, 1] == 3.0
    assert A[2, 2] == 4.0
    assert A.nnz == 3  # negative-index entries dropped
    assert indextype(A) == A.indices.dtype


def test_nziterator_matches_dense():
    rng = np.random.default_rng(0)
    D = np.where(rng.random((5, 7)) < 0.3, rng.random((5, 7)), 0.0)
    A = sp.csr_matrix(D)
    got = np.zeros_like(D)
    for i, j, v in nziterator(A):
        got[i, j] = v
    np.testing.assert_allclose(got, D)


def test_nzindex_and_precompute_refill():
    I = np.array([0, 1, 2, 1, -1])
    J = np.array([1, 0, 2, 2, 0])
    V = np.array([1.0, 2.0, 3.0, 4.0, 5.0])
    A, K = sparse_matrix(I, J, V, 3, 3, reuse=True)
    # nzindex finds each stored entry; missing entries return -1
    for k in range(4):
        pos = nzindex(A, int(I[k]), int(J[k]))
        assert pos >= 0 and A.data[pos] != 0
    assert nzindex(A, 0, 0) == -1
    assert K[4] == -1  # filtered entry
    # refill at fixed sparsity with new values
    V2 = np.array([10.0, 20.0, 30.0, 40.0, 0.0])
    sparse_matrix_refill(A, V2, K)
    assert A[0, 1] == 10.0
    assert A[1, 0] == 20.0
    assert A[2, 2] == 30.0
    assert A[1, 2] == 40.0


def test_refill_accumulates_duplicates():
    I = np.array([0, 0])
    J = np.array([0, 0])
    V = np.array([1.0, 2.0])
    A, K = sparse_matrix(I, J, V, 1, 1, reuse=True)
    assert A[0, 0] == 3.0
    sparse_matrix_refill(A, np.array([5.0, 7.0]), K)
    assert A[0, 0] == 12.0


# -- spmv / sub blocks ---------------------------------------------------


def test_spmv_spmtv_match_dense():
    rng = np.random.default_rng(1)
    D = np.where(rng.random((6, 4)) < 0.4, rng.random((6, 4)), 0.0)
    A = sp.csr_matrix(D)
    x = rng.random(4)
    y = rng.random(6)
    np.testing.assert_allclose(spmv(A, x), D @ x)
    np.testing.assert_allclose(spmtv(A, y), D.T @ y)


def test_sub_sparse_matrix_and_split():
    rng = np.random.default_rng(2)
    D = np.where(rng.random((6, 6)) < 0.5, rng.random((6, 6)), 0.0)
    A = sp.csr_matrix(D)
    own_r = np.array([0, 2, 4])
    gho_r = np.array([1, 3, 5])
    own_c = np.array([0, 1, 2])
    gho_c = np.array([3, 4, 5])
    S = sub_sparse_matrix(A, own_r, own_c)
    np.testing.assert_allclose(S.toarray(), D[np.ix_(own_r, own_c)])
    oo, oh, ho, hh = split_locally(A, own_r, gho_r, own_c, gho_c)
    np.testing.assert_allclose(oo.toarray(), D[np.ix_(own_r, own_c)])
    np.testing.assert_allclose(oh.toarray(), D[np.ix_(own_r, gho_c)])
    np.testing.assert_allclose(ho.toarray(), D[np.ix_(gho_r, own_c)])
    np.testing.assert_allclose(hh.toarray(), D[np.ix_(gho_r, gho_c)])
    # the four blocks partition the nonzeros
    assert oo.nnz + oh.nnz + ho.nnz + hh.nnz == A.nnz
