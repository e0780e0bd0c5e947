"""Jagged (ragged) array: vector-of-vectors stored as flat ``data`` + ``ptrs``.

This is the host-side buffer format used for all variable-length metadata in
the framework (neighbor lists, per-neighbor index lists, gathered payloads).
Capability parity with the reference's JaggedArray (reference:
src/jagged_array.jl:107-122, length_to_ptrs! :11, rewind_ptrs! :26,
jagged_array :195).

Unlike the reference (which uses it for MPI wire buffers), this build uses
JaggedArray only at setup time on host; device-side communication buffers are
*padded dense* arrays so shapes are static under ``jit`` (see
parallel/exchange_plan.py).

All indices are 0-based.
"""
from __future__ import annotations

import numpy as np


def length_to_ptrs(lengths) -> np.ndarray:
    """Offsets from per-item lengths: ptrs[i] = sum(lengths[:i]).

    Returns an int array of size ``len(lengths)+1`` (CSR-style offsets).
    Parity: length_to_ptrs! (src/jagged_array.jl:11) modulo 0-basing.
    """
    lengths = np.asarray(lengths, dtype=np.int64)
    ptrs = np.zeros(lengths.shape[0] + 1, dtype=np.int64)
    np.cumsum(lengths, out=ptrs[1:])
    return ptrs


def ptrs_to_lengths(ptrs) -> np.ndarray:
    ptrs = np.asarray(ptrs)
    return np.diff(ptrs)


class JaggedArray:
    """A list of variable-length numpy vectors in one flat buffer.

    ``a[i]`` is a *view* of ``data[ptrs[i]:ptrs[i+1]]``.
    """

    __slots__ = ("data", "ptrs")

    def __init__(self, data, ptrs):
        self.data = np.asarray(data)
        self.ptrs = np.asarray(ptrs, dtype=np.int64)

    # -- constructors -------------------------------------------------
    @classmethod
    def from_lists(cls, lists) -> "JaggedArray":
        lengths = [len(x) for x in lists]
        ptrs = length_to_ptrs(lengths)
        if len(lists) and np.asarray(lists[0]).size or len(lists):
            data = (
                np.concatenate([np.asarray(x).ravel() for x in lists])
                if sum(lengths)
                else np.zeros(0, dtype=np.asarray(lists[0]).dtype if len(lists) else np.int64)
            )
        else:
            data = np.zeros(0, dtype=np.int64)
        return cls(data, ptrs)

    @classmethod
    def empty(cls, lengths, dtype) -> "JaggedArray":
        ptrs = length_to_ptrs(lengths)
        return cls(np.zeros(ptrs[-1], dtype=dtype), ptrs)

    # -- list-of-vectors protocol ------------------------------------
    def __len__(self) -> int:
        return self.ptrs.shape[0] - 1

    def __getitem__(self, i):
        return self.data[self.ptrs[i] : self.ptrs[i + 1]]

    def __setitem__(self, i, value):
        self.data[self.ptrs[i] : self.ptrs[i + 1]] = value

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    def lengths(self) -> np.ndarray:
        return ptrs_to_lengths(self.ptrs)

    def copy(self) -> "JaggedArray":
        return JaggedArray(self.data.copy(), self.ptrs.copy())

    def __eq__(self, other):
        if not isinstance(other, JaggedArray):
            return NotImplemented
        return np.array_equal(self.ptrs, other.ptrs) and np.array_equal(
            self.data, other.data
        )

    def __repr__(self):
        inner = ", ".join(repr(list(x)) for x in self)
        return f"JaggedArray([{inner}])"


def rewind_ptrs(ptrs) -> np.ndarray:
    """Shift offsets back after a fill pass (parity: rewind_ptrs!,
    src/jagged_array.jl:26)."""
    ptrs = np.asarray(ptrs)
    out = np.empty_like(ptrs)
    out[1:] = ptrs[:-1]
    out[0] = 0
    return out


def jagged_array(data, ptrs) -> JaggedArray:
    """Parity alias (src/jagged_array.jl:195)."""
    return JaggedArray(data, ptrs)


# parity alias: the reference distinguishes a generic-container variant
GenericJaggedArray = JaggedArray
