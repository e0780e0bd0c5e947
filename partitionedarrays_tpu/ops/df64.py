"""Double-float ("df64") arithmetic: f64-equivalent precision from f32 pairs.

Every value is an unevaluated sum ``hi + lo`` of two f32 with
``|lo| <= ulp(hi)/2``, giving ~49 bits of significand (IEEE f64 has 53)
through Dekker/Knuth error-free transformations built from plain f32
operations — fully vectorized, and usable with jax x64 off (the library
default), so f32 arrays and f64-grade arithmetic live in one program.

This is the "official-precision" configuration of the HPCG benchmark here
(models/hpcg/cg.py::hpcg_cg_df64): the fine-operator SpMV, the CG vector
updates, and the dot products all run in df64; the MG preconditioner stays
f32 (a preconditioner is an approximate inverse — its precision moves the
convergence RATE, not the achievable residual).  Validated against true
f64 (numpy / jax x64 on CPU): see tests/test_df64.py.

References (public domain algorithms): T. J. Dekker, "A floating-point
technique for extending the available precision" (1971); D. E. Knuth,
TAOCP vol. 2 (two_sum); Hida/Li/Bailey's ddfun conventions.
Reference-capability counterpart: the reference simply uses Float64
everywhere (e.g. /root/reference/HPCG/src/sparse_matrix.jl:115-118);
this module delivers that capability with jax x64 off.
"""
from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

# Dekker split constant for f32 (24-bit significand -> 12+12)
_SPLIT = 4097.0  # 2**12 + 1


def _pin(x):
    """Pin a ROUNDED f32 value against compiler re-derivation.

    Error-free transformations are only correct if the compiler evaluates
    exactly the written sequence of roundings.  XLA does not honor that:
    it rematerializes cheap producers into every consumer fusion and then
    (a) FMA-contracts patterns like ``s - a*b`` into ``fnmsub(a, b, s)``,
    substituting the EXACT product where the algebra requires the rounded
    one (this also collapses the Veltkamp split: ``a1 - a`` with
    ``a1 = a*4097`` becomes an exact fms and the split degenerates to
    (a, 0)), and (b) REASSOCIATES inlined add chains — measured: with
    ``p2 = e + cross`` inlined, ``s = p + p2`` was compiled as
    ``(p + e) + cross``, a misrounding of 1 ulp(s) that breaks the
    (hi, lo) invariant.  Net effect before the fix: the df64 CG's solution
    stalled at f32 eps while its recurred residual reached 1e-9 (the
    round-2 red test).

    ``reduce_precision(x, 8, 23)`` is a numerical identity on f32 but a
    distinct HLO op: neither the algebraic simplifier nor LLVM will fuse,
    reassociate, or fold THROUGH it (optimization_barrier and bitcast
    round-trips get dropped/collapsed by the CPU pipeline; this does not).
    Discipline: every input of an error-free transformation is pinned, so
    no associativity/contraction chain can cross into its load-bearing
    roundings; interior low-order terms stay unpinned (a contraction there
    moves the result by <= 1 ulp of lo, which the algebra tolerates).
    Cost: ~1 vector op each — noise against the memory-bound df64 SpMV."""
    return jax.lax.reduce_precision(x, 8, 23)


def two_sum(a, b):
    """Error-free a + b = s + e (Knuth, 6 flops, branch-free)."""
    a = _pin(a)
    b = _pin(b)
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def quick_two_sum(a, b):
    """Error-free a + b = s + e assuming |a| >= |b| (3 flops)."""
    a = _pin(a)
    b = _pin(b)
    s = a + b
    e = b - (s - a)
    return s, e


def two_prod(a, b):
    """Error-free a * b = p + e (Dekker split, 17 flops; overflow-safe for
    |a|,|b| < ~1e31, far beyond this library's operating range)."""
    # see _pin: inputs, the product, and the Veltkamp split products must
    # all be pinned; the remaining unpinned products only feed second-order
    # terms where a single contraction is harmless (<= 1 ulp of lo).
    a = _pin(a)
    b = _pin(b)
    p = _pin(a * b)
    a1 = _pin(a * _SPLIT)
    ah = a1 - (a1 - a)
    al = a - ah
    b1 = _pin(b * _SPLIT)
    bh = b1 - (b1 - b)
    bl = b - bh
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


# -- df64 values are (hi, lo) tuples of same-shape f32 arrays -------------

def add(a: Tuple, b: Tuple) -> Tuple:
    """df64 + df64 (accurate variant, ~20 flops)."""
    s1, s2 = two_sum(a[0], b[0])
    t1, t2 = two_sum(a[1], b[1])
    s2 = s2 + t1
    s1, s2 = quick_two_sum(s1, s2)
    s2 = s2 + t2
    return quick_two_sum(s1, s2)


def sub(a: Tuple, b: Tuple) -> Tuple:
    return add(a, (-b[0], -b[1]))


def mul(a: Tuple, b: Tuple) -> Tuple:
    """df64 * df64 (~25 flops)."""
    p1, p2 = two_prod(a[0], b[0])
    p2 = p2 + (a[0] * b[1] + a[1] * b[0])
    return quick_two_sum(p1, p2)


def div(a: Tuple, b: Tuple) -> Tuple:
    """df64 / df64 (two correction steps, ~1 ulp_df64)."""
    q1 = a[0] / b[0]
    r = sub(a, mul((q1, jnp.zeros_like(q1)), b))
    q2 = r[0] / b[0]
    r = sub(r, mul((q2, jnp.zeros_like(q2)), b))
    q3 = r[0] / b[0]
    q1, q2 = quick_two_sum(q1, q2)
    return quick_two_sum(q1, q2 + q3)


def sqrt(a: Tuple) -> Tuple:
    """df64 square root: f32 seed + one df64 Newton step (quadratic
    convergence makes one step sufficient for ~2^-48 relative)."""
    s = jnp.sqrt(jnp.maximum(a[0], 0.0))
    sp = (s, jnp.zeros_like(s))
    q = div(a, (jnp.where(s > 0, s, 1.0), jnp.zeros_like(s)))
    h, l = add(sp, q)
    return (0.5 * h, 0.5 * l)  # exact halving


def scale(v: Tuple, s: Tuple) -> Tuple:
    """vector df64 * scalar df64 (broadcast mul)."""
    return mul(v, (jnp.broadcast_to(s[0], v[0].shape), jnp.broadcast_to(s[1], v[0].shape)))


def neg(a: Tuple) -> Tuple:
    return (-a[0], -a[1])


def tree_sum(pair: Tuple) -> Tuple:
    """df64 sum of all elements: binary-fold tree with the df64 adder —
    every partial sum is error-free-compensated, so the result matches an
    f64 sum to ~1e-14 relative at n = millions (a plain f32 sum of n
    terms is ~n*eps off)."""
    ph = pair[0].reshape(-1)
    pl = pair[1].reshape(-1)
    n = ph.shape[0]
    while n > 1:
        half = (n + 1) // 2
        pad = 2 * half - n
        if pad:
            ph = jnp.concatenate([ph, jnp.zeros((pad,), ph.dtype)])
            pl = jnp.concatenate([pl, jnp.zeros((pad,), pl.dtype)])
        ph, pl = add((ph[:half], pl[:half]), (ph[half:], pl[half:]))
        n = half
    return ph[0], pl[0]


def dot(a: Tuple, b: Tuple) -> Tuple:
    """df64 dot product of two df64 vectors (any shape; reduces all axes)."""
    return tree_sum(mul((a[0].reshape(-1), a[1].reshape(-1)),
                        (b[0].reshape(-1), b[1].reshape(-1))))


def dot_spmd(a: Tuple, b: Tuple, axis_name: str) -> Tuple:
    """df64 dot across SPMD parts: per-part compensated dot, then an
    all_gather of the P partial pairs and a df64 fold (a plain psum of the
    hi components would re-round at f32 and throw the compensation away)."""
    ph, pl = dot(a, b)
    gh = jax.lax.all_gather(ph, axis_name)
    gl = jax.lax.all_gather(pl, axis_name)
    return tree_sum((gh, gl))


def from_f64(v: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Host split of an f64 array into (hi, lo) f32 (error <= ulp(lo)/2
    of the original, ~2^-48 relative)."""
    v = np.asarray(v, dtype=np.float64)
    hi = v.astype(np.float32)
    lo = (v - hi.astype(np.float64)).astype(np.float32)
    return hi, lo


def to_f64(hi, lo) -> np.ndarray:
    """Host reconstruction (exact: f32 embeds in f64)."""
    return np.asarray(hi, dtype=np.float64) + np.asarray(lo, dtype=np.float64)


def zeros(shape, dtype=jnp.float32) -> Tuple:
    return jnp.zeros(shape, dtype), jnp.zeros(shape, dtype)


# -- df64 DIA SpMV --------------------------------------------------------

def dia_spmv_df(offsets, vals_hi, vals_lo, x: Tuple, n_cols_pad: int) -> Tuple:
    """y = A @ x with A and x in df64; per-part SPMD kernel.

    Same shifted-stream structure as ops/dia.py::dia_spmv — each tap is an
    error-free two_prod of (vals df64) x (x df64) folded into a df64
    accumulator.  vals_hi/vals_lo: [n_off, R]; x: (hi, lo) of [n_cols_pad].
    """
    R = vals_hi.shape[-1]
    if not offsets:
        return zeros((R,), vals_hi.dtype)
    lo_off = min(min(offsets), 0)
    hi_off = max(max(offsets) + R, n_cols_pad)
    span = hi_off - lo_off

    def pad(v):
        vp = jnp.zeros((span,), dtype=v.dtype)
        return jax.lax.dynamic_update_slice(vp, v, (-lo_off,))

    xh, xl = pad(x[0]), pad(x[1])
    acc = zeros((R,), vals_hi.dtype)
    for d, off in enumerate(offsets):
        sh = jax.lax.slice(xh, (off - lo_off,), (off - lo_off + R,))
        sl = jax.lax.slice(xl, (off - lo_off,), (off - lo_off + R,))
        acc = add(acc, mul((vals_hi[d], vals_lo[d]), (sh, sl)))
    return acc


def ell_spmv_df(cols, vals_hi, vals_lo, x: Tuple) -> Tuple:
    """df64 ELL SpMV: y[r] = sum_k vals[r,k] * x[cols[r,k]] with df64
    products and a compensated accumulation over the K lanes (vectorized
    over rows; K gathers).  Padding lanes carry OOB columns (gather fills 0)
    and zero values."""
    K = cols.shape[-1]
    R = cols.shape[:-1]
    if x[0].shape[-1] == 0 or K == 0:
        return zeros(R, vals_hi.dtype)
    acc_h = jnp.zeros(R, vals_hi.dtype)
    acc_l = jnp.zeros(R, vals_hi.dtype)
    for k in range(K):
        ck = cols[..., k]
        gh = jnp.take(x[0], ck, mode="fill", fill_value=0)
        gl = jnp.take(x[1], ck, mode="fill", fill_value=0)
        p, e = two_prod(vals_hi[..., k], gh)
        e = e + (vals_hi[..., k] * gl + vals_lo[..., k] * gh)
        acc_h, c = two_sum(acc_h, p)
        acc_l = acc_l + (c + e)
    return quick_two_sum(acc_h, acc_l)
