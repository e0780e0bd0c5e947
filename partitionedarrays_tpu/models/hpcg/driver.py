"""HPCG benchmark driver: the official 3-phase protocol.

Capability parity: HPCG/src/hpcg_benchmark.jl:26-100 —
phase 1: reference CG (50 iterations, 2 sets) establishing the target
tolerance; phase 2: optimized-CG validation (must reach the reference
tolerance); phase 3: timed sets; then the rating report.

Each 50-iteration MG-preconditioned CG set is ONE compiled XLA program
(matrices/smoothers travel as pytree arguments); wall time is measured
with a host fetch fence around whole sets, so the fixed dispatch latency
amortizes over a set.
"""
from __future__ import annotations

import time
from typing import Optional, Sequence

import numpy as np

from .cg import hpcg_cg, hpcg_cg_flat, hpcg_cg_flat_g
from .mg import HPCGMGPreconditioner
from .opt3d import compute_optimal_shape_xyz
from .report import HPCGReport


def hpcg_benchmark(
    backend,
    local_shape: Sequence[int] = (32, 32, 32),
    parts_per_dir: Optional[Sequence[int]] = None,
    n_levels: int = 4,
    iterations: int = 50,
    ref_sets: int = 2,
    timed_sets: int = 3,
    total_runtime: Optional[float] = None,
    dtype=np.float32,
    precond_dtype=None,
    verbose: bool = False,
    mg: Optional[HPCGMGPreconditioner] = None,
    setup_time: Optional[float] = None,
    precision: Optional[str] = None,
) -> HPCGReport:
    """``setup_time``: wall-clock seconds of pc_setup to account in the
    rated figure when a pre-built ``mg`` is passed (otherwise it is
    measured here).

    ``precision="df64"``: the OFFICIAL-PRECISION configuration — the fine
    operator, the CG vectors/updates and every dot run in df64 two-float
    (~f64) arithmetic (ops/df64.py, validated vs true f64); the MG
    preconditioner stays f32 (approximate inverse: precision only moves
    the convergence rate).  This is how the reference's
    Float64-everywhere capability (HPCG/src/sparse_matrix.jl:115-118) is
    delivered with jax x64 off.
    ``dtype`` is ignored (preconditioner f32, solve df64) in this mode."""
    import jax
    import jax.numpy as jnp

    from ...pvector import PVector

    df64_mode = precision == "df64"
    if df64_mode:
        dtype = np.float32  # the preconditioner/protocol dtype
    if backend is None and mg is None:
        # convenience default: one serial part per requested box
        from ...backends import SerialBackend

        backend = SerialBackend(
            int(np.prod(parts_per_dir)) if parts_per_dir is not None else 1
        )
    if parts_per_dir is None:
        parts_per_dir = compute_optimal_shape_xyz(backend.n_parts)
    t0 = time.perf_counter()
    if mg is None:
        mg = HPCGMGPreconditioner(
            local_shape,
            parts_per_dir,
            backend,
            n_levels=n_levels,
            dtype=dtype,
            precond_dtype=(
                jnp.dtype(precond_dtype) if precond_dtype is not None else None
            ),
        )
    A, b = mg.A, mg.b

    if df64_mode:
        from ...ops import df64 as dfm
        from ...ops.stencil import stencil_psparse, stencil_rhs_counts
        from ...psparse import device_df64
        from .cg import hpcg_cg_df64
        from .problem import STENCIL_27PT

        # exact f64 operator in CLOSED FORM, host blocks only (the device
        # generator would truncate f64 values on f32 hardware; the generic
        # triplet path costs minutes at benchmark scales) — device_df64
        # splits the f64 host blocks into the (hi, lo) f32 pair
        nxl, nyl, nzl = (int(v) for v in local_shape)
        pxl, pyl, pzl = (int(v) for v in parts_per_dir)
        gshape = (pxl * nxl, pyl * nyl, pzl * nzl)
        A = stencil_psparse(
            (pxl, pyl, pzl), gshape, STENCIL_27PT, mg.backend,
            dtype=np.float64, host_only=True,
        )
        device_df64(A)  # freeze the (hi, lo) pair now: it is setup work
        lay = A.row_layout()
        offdiag = [d for d, _ in STENCIL_27PT if d != (0, 0, 0)]
        b_host = np.zeros((lay.n_parts, lay.n_own_pad), np.float64)
        for p, c in enumerate(
            stencil_rhs_counts((pxl, pyl, pzl), gshape, offdiag)
        ):
            b_host[p, : c.size] = 26.0 - c
        bh_np, bl_np = dfm.from_f64(b_host)
        zg = jnp.zeros((bh_np.shape[0], lay.n_ghost_pad), jnp.float32)
        b = (
            PVector(jnp.asarray(bh_np), zg, lay, mg.backend),
            PVector(jnp.asarray(bl_np), zg, lay, mg.backend),
        )

    use_flat = not df64_mode and mg.flat_viable()
    use_flat_g = not df64_mode and not use_flat and mg.flat_viable_ghosted()

    def _scale_b(b, scale):
        if df64_mode:
            return tuple(
                PVector(v.own * scale, v.ghost * scale, v.layout, v.backend)
                for v in b
            )
        return PVector(b.own * scale, b.ghost * scale, b.layout, b.backend)

    def _b_dtype(b):
        return (b[0] if df64_mode else b).own.dtype

    def run_cg(A, mg, b):
        if df64_mode:
            (xh, xl), norms = hpcg_cg_df64(A, b, M=mg, iterations=iterations)
            return xh, norms
        if use_flat:
            x, norms = hpcg_cg_flat(mg, b, iterations=iterations)
            return x.own, norms
        if use_flat_g:
            x, norms = hpcg_cg_flat_g(mg, b, iterations=iterations)
            return x.own, norms
        x, norms = hpcg_cg(A, b, M=mg, iterations=iterations)
        return x.own, norms

    # Every set runs through ONE compiled program, chained through a
    # runtime scalar (b is rescaled by the previous set's final residual
    # norm and the result un-scaled by linearity) so XLA cannot collapse
    # the repeats; a single host fetch fences the whole chain.  This keeps
    # the fixed dispatch latency out of the measured per-set time, like
    # the reference's use of long `total_runtime` windows
    # (HPCG/src/hpcg_benchmark.jl:81-88).  The chain length k is a RUNTIME
    # argument (fori_loop lowers to a while_loop), so one set (k=1, scale
    # exactly 1), the timed chains and the big executed window below all
    # share ONE compiled executable; no chain length can leak a recompile
    # into its timed region.
    @jax.jit
    def run_chain(A, mg, b, k):
        def body(i, carry):
            scale, _, _ = carry
            bs = _scale_b(b, scale)
            x, norms = run_cg(A, mg, bs)
            new_scale = 1.0 + norms[-1] / norms[0] * 1e-12
            return (new_scale, norms / scale, x)

        one = jnp.ones((), _b_dtype(b))
        x0 = jnp.zeros_like((b[0] if df64_mode else b).own)
        _, norms, x = jax.lax.fori_loop(
            0, k, body,
            (one, jnp.zeros((iterations + 1,), _b_dtype(b)), x0),
        )
        return norms, x

    def one_set(A, mg, b):
        norms, x = run_chain(A, mg, b, jnp.int32(1))
        return x, norms

    # compile (counted as optimization time, like the reference's opt phase)
    t_c0 = time.perf_counter()
    own, norms = one_set(A, mg, b)
    np.asarray(norms)
    time_setup = (t_c0 - t0) if setup_time is None else float(setup_time)
    time_optimization = time.perf_counter() - t_c0

    # phase 1: reference sets -> tolerance
    ref_norms = None
    for _ in range(ref_sets):
        own, norms = one_set(A, mg, b)
        ref_norms = np.asarray(norms)
    tolerance = ref_norms[-1] / ref_norms[0]
    if verbose:
        print(f"[hpcg] ref relres after {iterations} iters: {tolerance:.3e}")

    # phase 2: validation — optimized run must reach the reference
    # tolerance.  Recorded in the report (pass/fail + achieved value), NOT
    # asserted: the reference's phase-2 flow reports a failed validation
    # instead of crashing the run (HPCG/src/hpcg_benchmark.jl:59-78,
    # report_results.jl tail).
    own, norms = one_set(A, mg, b)
    solution = own
    opt_norms = np.asarray(norms)
    opt_rel = opt_norms / opt_norms[0]
    opt_iters = int(np.argmax(opt_rel <= tolerance)) if (opt_rel <= tolerance).any() else iterations
    if opt_iters == 0:
        opt_iters = iterations
    validation_passed = bool(opt_rel[-1] <= tolerance * (1 + 1e-6))
    if verbose and not validation_passed:
        print(
            f"[hpcg] VALIDATION FAILED: achieved {opt_rel[-1]:.3e} vs"
            f" reference tolerance {tolerance:.3e}"
        )

    # phase 3: timed sets, as chains of the same compiled program
    n_sets = timed_sets
    run1 = lambda A, mg, b: run_chain(A, mg, b, jnp.int32(1))[0]  # noqa: E731
    runN = lambda A, mg, b: run_chain(A, mg, b, jnp.int32(1 + n_sets))[0]  # noqa: E731
    np.asarray(runN(A, mg, b))  # warm

    def timed(f):
        t0 = time.perf_counter()
        out = np.asarray(f(A, mg, b))
        return time.perf_counter() - t0, out

    # interleaved repeats + min per chain length: dispatch-latency spikes
    # are positive-only noise and must not leak into the difference (a
    # single spiked short-chain sample would INFLATE the reported rate)
    t1s, tNs = [], []
    for _ in range(5):
        dt1, norms1 = timed(run1)
        dtN, normsN = timed(runN)
        t1s.append(dt1)
        tNs.append(dtN)
    time_solve = min(tNs) - min(t1s)  # n_sets' worth of pure set time
    # sanity clamp: per-set time is positive and at most the
    # latency-INCLUSIVE big-chain average
    upper = min(tNs) * n_sets / (1 + n_sets)
    if not (0.0 < time_solve <= upper):
        time_solve = upper
    # chain-consistency is RECORDED, not asserted: numerical jitter over a
    # long scale-chained window must not crash a rating run — same
    # report-don't-crash semantics as the phase-2 validation (reference:
    # HPCG/src/hpcg_benchmark.jl:59-88 reports failures in the output)
    chain_consistent = bool(np.allclose(norms1, normsN, rtol=1e-4))
    window = "measured_sets"
    if total_runtime is not None:
        # official-style run WINDOW: a real benchmark run executes sets
        # until `total_runtime` elapses, which is what the rated figure
        # amortizes setup over (HPCG/src/hpcg_benchmark.jl:81-88).  The
        # set count is derived from the latency-free per-set time, then the
        # whole window is EXECUTED as one compiled chain (one fori_loop
        # bound) and re-timed — the published window is a real run, not an
        # extrapolation.
        per_set = time_solve / n_sets
        n_sets = max(int(np.ceil(total_runtime / per_set)), timed_sets)
        # the window reuses the SAME compiled executable (k is a runtime
        # scalar), so this is a clean fully-executed window with zero
        # compile time inside the timed region.  (The previous AOT
        # ``lower().compile()`` did not populate the jit cache and the
        # timed call recompiled — measured: rated GF/s collapsed 3x.)
        # The window is CHUNKED into ~15 s device executions, which keeps
        # every single execution short; per-chunk dispatch latency (a
        # handful of chunks) is noise against the window.
        # No timed_sets floor: large local shapes / df64 push per_set far
        # above 15 s / timed_sets and the floor would defeat the chunking.
        chunk = max(1, int(np.ceil(15.0 / max(per_set, 1e-6))))
        t0w = time.perf_counter()
        remaining = n_sets
        normsW = None
        while remaining > 0:
            k = min(chunk, remaining)
            normsW = np.asarray(run_chain(A, mg, b, jnp.int32(k))[0])
            remaining -= k
        time_solve = time.perf_counter() - t0w
        chain_consistent = chain_consistent and bool(
            np.allclose(norms1, normsW, rtol=1e-4)
        )
        window = "executed"
    if not chain_consistent and verbose:
        print(
            "[hpcg] INVALID: chained-window residual history diverged from "
            "the single-set run (rtol 1e-4) — figure not rateable"
        )

    report = HPCGReport(
        nrow=A.shape[0],
        nnz=A.nnz(),
        nnz_per_level=list(mg.nnz_per_level()),  # coarsest first
        iterations=iterations,
        ref_iterations=iterations,
        n_sets=n_sets,
        time_solve=time_solve,
        time_setup=time_setup,
        time_optimization=time_optimization,
        solution=solution,
        extra={
            "local_shape": list(local_shape),
            "parts_per_dir": list(parts_per_dir),
            "levels": n_levels,
            "final_relres": float(opt_rel[-1]),
            "dtype": "float64-df64" if df64_mode else np.dtype(dtype).name,
            # significand bits of the solve arithmetic: df64 carries ~49
            # (two f32 words), NOT IEEE f64's 53 — surfaced here so the
            # non-IEEE caveat travels with the rated figure, not only in
            # the prose report line
            "precision_bits": (
                49 if df64_mode else (53 if np.dtype(dtype) == np.float64 else 24)
            ),
            "validation_passed": validation_passed,
            "chain_consistent": chain_consistent,
            "validation_tolerance": float(tolerance),
            "validation_achieved": float(opt_rel[-1]),
            "phase3_window": window,
            "precond_values_dtype": (
                str(jnp.dtype(precond_dtype)) if precond_dtype is not None else None
            ),
        },
    )
    return report
