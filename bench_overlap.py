"""Comm/compute overlap probe (VERDICT r1 weak #3 / next #4).

Question: does the halo exchange of the distributed SpMV actually hide
behind the own_own block kernel, as the dataflow form promises
(psparse.spmv: the ppermute rounds and the own_own product share no data
dependence; reference overlap: src/p_sparse_matrix.jl:2090-2103)?

Method (8-device virtual CPU mesh; the same XLA latency-hiding machinery
schedules NCCL collectives on a GPU mesh):

  t_oo   = own_own SpMV alone (no exchange)
  t_ex   = halo exchange alone (pack -> ppermute rounds -> unpack)
  t_full = the full overlapped SpMV (exchange + oo + oh + combine)
  t_seq  = a FORCED-SERIAL variant: the own_own input is made to depend
           on the exchange result, so XLA cannot overlap them

  overlap_fraction = (t_seq - t_full) / min(t_oo, t_ex)
    1.0 -> the cheaper of (exchange, compute) fully hides
    0.0 -> the dataflow form bought nothing over serialization

Prints one JSON line with the four times and the overlap fraction.
Run: XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \
     python bench_overlap.py
"""
from __future__ import annotations

import json
import time

import numpy as np


def _bench(fn, args, repeats=40):
    """(min, noise) over repeats — noise = spread of the lowest quartile,
    the honest uncertainty of the min-floor estimate on a time-sliced
    host (host scheduling jitter is positive-only)."""
    fn(*args)  # compile + warm
    ts = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        np.asarray(fn(*args))
        ts.append(time.perf_counter() - t0)
    ts.sort()
    q = max(2, len(ts) // 4)
    return ts[0], ts[q] - ts[0]


def main():
    import jax
    import jax.numpy as jnp

    n_dev = 8
    try:
        jax.config.update("jax_num_cpu_devices", n_dev)
    except Exception:
        pass

    devices = jax.devices()
    if len(devices) < n_dev:
        devices = jax.devices("cpu")
    devices = devices[:n_dev]

    from partitionedarrays_tpu.backends import MeshBackend
    from partitionedarrays_tpu.models.hpcg.problem import build_hpcg_problem
    from partitionedarrays_tpu.pvector import PVector
    from partitionedarrays_tpu.psparse import spmv

    backend = MeshBackend(devices=devices)
    # a large-ish local box so the own_own kernel has real work to hide
    # the exchange behind (27-pt: ~0.4 GB of diagonal streams per part)
    A, b = build_hpcg_problem((96, 96, 96), (n_dev, 1, 1), backend, dtype=np.float32)
    rlay = A.row_layout()
    clay = A.col_layout()
    dev = A.device()

    x = PVector(
        b.own, jnp.zeros((n_dev, clay.n_ghost_pad), jnp.float32), clay, backend
    )

    # -- t_full: the production overlapped SpMV
    f_full = jax.jit(lambda A, x: spmv(A, x).own)
    t_full, n_full = _bench(f_full, (A, x))

    # -- t_oo: own_own product only
    f_oo = backend.spmd_cached(
        ("probe_oo",), lambda: (lambda xo, oo: oo.spmv(xo))
    )
    t_oo, _ = _bench(f_oo, (x.own, dev.oo))

    # -- t_ex: exchange only (pack -> ppermute rounds -> single scatter)
    f_ex = backend.spmd_cached(
        ("probe_ex",),
        lambda: (lambda xo, xg, pl: pl.apply(xo, xg, "set")),
    )
    t_ex, _ = _bench(f_ex, (x.own, x.ghost, clay.consistent_plan))

    # -- t_seq: forced serialization — the own_own input depends on the
    # exchange output, so XLA must finish the exchange first
    def make_seq():
        def f(xo, xg, cplan, oo, oh):
            g = cplan.apply(xo, xg, "set")
            xo_dep = xo + 0.0 * g[:1].sum()  # fake dependency, ~free
            return oo.spmv(xo_dep) + oh.spmv(g)

        return f

    f_seq = backend.spmd_cached(("probe_seq",), make_seq)
    t_seq, n_seq = _bench(f_seq, (x.own, x.ghost, clay.consistent_plan, dev.oo, dev.oh))

    hideable = min(t_oo, t_ex)
    overlap = (t_seq - t_full) / hideable if hideable > 0 else 0.0
    overlap = min(1.0, max(0.0, overlap))  # clamp measurement noise
    # honest uncertainty: on a time-sliced 8-virtual-device host the
    # scheduling jitter of the two big measurements can exceed the whole
    # hideable window — flag the fraction when it is below that floor
    noise = n_full + n_seq
    print(
        json.dumps(
            {
                "metric": "spmv_overlap_fraction",
                "value": round(float(overlap), 3),
                "unit": "fraction of min(exchange, own_own) hidden",
                "detail": {
                    "t_full_ms": round(t_full * 1e3, 3),
                    "t_seq_ms": round(t_seq * 1e3, 3),
                    "t_own_own_ms": round(t_oo * 1e3, 3),
                    "t_exchange_ms": round(t_ex * 1e3, 3),
                    "noise_floor_ms": round(noise * 1e3, 3),
                    "below_noise_floor": bool(hideable < noise),
                    "devices": n_dev,
                    "platform": devices[0].platform,
                },
            }
        )
    )


if __name__ == "__main__":
    main()
