"""Weak-scaling harness: HPCG 27-pt SpMV + CG across an increasing device
mesh, constant work per device (the BASELINE.md weak-scaling protocol).

Runs on whatever devices are visible:

    python bench_scaling.py                       # the visible GPUs
    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python bench_scaling.py --local 16        # 8-way virtual CPU mesh

Across hosts, initialize jax.distributed before running; the mesh then
spans hosts and the same code measures their interconnect.

Prints one JSON line per device count with nnz/s per device and the
weak-scaling efficiency vs the single-device run.
"""
from __future__ import annotations

import argparse
import json

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--local", type=int, default=None, help="local box edge")
    ap.add_argument("--iters", type=int, default=25, help="CG iterations")
    ap.add_argument(
        "--out", type=str, default=None,
        help="also write all records to this JSON file (the per-round "
        "SCALING_r0N.json artifact)",
    )
    args = ap.parse_args()

    import os

    import jax

    if os.environ.get("JAX_PLATFORMS", "").lower() == "cpu":
        # reach the virtual host-platform devices explicitly
        n = int(
            os.environ.get("XLA_FLAGS", "").partition(
                "host_platform_device_count="
            )[2].partition(" ")[0]
            or 1
        )
        try:
            jax.config.update("jax_num_cpu_devices", n)
        except Exception:
            pass

    import jax.numpy as jnp

    from bench import slope_time_per_iter
    from partitionedarrays_tpu.backends import MeshBackend
    from partitionedarrays_tpu.models.hpcg.cg import hpcg_cg
    from partitionedarrays_tpu.models.hpcg.opt3d import compute_optimal_shape_xyz
    from partitionedarrays_tpu.models.hpcg.problem import build_hpcg_problem
    from partitionedarrays_tpu.psparse import spmv
    from partitionedarrays_tpu.pvector import PVector

    devices = jax.devices()
    if os.environ.get("JAX_PLATFORMS", "").lower() == "cpu" and (
        devices[0].platform.lower() not in ("cpu",)
    ):
        devices = jax.devices("cpu")
    on_accel = devices[0].platform != "cpu"
    edge = args.local or (96 if on_accel else 16)
    local_shape = (edge, edge, edge)

    counts = []
    p = 1
    while p <= len(devices):
        counts.append(p)
        p *= 2
    if counts[-1] != len(devices):
        counts.append(len(devices))

    records = []
    base_nnz_s = None
    for p in counts:
        backend = MeshBackend(devices=devices[:p])
        parts = compute_optimal_shape_xyz(p)
        A, b = build_hpcg_problem(local_shape, parts, backend, dtype=np.float32)
        rlay = A.row_layout()
        nnz = A.nnz()

        def make_loop(k):
            @jax.jit
            def run(A, own):
                def body(i, own):
                    x = PVector(
                        own,
                        jnp.zeros((own.shape[0], rlay.n_ghost_pad), jnp.float32),
                        rlay,
                        A.backend,
                    )
                    return spmv(A, x).own * (1.0 / 52.0)

                own = jax.lax.fori_loop(0, k, body, own)
                return jnp.sum(own[:, :8])

            return run

        dt = slope_time_per_iter(make_loop, (A, b.own), k_small=4, k_big=24)
        nnz_s = nnz / dt
        per_dev = nnz_s / p
        if base_nnz_s is None:
            base_nnz_s = per_dev
        eff = per_dev / base_nnz_s
        # on a VIRTUAL (shared-host) mesh all devices share one CPU, so
        # per-device efficiency conflates time-slicing with communication;
        # the flat-total ratio is the meaningful overhead number there
        # (1.0 = the p-way SPMD program moves the grown problem at the
        # single-part rate; the deficit is collective+pack overhead)
        total_ratio = nnz_s / base_nnz_s

        # one CG set for a correctness fence
        @jax.jit
        def one_set(A, b):
            x, norms = hpcg_cg(A, b, iterations=args.iters)
            return norms

        norms = np.asarray(one_set(A, b))
        relres = float(norms[-1] / norms[0])

        rec = {
            "metric": "hpcg27_weak_scaling",
            "devices": p,
            "parts_per_dir": list(parts),
            "local_shape": list(local_shape),
            "global_rows": A.shape[0],
            "nnz": int(nnz),
            "spmv_ms": round(dt * 1e3, 4),
            "gnnz_per_s_per_device": round(per_dev / 1e9, 4),
            "weak_efficiency": round(eff, 4),
            "total_gnnz_per_s": round(nnz_s / 1e9, 4),
            "shared_host_total_ratio": round(total_ratio, 4),
            "cg_relres": relres,
        }
        records.append(rec)
        print(json.dumps(rec), flush=True)
    if args.out:
        shared = devices[0].platform.lower() == "cpu"
        note = (
            "weak scaling, constant work per device; efficiency = "
            "per-device nnz/s vs 1 device."
        )
        if shared:
            note += (
                "  VIRTUAL CPU MESH: all devices time-slice ONE host CPU "
                "and every loop iteration pays the XLA-CPU cross-device "
                "rendezvous, so neither column reflects device interconnect scaling — "
                "the artifact tracks ROUND-OVER-ROUND regressions of the "
                "exchange-plan/shard_map overhead (see bench_overlap.py "
                "for the measured compute/exchange overlap on this mesh)."
            )
        with open(args.out, "w") as f:
            json.dump(
                {
                    "platform": devices[0].platform,
                    "shared_host_mesh": shared,
                    "note": note,
                    "records": records,
                },
                f,
                indent=1,
            )


if __name__ == "__main__":
    main()
