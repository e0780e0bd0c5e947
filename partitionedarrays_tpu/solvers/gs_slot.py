"""Wave-scheduled tile Gauss-Seidel: the generic (non-banded) GS engine.

Rows are tiled 128 per tile.  Tiles are greedily packed into waves of up
to B=8 mutually-UNCOUPLED tiles (no off-tile nonzero connects two tiles of
the same wave).  A sweep walks the waves in order (a ``lax.fori_loop``, so
the compiled program does not grow with the operator); each wave updates
its B tiles at once:

- OFF-TILE coupling: one batched ELL gather over the wave's tiles (per
  tile row, the off-tile nonzeros as padded column/value lanes), read from
  x as it stood when the wave started — exact, because tiles of one wave
  are uncoupled;
- WITHIN-TILE coupling: exact pointwise GS via dense factors.  Forward
  entries apply ``x_t = (D+L)^{-1} (b_t - y_off - U x_t_old)``, backward the
  mirror, as two batched ``(B,128) x (128,128)`` products at full f32
  precision.  (D+L)^{-1} (lower triangular) and the strict upper triangle
  U are disjoint triangles, so both ride ONE 128x128 plane per tile and
  direction, split by a triangle mask.

The result is an EXACT Gauss-Seidel sweep for the wave-major row ordering
(natural within each 128-row tile).  The hybrid/processor-block
structure is unchanged: one ghost exchange per application, ghost
contributions folded into b (consistent! once per smooth,
smoothers.jl:104-105).

Capability parity: a sequential-within-part Gauss-Seidel in the same role
as the reference's gauss_seidel
(/root/reference/PartitionedSolvers/src/smoothers.jl:82-205) — but NOT in
the reference's natural row order: tiles update in WAVE-MAJOR order.  Any
GS ordering is a valid exact Gauss-Seidel, so smoothing quality is
equivalent, but iterates are not bitwise reference-identical.  The
ordering is exposed via ``schedules`` so validation reproduces the exact
permuted sweep; see docs/design.md.

With ``topo=True`` the schedule is a level schedule, and a zero-guess
forward sweep on a lower-triangular matrix is exactly the forward
substitution (the reverse sweep on an upper-triangular one the backward
substitution): the ILU(0) tier of AdditiveSchwarz.
"""
from __future__ import annotations

from typing import List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.ell import OOB

TILE = 128
# device-memory budget for one engine's arrays (factor planes + entry ELL);
# above it GaussSeidel falls back to its sorted-by-color tier
_MAX_BYTES = 2 << 30


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m if x > 0 else 0


def _wave_schedule(adj, nt: int, B: int, topo: bool = False) -> List[List[int]]:
    """Greedy first-fit capacity-B schedule: tiles in natural order land
    in the first wave with free capacity containing none of their
    neighbors.  Any such assignment yields an exact GS for the wave-major
    ordering (tiles within a wave are mutually uncoupled).

    ``topo=True`` additionally constrains every tile to a wave STRICTLY
    AFTER all its already-placed (lower-index) neighbors — i.e. classic
    level scheduling.  For a triangular matrix this makes the forward
    wave-major sweep from zero guess an EXACT lower-triangular solve
    (and the reverse sweep an exact upper solve): every dependency is
    computed in an earlier wave, every not-yet-needed value is still
    zero."""
    waves: List[List[int]] = []
    wave_sets: List[set] = []
    wave_of = {}
    for t in range(nt):
        at = adj[t]
        start = 0
        if topo:
            placed = [wave_of[s] for s in at if s in wave_of]
            start = max(placed) + 1 if placed else 0
        for w in range(start, len(waves)):
            if len(waves[w]) < B and not (at & wave_sets[w]):
                waves[w].append(t)
                wave_sets[w].add(t)
                wave_of[t] = w
                break
        else:
            waves.append([t])
            wave_sets.append({t})
            wave_of[t] = len(waves) - 1
    return waves


class NaturalTileGS:
    """Sweep state.  Static metadata on the object; device arrays in
    ``arrs`` (a pytree passed through SPMD wrappers — the object itself
    goes in cache keys only).  ``schedules[k]`` lists part k's forward
    wave schedule (real tiles only) so validation can reproduce the
    exact wave-major GS ordering."""

    @classmethod
    def build(
        cls, A, topo: bool = False, directions=("f", "b")
    ) -> Optional["NaturalTileGS"]:
        """``directions``: which sweep directions to pack factors for.
        The triangular-solve use (AdditiveSchwarz ilu0 tier) needs only
        one direction per factor.  Returns None when the arrays would
        exceed the device-memory budget."""
        lay = A.row_layout()
        P = len(A.blocks)
        dtype = np.dtype(A.dtype)
        Rp = _round_up(lay.n_own_pad, TILE)
        nt = Rp // TILE
        local_only = bool(getattr(A, "_local_only", False))
        parts = (
            list(A.backend.local_parts()) if local_only else list(range(P))
        )
        B = min(8, max(nt, 1))

        dense = np.zeros((len(parts), nt, TILE, TILE), dtype)
        offs = []  # per part: off-tile (row, col, val) in CSR order
        schedules: List[List[List[int]]] = []
        K = 0
        for k, p in enumerate(parts):
            oo = A.blocks[p]["oo"].tocsr()
            oo.sort_indices()
            coo = oo.tocoo()
            tr = coo.row // TILE
            tc = coo.col // TILE
            inside = tr == tc
            np.add.at(
                dense[k],
                (tr[inside], coo.row[inside] % TILE, coo.col[inside] % TILE),
                coo.data[inside],
            )
            r, c, v = coo.row[~inside], coo.col[~inside], coo.data[~inside]
            offs.append((r, c, v))
            if r.size:
                K = max(K, int(np.bincount(r).max()))
            adj = [set() for _ in range(nt)]
            for a, b_ in set(zip(tr[~inside].tolist(), tc[~inside].tolist())):
                adj[a].add(b_)
                adj[b_].add(a)
            schedules.append(_wave_schedule(adj, nt, B, topo=topo))
        W = max(max((len(s) for s in schedules), default=1), 1)
        # shrink B to the max achieved occupancy: on densely-coupled tile
        # graphs the waves degenerate toward singletons and a fixed B=8
        # would pad the entry arrays up to 8x for nothing
        B = max(max((len(w) for s in schedules for w in s), default=1), 1)
        K = max(K, 1)
        if local_only:
            # cross-process-AGREED dims, so every process compiles
            # identical shapes
            from ..psparse import _agree_max_i32

            W, B, K = (int(d) for d in _agree_max_i32(
                A.backend, np.array([W, B, K], np.int64)
            ))
        n_dir = len(directions)
        nbytes = P * W * B * TILE * (n_dir * TILE * dtype.itemsize + K * (4 + dtype.itemsize))
        if nbytes > _MAX_BYTES:
            return None

        # identity on empty-diagonal (padding) rows so the factors exist
        di = np.arange(TILE)
        dvals = dense[:, :, di, di]
        dense[:, :, di, di] = np.where(dvals == 0, 1.0, dvals)
        # triangular factors (batched host inverses), stored TRANSPOSED
        # (the sweep computes row @ M^T) and PACKED:
        # fwd plane = (D+L)^{-T} (upper incl diag) + U^T (strict lower);
        # bwd plane = (D+U)^{-T} (lower incl diag) + L^T (strict upper).
        packs = {}
        if "f" in directions:
            packs["f"] = np.swapaxes(
                np.linalg.inv(np.tril(dense)) + np.triu(dense, 1), -1, -2
            ).astype(dtype)
        if "b" in directions:
            packs["b"] = np.swapaxes(
                np.linalg.inv(np.triu(dense)) + np.tril(dense, -1), -1, -2
            ).astype(dtype)

        # entry-order arrays, wave-major; padding entries target the spare
        # tile nt (never real x) with zero factors and no off-tile lanes
        nparts = len(parts)
        tid = np.full((nparts, W, B), nt, np.int32)
        ecols = np.full((nparts, W, B, TILE, K), OOB, np.int32)
        evals = np.zeros((nparts, W, B, TILE, K), dtype)
        dpack = np.zeros((nparts, n_dir, W, B, TILE, TILE), dtype)
        for k in range(nparts):
            r, c, v = offs[k]
            # lane of each off-tile nonzero within its row (CSR order)
            lane = np.arange(r.size) - np.searchsorted(r, r)
            slot_of = np.full((nt,), -1, np.int64)
            for w, wave in enumerate(schedules[k]):
                for j, t in enumerate(wave):
                    tid[k, w, j] = t
                    slot_of[t] = w * B + j
                    for d, dname in enumerate(directions):
                        dpack[k, d, w, j] = packs[dname][k, t]
            e = slot_of[r // TILE]
            ecols[k].reshape(W * B, TILE, K)[e, r % TILE, lane] = c
            evals[k].reshape(W * B, TILE, K)[e, r % TILE, lane] = v

        self = cls.__new__(cls)
        self.Rp = Rp
        self.n_real_tiles = nt
        self.B = B
        self.W = W
        self.K = K
        self.schedules = schedules
        self.parts = parts
        self.directions = tuple(directions)
        shard = A.backend.shard
        stacks = (tid, ecols, evals, dpack)
        if local_only and len(parts) < P:
            # only local shards materialize (lazy provider protocol);
            # non-local parts are never requested on this process
            def lazy(arr, part_of=dict((p, k) for k, p in enumerate(parts))):
                def thunk():
                    def provider(idx):
                        p = idx[0].start if idx[0].start is not None else 0
                        if p in part_of:
                            return np.asarray(arr[part_of[p]])[None]
                        return np.zeros((1,) + arr.shape[1:], arr.dtype)

                    return (P,) + arr.shape[1:], arr.dtype, provider

                return thunk

            self.arrs = tuple(shard(lazy(a)) for a in stacks)
        else:
            self.arrs = tuple(shard(jnp.asarray(a)) for a in stacks)
        return self

    # -- per-part SPMD sweep (inside backend.spmd; ``arrs`` has the part
    # axis stripped by vmap) --------------------------------------------
    def sweeps(self, xo, bo_eff, arrs, dir_seq):
        tid, ecols, evals, dpack = arrs
        n = bo_eff.shape[0]
        rows = self.n_real_tiles + 1  # + the spare tile padding entries write
        xf = jnp.zeros((rows * TILE,), bo_eff.dtype if xo is None else xo.dtype)
        if xo is not None:
            xf = xf.at[: xo.shape[0]].set(xo)
        xf = xf.reshape(rows, TILE)
        bf = jnp.zeros((rows * TILE,), bo_eff.dtype).at[:n].set(bo_eff)
        bf = bf.reshape(rows, TILE)
        r_io, c_io = np.indices((TILE, TILE))
        W = self.W
        hi = jax.lax.Precision.HIGHEST
        for d in dir_seq:
            if d not in self.directions:
                raise ValueError(
                    f"direction {d!r} was not packed "
                    f"(directions={self.directions})"
                )
            slab = dpack[self.directions.index(d)]  # (W, B, 128, 128)
            # the solve factor sits in the upper-incl-diag triangle of the
            # transposed fwd plane, the lower-incl-diag one of the bwd plane
            mask = jnp.asarray(r_io <= c_io if d == "f" else r_io >= c_io)

            def wave(i, xf, d=d, slab=slab, mask=mask):
                w = i if d == "f" else W - 1 - i
                t = tid[w]  # (B,)
                g = jnp.take(xf.reshape(-1), ecols[w], mode="fill", fill_value=0)
                y = jnp.sum(g * evals[w], axis=-1)  # (B, 128) off-tile rows
                pp = slab[w]
                m1 = jnp.where(mask, pp, 0)  # M^T blocks (solve factors)
                m2 = pp - m1  # strict-triangle^T blocks (old-x coupling)
                contrib = jnp.einsum("bi,bij->bj", xf[t], m2, precision=hi)
                rhs = bf[t] - y - contrib
                x_new = jnp.einsum("bi,bij->bj", rhs, m1, precision=hi)
                return xf.at[t].set(x_new)

            xf = jax.lax.fori_loop(0, W, wave, xf)
        return xf.reshape(-1)[:n]
