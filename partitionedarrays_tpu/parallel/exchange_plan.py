"""Static halo-exchange plans compiled into the XLA program.

The reference's per-iteration communication is a sparse neighborhood
exchange: pack → MPI Isend/Irecv per neighbor → unpack, on buffers and
neighbor lists precomputed once (reference: ExchangeGraph + exchange!,
src/primitives.jl:728-1042; MPI impl src/mpi_array.jl:525-614; cache
construction src/p_vector.jl:418-577).

Device translation: the exchange graph is frozen at setup into

- a schedule of **edge-colored ``ppermute`` rounds**: the directed neighbor
  graph is edge-colored so that within a round every part sends to at most
  one part and receives from at most one part; each round is then a single
  ``lax.ppermute`` over the ``"parts"`` mesh axis (pure ICI neighbor
  traffic, overlappable with compute by XLA), and
- **padded static index tables** (int32, one row per part) for pack
  (gather) and unpack (scatter-add / scatter-set), replacing the
  reference's JaggedArray wire buffers with fixed shapes under ``jit``.

Out-of-range sentinel indices make padding lanes inert:
``jnp.take(..., mode="fill", fill_value=0)`` on pack and
``.at[...].add/set(..., mode="drop")`` on unpack.

Latency hiding: the reference overlaps the halo exchange with the own-block
SpMV via MPI nonblocking + fake-async tasks (src/p_sparse_matrix.jl:
2090-2142).  Here the same overlap is expressed dataflow-style: the rounds
have no data dependency on the own-block compute, so XLA's async collective
scheduler runs them concurrently.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..backends import AXIS
from .p_range import AssemblyGraph, PRange, INT

# any index >= 2**31 - 2**8 is treated as padding (OOB for every buffer)
OOB = np.int32(np.iinfo(np.int32).max - 255)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m if x > 0 else 0


def color_edges(edges: Sequence[Tuple[int, int]]) -> List[int]:
    """Greedy directed edge coloring: within one color, each node has at
    most one outgoing and at most one incoming edge.  Colors used are
    bounded by out-degree + in-degree bounds (König: optimal is the max
    degree; greedy stays within 2Δ-1, fine for a static schedule)."""
    out_used: dict = {}
    in_used: dict = {}
    colors = []
    for (s, d) in edges:
        su = out_used.setdefault(s, set())
        du = in_used.setdefault(d, set())
        c = 0
        while c in su or c in du:
            c += 1
        su.add(c)
        du.add(c)
        colors.append(c)
    return colors


@jax.tree_util.register_pytree_node_class
class ExchangePlan:
    """A compiled one-direction exchange: src-space values -> dst-space.

    Leaves (device arrays, stacked over parts):
      snd_idx[r]: int32[P, K_r]  positions in the source array to pack
      rcv_idx[r]: int32[P, K_r]  positions in the dest array to unpack into
    Static:
      perms[r]: tuple of (src_part, dst_part) pairs for round r
    """

    def __init__(self, perms, snd_idx, rcv_idx):
        self.perms = tuple(tuple(p) for p in perms)
        self.snd_idx = tuple(snd_idx)
        self.rcv_idx = tuple(rcv_idx)

    @property
    def n_rounds(self) -> int:
        return len(self.perms)

    # -- pytree protocol ---------------------------------------------
    def tree_flatten(self):
        return (self.snd_idx, self.rcv_idx), self.perms

    @classmethod
    def tree_unflatten(cls, perms, children):
        snd_idx, rcv_idx = children
        obj = cls.__new__(cls)
        obj.perms = perms
        obj.snd_idx = snd_idx
        obj.rcv_idx = rcv_idx
        return obj

    # -- SPMD apply (call inside backend.spmd; args are per-part slices)
    def apply(self, src_vals: jnp.ndarray, dst_vals: jnp.ndarray, combine: str):
        """Run all rounds.  ``combine``: "add" (assemble) or "set"
        (consistent / insert).

        The rounds are DATA-INDEPENDENT: every round packs from the same
        ``src_vals`` and the received buffers are concatenated and unpacked
        by a single scatter at the end.  This keeps all ``ppermute`` rounds
        free of sequential dependencies so XLA's async scheduler can issue
        them concurrently (with each other and with unrelated compute) —
        the multi-neighbor analogue of the reference's Isend/Irecv-per-
        neighbor + single Waitall (src/mpi_array.jl:539-614).  A chained
        per-round scatter would serialize round r+1 behind round r."""
        if combine not in ("add", "set"):
            raise ValueError(combine)
        if self.n_rounds == 0:
            return dst_vals
        bufs = []
        for r in range(self.n_rounds):
            buf = jnp.take(src_vals, self.snd_idx[r], mode="fill", fill_value=0)
            bufs.append(jax.lax.ppermute(buf, AXIS, perm=self.perms[r]))
        allbuf = jnp.concatenate(bufs, axis=-1) if len(bufs) > 1 else bufs[0]
        allidx = (
            jnp.concatenate(self.rcv_idx, axis=-1)
            if len(self.rcv_idx) > 1
            else self.rcv_idx[0]
        )
        if combine == "add":
            return dst_vals.at[allidx].add(
                allbuf, mode="drop", indices_are_sorted=False, unique_indices=False
            )
        # "set": every destination slot has exactly one source across ALL
        # rounds (one owner per ghost), so the merged scatter stays unique
        return dst_vals.at[allidx].set(allbuf, mode="drop", unique_indices=True)


def _build_plan(
    n_parts: int,
    edges: List[Tuple[int, int]],
    src_lists: List[np.ndarray],
    dst_lists: List[np.ndarray],
) -> ExchangePlan:
    """edges[e] = (src part, dst part); src_lists[e] = positions packed on the
    source; dst_lists[e] = positions unpacked on the destination (same
    order/length as src_lists[e])."""
    colors = color_edges(edges)
    n_rounds = (max(colors) + 1) if colors else 0
    perms: List[List[Tuple[int, int]]] = [[] for _ in range(n_rounds)]
    K = [0] * n_rounds
    for e, c in enumerate(colors):
        perms[c].append(edges[e])
        K[c] = max(K[c], len(src_lists[e]))
    # Complete each partial permutation to a full one (required by the vmap
    # batching rule for ppermute; harmless because every unintended lane is
    # dropped by the OOB unpack indices on the receiver).
    for c in range(n_rounds):
        srcs = {s for (s, _) in perms[c]}
        dsts = {d for (_, d) in perms[c]}
        free_s = [p for p in range(n_parts) if p not in srcs]
        free_d = [p for p in range(n_parts) if p not in dsts]
        perms[c] = perms[c] + list(zip(free_s, free_d))
    K = [_round_up(max(k, 1), 8) for k in K]
    snd = [np.full((n_parts, K[r]), OOB, dtype=np.int32) for r in range(n_rounds)]
    rcv = [np.full((n_parts, K[r]), OOB, dtype=np.int32) for r in range(n_rounds)]
    for e, c in enumerate(colors):
        s, d = edges[e]
        sl = np.asarray(src_lists[e], dtype=np.int32)
        dl = np.asarray(dst_lists[e], dtype=np.int32)
        snd[c][s, : sl.size] = sl
        rcv[c][d, : dl.size] = dl
    return ExchangePlan(
        perms,
        [jnp.asarray(a) for a in snd],
        [jnp.asarray(a) for a in rcv],
    )


def vector_exchange_plans(pr: PRange) -> Tuple[ExchangePlan, ExchangePlan]:
    """(assemble_plan, consistent_plan) for a vector partitioned by ``pr``.

    - assemble: ghost-space values -> scatter-add into own-space
      (parity: assemble!, src/p_vector.jl:583-708)
    - consistent: own-space values -> scatter-set into ghost-space
      (parity: consistent! = assemble! with reversed cache + insert,
      src/p_vector.jl:747-755)
    """
    g: AssemblyGraph = pr.assembly_graph()
    P = pr.n_parts
    edges: List[Tuple[int, int]] = []
    src_lists: List[np.ndarray] = []
    dst_lists: List[np.ndarray] = []
    # assemble direction: j sends its ghost contributions to owner o
    rcv_ptr = [dict() for _ in range(P)]
    for o in range(P):
        for k, src in enumerate(g.neighbors_rcv[o]):
            rcv_ptr[o][src] = g.rcv_own[o][k]
    for j in range(P):
        for k, o in enumerate(g.neighbors_snd[j]):
            edges.append((j, o))
            src_lists.append(g.snd_ghost[j][k])
            dst_lists.append(rcv_ptr[o][j])
    assemble_plan = _build_plan(P, edges, src_lists, dst_lists)
    # consistent direction: reverse every edge, swap index lists
    redges = [(d, s) for (s, d) in edges]
    consistent_plan = _build_plan(P, redges, dst_lists, src_lists)
    return assemble_plan, consistent_plan


def repartition_plan(pr_from: PRange, pr_to: PRange) -> ExchangePlan:
    """Static plan moving OWN values between two partitions of the same
    global range (the device path of ``repartition``; parity: repartition!,
    src/p_vector.jl:1401-1466 — re-designed as a pre-compiled exchange
    instead of a runtime redistribution)."""
    from .p_range import find_owner

    assert pr_from.n_global == pr_to.n_global
    P = pr_from.n_parts
    edges: List[Tuple[int, int]] = []
    src_lists: List[np.ndarray] = []
    dst_lists: List[np.ndarray] = []
    for li_to in pr_to.partition():
        gids = li_to.own_to_global
        owners = find_owner(pr_from.partition(), [gids])[0]
        order = np.argsort(owners, kind="stable")
        owners_s = owners[order]
        cuts = np.flatnonzero(np.diff(owners_s)) + 1
        for grp in np.split(np.arange(owners_s.size), cuts):
            if grp.size == 0:
                continue
            src = int(owners_s[grp[0]])
            g = gids[order[grp]]
            src_pos = pr_from[src].global_to_own(g)
            assert (src_pos >= 0).all()
            edges.append((src, li_to.part))
            src_lists.append(src_pos)
            dst_lists.append(order[grp].astype(np.int64))
    return _build_plan(P, edges, src_lists, dst_lists)


@jax.tree_util.register_pytree_node_class
class VectorLayout:
    """Frozen device-facing layout of a partitioned vector.

    Static aux: padded sizes, backend-independent metadata.
    Leaves: the two exchange plans' index tables + per-part counts.

    The reference analogue is the trio (index_partition, VectorAssemblyCache,
    buffers) built in p_vector_cache (src/p_vector.jl:414-468) — here it is
    all baked at setup and reused by every jitted step.
    """

    def __init__(self, pr: PRange, pad: int = 8):
        self.pr = pr
        P = pr.n_parts
        self.n_parts = P
        n_own = np.array([li.n_own for li in pr.partition()], dtype=np.int64)
        n_ghost = np.array([li.n_ghost for li in pr.partition()], dtype=np.int64)
        self.n_own = n_own
        self.n_ghost = n_ghost
        self.n_own_pad = _round_up(int(n_own.max()) if P else 0, pad)
        self.n_ghost_pad = _round_up(int(n_ghost.max()) if P else 0, pad)
        a_plan, c_plan = vector_exchange_plans(pr)
        self.assemble_plan = a_plan
        self.consistent_plan = c_plan
        self.n_own_dev = jnp.asarray(n_own, dtype=jnp.int32)
        self.n_ghost_dev = jnp.asarray(n_ghost, dtype=jnp.int32)

    # masks computed on the fly (fused by XLA) — per-part versions
    def own_mask(self, n_own_scalar):
        idx = jax.lax.broadcasted_iota(jnp.int32, (self.n_own_pad, 1), 0)[:, 0]
        return idx < n_own_scalar

    # -- pytree ------------------------------------------------------
    def tree_flatten(self):
        leaves = (
            self.assemble_plan,
            self.consistent_plan,
            self.n_own_dev,
            self.n_ghost_dev,
        )
        aux = (self.pr, self.n_parts, self.n_own_pad, self.n_ghost_pad)
        return leaves, aux

    @classmethod
    def tree_unflatten(cls, aux, leaves):
        obj = cls.__new__(cls)
        obj.pr, obj.n_parts, obj.n_own_pad, obj.n_ghost_pad = aux
        (obj.assemble_plan, obj.consistent_plan, obj.n_own_dev, obj.n_ghost_dev) = leaves
        obj.n_own = np.array([li.n_own for li in obj.pr.partition()], dtype=np.int64)
        obj.n_ghost = np.array([li.n_ghost for li in obj.pr.partition()], dtype=np.int64)
        return obj

    def __repr__(self):
        return (
            f"VectorLayout(P={self.n_parts}, n_own_pad={self.n_own_pad}, "
            f"n_ghost_pad={self.n_ghost_pad}, rounds="
            f"{self.assemble_plan.n_rounds})"
        )
