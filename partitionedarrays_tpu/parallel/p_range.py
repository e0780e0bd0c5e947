"""Index partitioning: the ownership model of the framework.

A global index range ``0..n-1`` is split into ``P`` parts.  Each part sees
three index spaces (reference notation, src/p_range.jl:1-30):

- **own**:    global indices owned by this part,
- **ghost**:  off-part global indices this part also stores locally,
- **local**:  own + ghost, in a part-specific order (optionally permuted).

Capability parity with the reference's ``AbstractLocalIndices`` /
``PRange`` layer (src/p_range.jl): the 16 index maps (:77-160), ghost
editing (:199-259), ``find_owner`` (:346), assembly graph + cache
(:354-531), and the partition constructors ``uniform_partition`` (:585),
``variable_partition`` (:705), ``partition_from_color`` (:751),
``trivial_partition`` (:774), ``renumber_partition`` (:782),
``local_range`` (:806-818).

Design: this layer is **pure host-side numpy** and runs only at
setup time.  Everything the compiled program needs (pack/unpack index
tables, padded buffer sizes, neighbor rounds) is derived from these objects
once and frozen into static device arrays (see exchange_plan.py).  Unlike
the reference there is no runtime neighbor discovery (NBX etc.): the full
partition is visible on host, so the communication graph is computed
globally and baked into the program.

All indices are 0-based.  Negative index = "skip" marker (reference uses
ids < 1).
"""
from __future__ import annotations

import numpy as np
from typing import Callable, List, Optional, Sequence, Tuple, Union

INT = np.int64


# ---------------------------------------------------------------------------
# small helpers
# ---------------------------------------------------------------------------

def _as1d(x, dtype=INT) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(x, dtype=dtype).ravel())


class GlobalLookup:
    """Vectorized global-id -> position lookup over an arbitrary id set.

    Positions are 0..len(gids)-1; queries not in the set map to -1.
    (Parity: VectorFromDict / GlobalToLocal, src/p_range.jl:834-859.)
    """

    def __init__(self, gids: np.ndarray):
        self.gids = _as1d(gids)
        n = self.gids.size
        # fast paths: contiguous ranges (ubiquitous for own ids) avoid any
        # sort; pre-sorted ids avoid the argsort
        self.contig = bool(
            n > 0
            and self.gids[-1] - self.gids[0] == n - 1
            and np.all(np.diff(self.gids) == 1)
        )
        if self.contig:
            self.start = int(self.gids[0])
            self.order = None
            self.sorted = None
        else:
            if n and np.all(np.diff(self.gids) > 0):
                self.order = None
                self.sorted = self.gids
            else:
                self.order = np.argsort(self.gids, kind="stable")
                self.sorted = self.gids[self.order]

    def __call__(self, queries) -> np.ndarray:
        q = _as1d(queries)
        n = self.gids.size
        if n == 0:
            return np.full(q.shape, -1, dtype=INT)
        if self.contig:
            rel = q - self.start
            out = np.where((rel >= 0) & (rel < n) & (q >= 0), rel, -1)
            return out.astype(INT)
        pos = np.searchsorted(self.sorted, q)
        pos[pos >= n] = n - 1
        hit = self.sorted[pos] == q
        src = pos if self.order is None else self.order[pos]
        out = np.where(hit, src, -1)
        out[q < 0] = -1
        return out.astype(INT)


def local_range(
    p: int, np_parts: int, n: int, ghost: int = 0, periodic: bool = False
) -> range:
    """Block row-range of part ``p`` (0-based) among ``np_parts`` parts of a
    1-D index space of size ``n``, optionally extended by ``ghost`` layers.

    The remainder ``n % np_parts`` is distributed to the *last* parts
    (parity: local_range, src/p_range.jl:806-818; values match
    test/partition_tests.jl:6-15 after the 0-based shift).

    With ``periodic=True`` the range may extend beyond ``[0, n)``; callers
    wrap it modulo ``n``.
    """
    ghost = int(ghost)
    l, rem = divmod(n, np_parts)
    offset = l * p
    if rem >= np_parts - p:
        l += 1
        offset += p - (np_parts - rem)
    start = offset - ghost
    stop = offset + l + ghost
    if periodic:
        return range(start, stop)
    return range(max(0, start), min(n, stop))


def block_owner_1d(np_parts: int, n: int, coords) -> np.ndarray:
    """Inverse of ``local_range``: owner part of each 1-D coordinate.

    O(1) arithmetic, no tables (parity: the lazy BlockPartition owner maps,
    src/p_range.jl:1471-1573).
    """
    c = _as1d(coords)
    l, rem = divmod(n, np_parts)
    cut = (np_parts - rem) * l  # first coordinate of the size-(l+1) blocks
    if l == 0:
        # more parts than entries: first np-rem parts empty... all entries in
        # the last `rem` parts of size 1
        return (np_parts - rem + c).astype(INT)
    small = c // l
    big = (np_parts - rem) + (c - cut) // (l + 1)
    return np.where(c < cut, small, big).astype(INT)


# ---------------------------------------------------------------------------
# LocalIndices
# ---------------------------------------------------------------------------

class LocalIndices:
    """Per-part index metadata: own ids, ghost ids (+owners), optional local
    permutation, optional global owner map.

    ``perm`` (if given) maps local position -> position in
    ``concat(own_to_global, ghost_to_global)``, so
    ``local_to_global = concat(own, ghost)[perm]``.
    (Parity: LocalIndices/OwnAndGhostIndices/PermutedLocalIndices,
    src/p_range.jl:1100-1469.)
    """

    __slots__ = (
        "n_global",
        "part",
        "n_parts",
        "own_to_global",
        "ghost_to_global",
        "ghost_to_owner",
        "perm",
        "global_to_owner",
        "_cache",
    )

    def __init__(
        self,
        n_global: int,
        part: int,
        n_parts: int,
        own_to_global,
        ghost_to_global=(),
        ghost_to_owner=(),
        perm: Optional[np.ndarray] = None,
        global_to_owner: Optional[Callable] = None,
    ):
        self.n_global = int(n_global)
        self.part = int(part)
        self.n_parts = int(n_parts)
        self.own_to_global = _as1d(own_to_global)
        self.ghost_to_global = _as1d(ghost_to_global)
        self.ghost_to_owner = _as1d(ghost_to_owner)
        assert self.ghost_to_global.shape == self.ghost_to_owner.shape
        self.perm = None if perm is None else _as1d(perm)
        self.global_to_owner = global_to_owner
        self._cache = {}

    @classmethod
    def from_local(
        cls,
        n_global: int,
        part: int,
        n_parts: int,
        local_to_global,
        local_to_owner,
        global_to_owner: Optional[Callable] = None,
    ) -> "LocalIndices":
        """Reference-style mixed-order constructor: LocalIndices(n, part,
        local_to_global, local_to_owner) (src/p_range.jl:1100-1210) —
        own and ghost ids interleaved in an arbitrary local order.  Splits
        into own/ghost blocks and records the local permutation."""
        l2g = _as1d(local_to_global)
        l2o = _as1d(local_to_owner)
        is_own = l2o == int(part)
        own_pos = np.flatnonzero(is_own)
        ghost_pos = np.flatnonzero(~is_own)
        # perm maps local position -> position in concat(own, ghost)
        perm = np.empty(l2g.shape[0], dtype=INT)
        perm[own_pos] = np.arange(own_pos.size, dtype=INT)
        perm[ghost_pos] = own_pos.size + np.arange(ghost_pos.size, dtype=INT)
        if np.array_equal(perm, np.arange(l2g.shape[0], dtype=INT)):
            perm = None
        return cls(
            n_global,
            part,
            n_parts,
            l2g[own_pos],
            l2g[ghost_pos],
            l2o[ghost_pos],
            perm=perm,
            global_to_owner=global_to_owner,
        )

    # -- sizes --------------------------------------------------------
    @property
    def n_own(self) -> int:
        return self.own_to_global.shape[0]

    @property
    def n_ghost(self) -> int:
        return self.ghost_to_global.shape[0]

    @property
    def n_local(self) -> int:
        return self.n_own + self.n_ghost

    # -- maps (each returns a numpy array) ----------------------------
    def local_to_global(self) -> np.ndarray:
        cat = np.concatenate([self.own_to_global, self.ghost_to_global])
        return cat if self.perm is None else cat[self.perm]

    def local_to_owner(self) -> np.ndarray:
        cat = np.concatenate(
            [np.full(self.n_own, self.part, dtype=INT), self.ghost_to_owner]
        )
        return cat if self.perm is None else cat[self.perm]

    def own_to_local(self) -> np.ndarray:
        if self.perm is None:
            return np.arange(self.n_own, dtype=INT)
        return self._own_to_local_perm()

    def _own_to_local_perm(self) -> np.ndarray:
        # position of concat-index i in perm
        inv = np.empty(self.n_local, dtype=INT)
        inv[self.perm] = np.arange(self.n_local, dtype=INT)
        return inv[: self.n_own]

    def ghost_to_local(self) -> np.ndarray:
        if self.perm is None:
            return np.arange(self.n_own, self.n_local, dtype=INT)
        inv = np.empty(self.n_local, dtype=INT)
        inv[self.perm] = np.arange(self.n_local, dtype=INT)
        return inv[self.n_own :]

    def local_to_own(self) -> np.ndarray:
        """Own position of each local index; -1 for ghosts
        (parity: LocalToOwn, src/p_range.jl:1000-1015 with 0 -> -1)."""
        cat = np.concatenate(
            [
                np.arange(self.n_own, dtype=INT),
                np.full(self.n_ghost, -1, dtype=INT),
            ]
        )
        return cat if self.perm is None else cat[self.perm]

    def local_to_ghost(self) -> np.ndarray:
        cat = np.concatenate(
            [
                np.full(self.n_own, -1, dtype=INT),
                np.arange(self.n_ghost, dtype=INT),
            ]
        )
        return cat if self.perm is None else cat[self.perm]

    def own_to_owner(self) -> np.ndarray:
        return np.full(self.n_own, self.part, dtype=INT)

    def local_permutation(self) -> np.ndarray:
        """Parity: local_permutation (src/p_range.jl:162-170)."""
        if self.perm is None:
            return np.arange(self.n_local, dtype=INT)
        return self.perm

    # -- global -> * lookups (memoized) -------------------------------
    def _lookup(self, key: str, gids: np.ndarray) -> GlobalLookup:
        lk = self._cache.get(key)
        if lk is None:
            lk = GlobalLookup(gids)
            self._cache[key] = lk
        return lk

    def global_to_own(self, queries) -> np.ndarray:
        return self._lookup("g2own", self.own_to_global)(queries)

    def global_to_ghost(self, queries) -> np.ndarray:
        return self._lookup("g2ghost", self.ghost_to_global)(queries)

    def global_to_local(self, queries) -> np.ndarray:
        own = self.global_to_own(queries)
        ghost = self.global_to_ghost(queries)
        if self.perm is None:
            return np.where(own >= 0, own, np.where(ghost >= 0, ghost + self.n_own, -1))
        inv = np.empty(self.n_local, dtype=INT)
        inv[self.perm] = np.arange(self.n_local, dtype=INT)
        concat_pos = np.where(own >= 0, own, np.where(ghost >= 0, ghost + self.n_own, -1))
        out = np.where(concat_pos >= 0, inv[np.clip(concat_pos, 0, None)], -1)
        return out.astype(INT)

    # -- ghost editing (return new objects; own is shared) ------------
    def replace_ghost(self, gids, owners) -> "LocalIndices":
        """Parity: replace_ghost (src/p_range.jl:199-214). Drops perm."""
        return LocalIndices(
            self.n_global,
            self.part,
            self.n_parts,
            self.own_to_global,
            gids,
            owners,
            perm=None,
            global_to_owner=self.global_to_owner,
        )

    def remove_ghost(self) -> "LocalIndices":
        return self.replace_ghost((), ())

    def filter_ghost(self, gids, owners) -> Tuple[np.ndarray, np.ndarray]:
        """Subset of (gids, owners) that are neither own nor already ghost,
        deduplicated keeping first occurrence
        (parity: filter_ghost, src/p_range.jl:216-238)."""
        gids = _as1d(gids)
        owners = _as1d(owners)
        is_own = self.global_to_own(gids) >= 0
        is_ghost = self.global_to_ghost(gids) >= 0
        new = ~(is_own | is_ghost) & (gids >= 0)
        g = gids[new]
        o = owners[new]
        _, first = np.unique(g, return_index=True)
        first.sort()
        return g[first], o[first]

    def union_ghost(self, gids, owners) -> "LocalIndices":
        """Parity: union_ghost (src/p_range.jl:240-259). Drops perm."""
        g_new, o_new = self.filter_ghost(gids, owners)
        return self.replace_ghost(
            np.concatenate([self.ghost_to_global, g_new]),
            np.concatenate([self.ghost_to_owner, o_new]),
        )

    def __repr__(self):
        return (
            f"LocalIndices(part={self.part}/{self.n_parts}, n_global={self.n_global}, "
            f"n_own={self.n_own}, n_ghost={self.n_ghost})"
        )


# -- module-level accessor functions (reference-parity API names) -----------

def local_to_global(li: LocalIndices) -> np.ndarray:
    return li.local_to_global()


def local_to_owner(li: LocalIndices) -> np.ndarray:
    return li.local_to_owner()


def own_to_global(li: LocalIndices) -> np.ndarray:
    return li.own_to_global


def ghost_to_global(li: LocalIndices) -> np.ndarray:
    return li.ghost_to_global


def ghost_to_owner(li: LocalIndices) -> np.ndarray:
    return li.ghost_to_owner


def own_to_owner(li: LocalIndices) -> np.ndarray:
    return li.own_to_owner()


def own_to_local(li: LocalIndices) -> np.ndarray:
    return li.own_to_local()


def ghost_to_local(li: LocalIndices) -> np.ndarray:
    return li.ghost_to_local()


def local_to_own(li: LocalIndices) -> np.ndarray:
    return li.local_to_own()


def local_to_ghost(li: LocalIndices) -> np.ndarray:
    return li.local_to_ghost()


def global_to_local(li: LocalIndices, q) -> np.ndarray:
    return li.global_to_local(q)


def global_to_own(li: LocalIndices, q) -> np.ndarray:
    return li.global_to_own(q)


def global_to_ghost(li: LocalIndices, q) -> np.ndarray:
    return li.global_to_ghost(q)


def part_id(li: LocalIndices) -> int:
    return li.part


def replace_ghost(li: LocalIndices, gids, owners) -> LocalIndices:
    return li.replace_ghost(gids, owners)


def remove_ghost(li: LocalIndices) -> LocalIndices:
    return li.remove_ghost()


def union_ghost(li: LocalIndices, gids, owners) -> LocalIndices:
    return li.union_ghost(gids, owners)


def matching_local_indices(a: LocalIndices, b: LocalIndices) -> bool:
    """Parity: matching_local_indices (src/p_range.jl:172-188)."""
    if a is b:
        return True
    return np.array_equal(a.local_to_global(), b.local_to_global()) and np.array_equal(
        a.local_to_owner(), b.local_to_owner()
    )


def matching_own_indices(a: LocalIndices, b: LocalIndices) -> bool:
    if a is b:
        return True
    return np.array_equal(a.own_to_global, b.own_to_global)


def matching_ghost_indices(a: LocalIndices, b: LocalIndices) -> bool:
    if a is b:
        return True
    return np.array_equal(a.ghost_to_global, b.ghost_to_global) and np.array_equal(
        a.ghost_to_owner, b.ghost_to_owner
    )


# -- index-space conversion of user id arrays (skip negatives) --------------

def map_global_to_local(gids, li: LocalIndices) -> np.ndarray:
    """Parity: map_global_to_local! (src/p_range.jl:287-308)."""
    return li.global_to_local(gids)


def map_local_to_global(lids, li: LocalIndices) -> np.ndarray:
    lids = _as1d(lids)
    l2g = li.local_to_global()
    out = np.where(lids >= 0, l2g[np.clip(lids, 0, None)], -1)
    return out.astype(INT)


def map_global_to_own(gids, li: LocalIndices) -> np.ndarray:
    return li.global_to_own(gids)


def map_own_to_global(oids, li: LocalIndices) -> np.ndarray:
    oids = _as1d(oids)
    out = np.where(oids >= 0, li.own_to_global[np.clip(oids, 0, None)], -1)
    return out.astype(INT)


def to_local(gids_per_part, partition) -> List[np.ndarray]:
    """Parity: to_local! (src/p_range.jl:266-274)."""
    return [map_global_to_local(g, li) for g, li in zip(gids_per_part, partition)]


def to_global(lids_per_part, partition) -> List[np.ndarray]:
    """Parity: to_global! (src/p_range.jl:276-285)."""
    return [map_local_to_global(l, li) for l, li in zip(lids_per_part, partition)]


# ---------------------------------------------------------------------------
# find_owner
# ---------------------------------------------------------------------------

def find_owner(partition: Sequence[LocalIndices], gids_per_part) -> List[np.ndarray]:
    """Owner part of each queried global id, per part.

    Uses the partition's O(1)/vectorized ``global_to_owner`` when available,
    else a globally assembled owner table (possible because setup is
    host-global).  Parity: find_owner (src/p_range.jl:346-348).
    """
    g2o = None
    for li in partition:
        if li.global_to_owner is not None:
            g2o = li.global_to_owner
            break
    if g2o is None:
        n = partition[0].n_global
        owner = np.empty(n, dtype=INT)
        for li in partition:
            owner[li.own_to_global] = li.part
        g2o = lambda q: owner[_as1d(q)]
    return [np.asarray(g2o(_as1d(g)), dtype=INT) for g in gids_per_part]


# ---------------------------------------------------------------------------
# PRange + assembly graph
# ---------------------------------------------------------------------------

class AssemblyGraph:
    """Static assembly communication graph + per-neighbor index lists.

    Direction convention = the reference's ``assemble!`` direction
    (src/p_range.jl:403-531): part ``j`` SENDS the contributions sitting in
    its ghost rows to their owners, and RECEIVES contributions into its own
    rows.  ``consistent!`` uses the reversed graph.

    - neighbors_snd[j]: list of destination parts
    - snd_ghost[j][k]:  ghost-local positions on j sent to neighbors_snd[j][k]
                        (sorted by global id within each destination)
    - neighbors_rcv[j]: list of source parts
    - rcv_own[j][k]:    own-local positions on j where data from
                        neighbors_rcv[j][k] lands, in the sender's order
    """

    def __init__(self, partition: Sequence[LocalIndices]):
        P = len(partition)
        self.neighbors_snd: List[List[int]] = [[] for _ in range(P)]
        self.neighbors_rcv: List[List[int]] = [[] for _ in range(P)]
        self.snd_ghost: List[List[np.ndarray]] = [[] for _ in range(P)]
        self.rcv_own: List[List[np.ndarray]] = [[] for _ in range(P)]

        # sender side: group ghosts by owner, sort by global id inside group
        pending: List[List[Tuple[int, np.ndarray]]] = [[] for _ in range(P)]
        for j, li in enumerate(partition):
            if li.n_ghost == 0:
                continue
            owners = li.ghost_to_owner
            gids = li.ghost_to_global
            order = np.lexsort((gids, owners))
            owners_s = owners[order]
            cuts = np.flatnonzero(np.diff(owners_s)) + 1
            groups = np.split(np.arange(owners_s.size), cuts)
            for grp in groups:
                o = int(owners_s[grp[0]])
                ghost_pos = order[grp]  # ghost-local positions, sorted by gid
                self.neighbors_snd[j].append(o)
                self.snd_ghost[j].append(ghost_pos.astype(INT))
                pending[o].append((j, gids[order[grp]]))

        # receiver side: map sender's global ids to own positions
        for o in range(P):
            li = partition[o]
            for (src, sent_gids) in sorted(pending[o], key=lambda t: t[0]):
                pos = li.global_to_own(sent_gids)
                assert (pos >= 0).all(), "assembly graph: received non-own id"
                self.neighbors_rcv[o].append(src)
                self.rcv_own[o].append(pos.astype(INT))


class PRange:
    """A partitioned global range ``0..n_global-1``
    (parity: PRange, src/p_range.jl:1776-1843).
    """

    def __init__(self, partition: Sequence[LocalIndices]):
        self._partition = list(partition)
        self.n_global = self._partition[0].n_global
        self._assembly_graph: Optional[AssemblyGraph] = None

    @property
    def n_parts(self) -> int:
        return len(self._partition)

    def partition(self) -> List[LocalIndices]:
        return self._partition

    def __len__(self) -> int:
        return self.n_global

    def __getitem__(self, p: int) -> LocalIndices:
        return self._partition[p]

    def __iter__(self):
        return iter(self._partition)

    def assembly_graph(self) -> AssemblyGraph:
        """Memoized (parity: AssemblyCache, src/p_range.jl:354-387)."""
        if self._assembly_graph is None:
            self._assembly_graph = AssemblyGraph(self._partition)
        return self._assembly_graph

    def __repr__(self):
        return f"PRange(n_global={self.n_global}, n_parts={self.n_parts})"


def partition(pr: PRange) -> List[LocalIndices]:
    return pr.partition()


def assembly_neighbors(partition_or_prange) -> Tuple[List[List[int]], List[List[int]]]:
    """(snd, rcv) neighbor lists per part
    (parity: assembly_neighbors, src/p_range.jl:403-450)."""
    pr = (
        partition_or_prange
        if isinstance(partition_or_prange, PRange)
        else PRange(partition_or_prange)
    )
    g = pr.assembly_graph()
    return g.neighbors_snd, g.neighbors_rcv


# ---------------------------------------------------------------------------
# partition constructors
# ---------------------------------------------------------------------------

def _tupled(x, nd: int) -> Tuple[int, ...]:
    if np.isscalar(x) or isinstance(x, (bool, int)):
        return tuple(int(x) for _ in range(nd))
    t = tuple(int(v) for v in x)
    assert len(t) == nd
    return t


def uniform_partition(
    parts_shape: Union[int, Sequence[int]],
    global_shape: Union[int, Sequence[int]],
    ghost: Union[bool, int, Sequence[int]] = 0,
    periodic: Union[bool, Sequence[bool]] = False,
) -> List[LocalIndices]:
    """N-D Cartesian block partition, optional ghost layers (any thickness)
    and periodicity per dimension.

    Global ids linearize the Cartesian grid in C order (row-major); parts
    linearize ``parts_shape`` in C order as well.  (Parity:
    uniform_partition + block_with_constant_size, src/p_range.jl:585-671;
    the reference uses Julia column-major — only the linearization
    convention differs.)
    """
    if np.isscalar(parts_shape):
        parts_shape = (int(parts_shape),)
    else:
        parts_shape = tuple(int(v) for v in parts_shape)
    nd = len(parts_shape)
    gshape = _tupled(global_shape, nd)
    ghost_t = _tupled(int(ghost), nd) if not isinstance(ghost, (tuple, list)) else _tupled(ghost, nd)
    per_t = tuple(bool(v) for v in (periodic if isinstance(periodic, (tuple, list)) else [periodic] * nd))
    n_global = int(np.prod(gshape))
    P = int(np.prod(parts_shape))

    def g2owner(q):
        q = _as1d(q)
        coords = np.unravel_index(np.clip(q, 0, n_global - 1), gshape)
        oc = [
            block_owner_1d(parts_shape[d], gshape[d], coords[d]) for d in range(nd)
        ]
        own = np.ravel_multi_index(tuple(oc), parts_shape)
        return np.where(q >= 0, own, -1).astype(INT)

    out: List[LocalIndices] = []
    for p in range(P):
        pc = np.unravel_index(p, parts_shape)
        own_ranges = [
            local_range(int(pc[d]), parts_shape[d], gshape[d]) for d in range(nd)
        ]
        box_ranges = [
            local_range(
                int(pc[d]), parts_shape[d], gshape[d], ghost_t[d], per_t[d]
            )
            for d in range(nd)
        ]
        # local box coordinates (possibly out of range if periodic: wrap)
        axes = [np.array(list(r), dtype=INT) for r in box_ranges]
        wrapped = [np.mod(a, gshape[d]) for d, a in enumerate(axes)]
        mesh = np.meshgrid(*wrapped, indexing="ij")
        box_gids = np.ravel_multi_index(tuple(mesh), gshape).ravel()
        # ownership: a box cell is own iff its *unwrapped* coords lie in all
        # own ranges
        own_mask = np.ones(box_gids.shape, dtype=bool)
        umesh = np.meshgrid(*axes, indexing="ij")
        for d in range(nd):
            a = umesh[d].ravel()
            own_mask &= (a >= own_ranges[d].start) & (a < own_ranges[d].stop)
        own_gids = box_gids[own_mask]
        ghost_gids = box_gids[~own_mask]
        ghost_owners = g2owner(ghost_gids)
        # local order = box order (stencil-friendly): build perm
        n_own = own_gids.size
        concat_pos = np.empty(box_gids.size, dtype=INT)
        concat_pos[own_mask] = np.arange(n_own, dtype=INT)
        concat_pos[~own_mask] = n_own + np.arange(box_gids.size - n_own, dtype=INT)
        perm = concat_pos if (ghost_gids.size > 0) else None
        out.append(
            LocalIndices(
                n_global,
                p,
                P,
                own_gids,
                ghost_gids,
                ghost_owners,
                perm=perm,
                global_to_owner=g2owner,
            )
        )
    return out


def variable_partition(
    n_own_per_part: Sequence[int],
    n_global: Optional[int] = None,
) -> List[LocalIndices]:
    """1-D partition into consecutive blocks of the given sizes
    (parity: variable_partition, src/p_range.jl:705-729)."""
    sizes = _as1d(n_own_per_part)
    starts = np.zeros(sizes.size + 1, dtype=INT)
    np.cumsum(sizes, out=starts[1:])
    if n_global is None:
        n_global = int(starts[-1])
    assert starts[-1] == n_global
    P = sizes.size

    def g2owner(q):
        q = _as1d(q)
        own = np.searchsorted(starts, np.clip(q, 0, None), side="right") - 1
        own = np.clip(own, 0, P - 1)
        return np.where(q >= 0, own, -1).astype(INT)

    return [
        LocalIndices(
            n_global,
            p,
            P,
            np.arange(starts[p], starts[p + 1], dtype=INT),
            global_to_owner=g2owner,
        )
        for p in range(P)
    ]


def partition_from_color(
    n_parts: int, global_to_color: np.ndarray
) -> List[LocalIndices]:
    """Arbitrary partition from a (METIS-style) owner color vector
    (parity: partition_from_color, src/p_range.jl:751-766)."""
    color = _as1d(global_to_color)
    n_global = color.size

    def g2owner(q):
        q = _as1d(q)
        return np.where(q >= 0, color[np.clip(q, 0, None)], -1).astype(INT)

    return [
        LocalIndices(
            n_global,
            p,
            n_parts,
            np.flatnonzero(color == p).astype(INT),
            global_to_owner=g2owner,
        )
        for p in range(n_parts)
    ]


def trivial_partition(n_parts: int, n_global: int, main: int = 0) -> List[LocalIndices]:
    """All indices owned by part ``main``
    (parity: trivial_partition, src/p_range.jl:774-780)."""
    sizes = [n_global if p == main else 0 for p in range(n_parts)]
    if main == 0:
        return variable_partition(sizes, n_global)

    def g2owner(q):
        q = _as1d(q)
        return np.where(q >= 0, main, -1).astype(INT)

    return [
        LocalIndices(
            n_global,
            p,
            n_parts,
            np.arange(n_global, dtype=INT) if p == main else (),
            global_to_owner=g2owner,
        )
        for p in range(n_parts)
    ]


# -- small parity helpers ---------------------------------------------------

def own_length(li: LocalIndices) -> int:
    return li.n_own


def ghost_length(li: LocalIndices) -> int:
    return li.n_ghost


def local_length(li: LocalIndices) -> int:
    return li.n_local


def global_length(li: LocalIndices) -> int:
    return li.n_global


def local_permutation(li: LocalIndices) -> np.ndarray:
    return li.local_permutation()


def permute_indices(li: LocalIndices, perm) -> LocalIndices:
    """New LocalIndices with the given local permutation
    (parity: permute_indices / PermutedLocalIndices,
    src/p_range.jl:1372-1469)."""
    return LocalIndices(
        li.n_global, li.part, li.n_parts,
        li.own_to_global, li.ghost_to_global, li.ghost_to_owner,
        perm=_as1d(perm), global_to_owner=li.global_to_owner,
    )


def own_and_ghost_indices(
    n_global: int, part: int, n_parts: int, own_gids, ghost_gids=(),
    ghost_owners=(), global_to_owner=None,
) -> LocalIndices:
    """Parity constructor: OwnAndGhostIndices (src/p_range.jl:1231-1370)."""
    return LocalIndices(
        n_global, part, n_parts, own_gids, ghost_gids, ghost_owners,
        global_to_owner=global_to_owner,
    )


def map_ghost_to_global(ghost_ids, li: LocalIndices) -> np.ndarray:
    g = _as1d(ghost_ids)
    out = np.where(g >= 0, li.ghost_to_global[np.clip(g, 0, None)], -1)
    return out.astype(INT)


def map_global_to_ghost(gids, li: LocalIndices) -> np.ndarray:
    return li.global_to_ghost(gids)


def assembly_local_indices(partition_or_prange):
    """Per-part, per-neighbor local index lists: (snd_neighbors,
    snd_ghost_local_ids, rcv_neighbors, rcv_own_local_ids)
    (parity: assembly_local_indices, src/p_range.jl:466-531; our snd side
    is in ghost-local numbering, matching the split storage)."""
    pr = (
        partition_or_prange
        if isinstance(partition_or_prange, PRange)
        else PRange(partition_or_prange)
    )
    g = pr.assembly_graph()
    return g.neighbors_snd, g.snd_ghost, g.neighbors_rcv, g.rcv_own


def renumber_partition(part: Sequence[LocalIndices]) -> List[LocalIndices]:
    """Relabel global ids so each part's own ids are consecutive
    (parity: renumber_partition, src/p_range.jl:782-804).  Ghosts are kept
    and relabeled accordingly."""
    n_global = part[0].n_global
    new_of_old = np.empty(n_global, dtype=INT)
    owner_of_old = np.empty(n_global, dtype=INT)
    offset = 0
    for li in part:
        k = li.n_own
        new_of_old[li.own_to_global] = np.arange(offset, offset + k, dtype=INT)
        owner_of_old[li.own_to_global] = li.part
        offset += k
    sizes = [li.n_own for li in part]
    base = variable_partition(sizes, n_global)
    out = []
    for li, nb in zip(part, base):
        gg = new_of_old[li.ghost_to_global]
        out.append(nb.replace_ghost(gg, li.ghost_to_owner))
    return out
