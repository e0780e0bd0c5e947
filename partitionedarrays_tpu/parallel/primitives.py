"""Host-side "array of parts" primitives.

Capability parity with the reference's backend-generic collectives
(src/primitives.jl): map over parts, ``map_main`` (:185-199),
``i_am_main`` (:145), ``getany`` (:29), ``tuple_of_arrays`` (:51-97),
``gather``/``allocate_gather`` (:234-330), ``scatter`` (:357-437),
``multicast`` (:469-561), ``scan`` (:599-628), ``reduction`` (:681-698),
``ExchangeGraph`` + discovery (:728-859), ``exchange`` (:921-1042) and the
fake-async task model (:122-141).

Role: in this framework the per-iteration communication is
compiled into the XLA program (parallel/exchange_plan.py); these
primitives serve the SETUP phase and user-level glue, where all parts are
visible in one host process — so every implementation is the reference's
"sequential fallback" semantics, and graph discovery needs no NBX
algorithm (the graph transpose is computed directly, parity
find_rcv_ids_gather_scatter :826-859).
"""
from __future__ import annotations

from typing import Any, Callable, List, Optional, Sequence, Tuple, Union

import numpy as np

from ..ops.jagged import JaggedArray

MAIN = 0


class FakeTask:
    """Runs its thunk on wait/fetch (parity: FakeTask/@fake_async,
    src/primitives.jl:122-141)."""

    def __init__(self, thunk: Callable[[], Any]):
        self._thunk = thunk
        self._done = False
        self._value = None

    def wait(self):
        if not self._done:
            self._value = self._thunk()
            self._done = True
        return self._value

    fetch = wait


def fake_async(thunk: Callable[[], Any]) -> FakeTask:
    return FakeTask(thunk)


# -- part indexing helpers --------------------------------------------------

def linear_indices(n_parts: int) -> List[int]:
    return list(range(n_parts))


def cartesian_indices(shape: Sequence[int]) -> List[Tuple[int, ...]]:
    idx = np.ndindex(*tuple(shape))
    return list(idx)


def i_am_main(part: int, main: int = MAIN) -> bool:
    return part == main


def getany(parts: Sequence) -> Any:
    """Parity: getany (src/primitives.jl:29)."""
    return parts[0]


def map_parts(f: Callable, *arrays) -> List:
    return [f(*items) for items in zip(*arrays)]


def map_main(f: Callable, *arrays, main: int = MAIN, otherwise=None) -> List:
    """Apply f only on the main part (parity: map_main,
    src/primitives.jl:185-199)."""
    out = []
    for p, items in enumerate(zip(*arrays)):
        if p == main:
            out.append(f(*items))
        else:
            out.append(otherwise(*items) if otherwise else None)
    return out


def tuple_of_arrays(array_of_tuples: Sequence[Tuple]) -> Tuple[List, ...]:
    """Parity: tuple_of_arrays (src/primitives.jl:51-97)."""
    if not array_of_tuples:
        return ()
    k = len(array_of_tuples[0])
    return tuple([t[i] for t in array_of_tuples] for i in range(k))


def array_of_tuples(tuple_of_arrays_: Tuple[Sequence, ...]) -> List[Tuple]:
    return list(zip(*tuple_of_arrays_))


# -- collectives ------------------------------------------------------------

def gather(parts: Sequence, destination: Union[int, str] = MAIN) -> List:
    """Each part's value gathered on the destination part (or on every
    part with destination="all").  Vector payloads gather into a
    JaggedArray (parity: gather, src/primitives.jl:234-330)."""
    values = list(parts)
    vector_payload = all(
        isinstance(v, (np.ndarray, list)) and np.asarray(v).ndim == 1 for v in values
    ) and len(values) > 0 and not np.isscalar(values[0])
    if vector_payload:
        collected = JaggedArray.from_lists([np.asarray(v) for v in values])
    else:
        collected = list(values)
    if destination == "all":
        return [collected.copy() if isinstance(collected, JaggedArray) else list(collected) for _ in values]
    return [
        collected if p == destination else _empty_like_gather(collected)
        for p in range(len(values))
    ]


def _empty_like_gather(collected):
    if isinstance(collected, JaggedArray):
        return JaggedArray(np.zeros(0, collected.data.dtype), np.zeros(1, np.int64))
    return []


def allocate_gather(parts: Sequence, destination=MAIN):
    """Parity: allocate_gather (src/primitives.jl:256-297)."""
    return gather(parts, destination)


def scatter(parts_on_source: Sequence, source: int = MAIN) -> List:
    """The source part holds a list/JaggedArray with one item per part
    (parity: scatter, src/primitives.jl:357-437)."""
    data = parts_on_source[source]
    if isinstance(data, JaggedArray):
        return [data[p].copy() for p in range(len(data))]
    return list(data)


def multicast(parts: Sequence, source: int = MAIN) -> List:
    """Broadcast the source part's value to all parts
    (parity: multicast, src/primitives.jl:469-561)."""
    v = parts[source]
    return [v for _ in parts]


def scan(op: Callable, parts: Sequence, init, type: str = "inclusive") -> List:
    """Per-part prefix reduction (parity: scan, src/primitives.jl:599-628)."""
    assert type in ("inclusive", "exclusive")
    out = []
    acc = init
    for v in parts:
        if type == "exclusive":
            out.append(acc)
            acc = op(acc, v)
        else:
            acc = op(acc, v)
            out.append(acc)
    return out


def reduction(
    op: Callable, parts: Sequence, destination: Union[int, str] = MAIN, init=None
) -> List:
    """Parity: reduction (src/primitives.jl:681-698)."""
    acc = init
    for v in parts:
        acc = v if acc is None else op(acc, v)
    if destination == "all":
        return [acc for _ in parts]
    return [acc if p == destination else None for p in range(len(parts))]


# -- sparse neighborhood exchange ------------------------------------------

class ExchangeGraph:
    """Per-part send/receive neighbor lists (parity: ExchangeGraph,
    src/primitives.jl:728-783)."""

    def __init__(self, snd: Sequence[Sequence[int]], rcv: Optional[Sequence[Sequence[int]]] = None):
        self.snd = [list(s) for s in snd]
        if rcv is None:
            rcv = find_rcv_ids(self.snd)
        self.rcv = [list(r) for r in rcv]

    @property
    def n_parts(self) -> int:
        return len(self.snd)

    def reverse(self) -> "ExchangeGraph":
        """Parity: Base.reverse (src/primitives.jl:741)."""
        return ExchangeGraph(self.rcv, self.snd)

    def __repr__(self):
        return f"ExchangeGraph(P={self.n_parts})"


def find_rcv_ids(snd: Sequence[Sequence[int]]) -> List[List[int]]:
    """Transpose of the communication graph.  Host-global, so the direct
    computation replaces both the centralized (primitives.jl:826-859) and
    the NBX (mpi_array.jl:640-680) discovery algorithms."""
    P = len(snd)
    rcv: List[List[int]] = [[] for _ in range(P)]
    for i, dests in enumerate(snd):
        for d in dests:
            rcv[d].append(i)
    return rcv


def is_consistent(graph: ExchangeGraph) -> bool:
    """Parity: is_consistent (src/primitives.jl:861-874)."""
    expect = find_rcv_ids(graph.snd)
    return all(sorted(a) == sorted(b) for a, b in zip(expect, graph.rcv))


def exchange(
    snd_data: Sequence, graph: ExchangeGraph
) -> FakeTask:
    """snd_data[p] = list of payloads aligned with graph.snd[p]; the task's
    value is rcv_data[p] = list aligned with graph.rcv[p]
    (parity: exchange, src/primitives.jl:921-1042)."""

    def run():
        P = graph.n_parts
        inbox = {p: {} for p in range(P)}
        for p in range(P):
            for k, d in enumerate(graph.snd[p]):
                inbox[d][p] = snd_data[p][k]
        return [
            [inbox[p][src] for src in graph.rcv[p]] for p in range(P)
        ]

    return fake_async(run)


# parity aliases: emit == multicast (deprecated reference name), and both
# graph-transpose discovery algorithms collapse to the host-global transpose
emit = multicast
allocate_emit = multicast
find_rcv_ids_gather_scatter = find_rcv_ids
find_rcv_ids_ibarrier = find_rcv_ids


def allocate_exchange(graph: ExchangeGraph, lengths_snd: Sequence[Sequence[int]]):
    """Preallocated receive buffers (parity: allocate_exchange,
    src/primitives.jl:945-1002)."""
    t = exchange(
        [[np.int64(l) for l in ls] for ls in lengths_snd], graph
    )
    lens = t.wait()
    return [
        [np.zeros(int(l)) for l in part_lens] for part_lens in lens
    ]


def host_consistent(pr, own_parts: Sequence[np.ndarray]) -> List[np.ndarray]:
    """Setup-tier halo exchange on HOST numpy arrays: returns per-part ghost
    values filled from the owners' own values (the consistent! direction of
    the assembly graph, src/p_vector.jl:747-755).  Only neighbor data moves
    — used by setup algorithms (e.g. the AMG power method) that must not
    build global vectors or touch the device."""
    g = pr.assembly_graph()
    P = pr.n_parts
    ghosts = [
        np.zeros(li.n_ghost, dtype=np.asarray(own_parts[p]).dtype)
        for p, li in enumerate(pr.partition())
    ]
    for o in range(P):
        for k, dst in enumerate(g.neighbors_rcv[o]):
            payload = np.asarray(own_parts[o])[g.rcv_own[o][k]]
            # find the matching ghost slot list on the receiver
            j = g.neighbors_snd[dst].index(o)
            ghosts[dst][g.snd_ghost[dst][j]] = payload
    return ghosts


def allocate_scatter(parts_on_source, source: int = MAIN):
    """Parity: allocate_scatter (src/primitives.jl:357-437) — the
    allocate/fill split is a host-tier convenience here (device buffers
    are statically planned), so allocation just runs the op."""
    return scatter(parts_on_source, source)


def allocate_multicast(parts, source: int = MAIN):
    """Parity: allocate_multicast (src/primitives.jl:469-561)."""
    return multicast(parts, source)
