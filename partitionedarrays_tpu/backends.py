"""SPMD backend abstraction: one program, three execution modes.

The reference's single most important design decision is its L1 backend
abstraction (serial Vector / DebugArray / MPIArray — reference:
src/debug_array.jl, src/mpi_array.jl, selected via with_debug/with_mpi).
Here: all per-part algorithm code is written once as an
SPMD function over *per-part* array slices, using named-axis collectives
(``psum``/``ppermute``/``all_to_all``/``all_gather`` over axis ``"parts"``),
and is executed through one of two mechanically equivalent drivers:

- **SerialBackend** ("debug" analogue): ``jax.vmap(f, axis_name="parts")``
  over a stacked leading part axis — all parts on ONE device, collectives
  become index shuffles.  Bit-identical semantics to the mesh run, usable on
  CPU and on a single GPU.
- **MeshBackend** (the distributed path): ``jax.shard_map`` over a
  ``jax.sharding.Mesh`` axis ``"parts"`` — one part per device, collectives
  are real XLA collectives (NCCL between GPUs).

Convention: every array leaf entering/leaving a backend-run function carries
a leading part axis of length ``n_parts``; per-part code sees the slice
without that axis.
"""
from __future__ import annotations

import functools
from typing import Callable, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec

AXIS = "parts"


class Backend:
    """Base: drives SPMD per-part functions over stacked part arrays."""

    kind: str
    n_parts: int

    def spmd(self, f: Callable) -> Callable:
        raise NotImplementedError

    def device_context(self):
        """Context manager pinning eager/jit device builds to THIS
        backend's devices.  Matters when the process default platform
        (a GPU) is not where the mesh lives (a virtual CPU mesh): without
        the pin, every setup-time ``jax.jit`` build would compile and run
        on the default platform."""
        import contextlib

        return contextlib.nullcontext()

    def spmd_cached(self, key, make_f: Callable[[], Callable]) -> Callable:
        """Memoized, jitted SPMD wrapper.

        Library entry points create closures per call; without caching,
        every *eager* invocation would rebuild (and recompile) the mapped
        computation.  ``key`` must capture everything static the closure
        bakes in (objects hash by identity and are kept alive by the
        cache).  Under an outer jit the wrapper is inlined as usual.
        """
        cache = getattr(self, "_spmd_cache", None)
        if cache is None:
            cache = {}
            self._spmd_cache = cache
        fn = cache.get(key)
        if fn is None:
            fn = jax.jit(self.spmd(make_f()))
            cache[key] = fn
        return fn

    def shard(self, tree):
        """Place stacked arrays on the backend's devices (no-op on serial;
        lazy per-part providers — see MeshBackend.shard — are materialized
        in full here)."""
        return jax.tree.map(_resolve_provider, tree)

    def axis_name(self) -> str:
        return AXIS


def _resolve_provider(x):
    """Materialize the lazy per-part provider protocol eagerly (single
    process: every part is local anyway)."""
    if not callable(x):
        return x
    shape, dtype, provider = x()
    P = shape[0]
    out = np.empty(shape, dtype=dtype)
    for p in range(P):
        idx = (slice(p, p + 1),) + tuple(slice(None) for _ in shape[1:])
        out[p] = np.asarray(provider(idx), dtype=dtype)[0]
    return jnp.asarray(out)


class SerialBackend(Backend):
    kind = "serial"

    def local_parts(self):
        """All parts live in this (single) process."""
        return list(range(self.n_parts))

    def __init__(self, n_parts: int):
        self.n_parts = int(n_parts)
        from . import config

        config.enable_compilation_cache()

    def spmd(self, f: Callable) -> Callable:
        return jax.vmap(f, axis_name=AXIS)

    def __repr__(self):
        return f"SerialBackend(n_parts={self.n_parts})"


class MeshBackend(Backend):
    kind = "mesh"

    def __init__(self, mesh: Optional[Mesh] = None, devices=None):
        if mesh is None:
            devices = np.array(devices if devices is not None else jax.devices())
            mesh = Mesh(devices, (AXIS,))
        self.mesh = mesh
        self.n_parts = mesh.shape[AXIS]
        # If the mesh lives on a different platform than the process
        # default (a virtual CPU mesh in a process whose default is the
        # GPU), pin the default device to the mesh's platform: otherwise
        # every setup-time jnp/jit build would compile and run on the
        # default platform and be copied across afterwards.
        me = jax.process_index()
        first_local = next(
            (d for d in self.mesh.devices.flat if d.process_index == me), None
        )
        if (
            first_local is not None
            and first_local.platform != jax.default_backend()
        ):
            jax.config.update("jax_default_device", first_local)
        from . import config

        config.enable_compilation_cache()

    def spmd(self, f: Callable) -> Callable:
        spec = PartitionSpec(AXIS)

        def per_shard(*args):
            sliced = jax.tree.map(lambda x: x[0], args)
            out = f(*sliced)
            return jax.tree.map(lambda x: jnp.asarray(x)[None], out)

        fn = jax.shard_map(
            per_shard,
            mesh=self.mesh,
            in_specs=spec,
            out_specs=spec,
            check_vma=False,
        )
        return fn

    def device_context(self):
        me = jax.process_index()
        for d in self.mesh.devices.flat:
            if d.process_index == me:
                return jax.default_device(d)
        import contextlib

        return contextlib.nullcontext()

    @property
    def is_multiprocess(self) -> bool:
        """True when the mesh spans more than one host process (the
        reference's MPI tier; here: multi-controller JAX)."""
        procs = {d.process_index for d in self.mesh.devices.flat}
        return len(procs) > 1

    def local_parts(self):
        """Part indices whose device belongs to THIS process.  Per-process
        construction (the analogue of the reference's one-item-per-rank
        MPIArray, src/mpi_array.jl:105-117) only needs to materialize
        values for these parts."""
        me = jax.process_index()
        return [
            p
            for p, d in enumerate(self.mesh.devices.flat)
            if d.process_index == me
        ]

    def shard(self, tree):
        sharding = NamedSharding(self.mesh, PartitionSpec(AXIS))
        if not self.is_multiprocess:
            return jax.tree.map(
                lambda x: jax.device_put(_resolve_provider(x), sharding), tree
            )

        # multi-process: each process materializes ONLY its addressable
        # shards.  The callback receives the index of one shard; lazy
        # per-part providers (callables) are invoked per requested part,
        # so non-local parts' values are never built on this host.
        def put(x):
            if callable(x):
                shape, dtype, provider = x()
                return jax.make_array_from_callback(
                    shape,
                    NamedSharding(self.mesh, PartitionSpec(AXIS)),
                    lambda idx: np.asarray(provider(idx), dtype=dtype),
                )
            if isinstance(x, jax.Array) and not x.is_fully_addressable:
                return x  # already globally sharded
            xh = np.asarray(x)
            return jax.make_array_from_callback(
                xh.shape, sharding, lambda idx: xh[idx]
            )

        return jax.tree.map(put, tree)

    def __repr__(self):
        return f"MeshBackend(n_parts={self.n_parts}, multiprocess={self.is_multiprocess})"


# -- entry points (parity: with_debug src/debug_array.jl:7, with_mpi
#    src/mpi_array.jl:64) ----------------------------------------------------

def serial_backend(n_parts: int) -> SerialBackend:
    return SerialBackend(n_parts)


def mesh_backend(mesh: Optional[Mesh] = None, devices=None) -> MeshBackend:
    return MeshBackend(mesh, devices)


def with_serial(f: Callable, n_parts: int):
    """Run ``f(backend)`` on the serial (debug-analogue) backend."""
    return f(SerialBackend(n_parts))


def with_mesh(f: Callable, mesh: Optional[Mesh] = None):
    """Run ``f(backend)`` on a device-mesh backend."""
    return f(MeshBackend(mesh))


# parity alias: the reference's debug entry point
with_debug = with_serial


def with_multihost(
    f: Callable = None,
    *,
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    local_device_ids: Optional[Sequence[int]] = None,
):
    """Multi-host entry point (the multi-process analogue of the
    reference's ``with_mpi``, src/mpi_array.jl:64-83).

    Initializes ``jax.distributed`` when a coordinator is given (argument
    or ``JAX_COORDINATOR_ADDRESS``; pass ``num_processes`` and
    ``process_id`` with it — on CPU also set
    ``JAX_CPU_COLLECTIVES_IMPLEMENTATION=gloo``) and builds a
    :class:`MeshBackend` over the GLOBAL device set, so the same SPMD
    program spans every process.  With one process per GPU, pass
    ``local_device_ids=[i]`` (or launch with ``CUDA_VISIBLE_DEVICES=i``)
    so that each process opens only its own card: a JAX process reserves
    most of every card it opens.  ``jax.distributed.initialize`` MUST run
    before any backend is touched; import this module first in a fresh
    process.

    Each process then runs the SAME setup code (multi-controller SPMD:
    host setup is deterministic and replicated, device arrays are
    materialized per process only for its addressable shards via
    ``MeshBackend.shard``), and the error/abort semantics of the
    reference's ``with_mpi`` (MPI.Abort on error so no zombie ranks
    survive) map to the JAX distributed runtime's built-in fatal-error
    propagation: an uncaught exception tears down the coordination
    service, which terminates every peer process.

    Use as ``with_multihost(main)`` or ``backend = with_multihost()``.
    """
    import os

    if coordinator_address is not None or "JAX_COORDINATOR_ADDRESS" in os.environ:
        # NOTE: do not query jax.process_count() here — it would
        # initialize the backends before jax.distributed does
        try:
            jax.distributed.initialize(
                coordinator_address=coordinator_address,
                num_processes=num_processes,
                process_id=process_id,
                local_device_ids=local_device_ids,
            )
        except RuntimeError:
            pass  # already initialized
    backend = MeshBackend(devices=jax.devices())
    return f(backend) if f is not None else backend


def stack_parts(parts: Sequence[np.ndarray], pad_to: Optional[int] = None, fill=0):
    """Stack ragged per-part host arrays into one padded [P, n_pad, ...] array."""
    parts = [np.asarray(p) for p in parts]
    n = pad_to if pad_to is not None else max((p.shape[0] for p in parts), default=0)
    trail = parts[0].shape[1:] if parts else ()
    out = np.full((len(parts), n) + trail, fill, dtype=parts[0].dtype if parts else np.float32)
    for i, p in enumerate(parts):
        out[i, : p.shape[0]] = p
    return out
