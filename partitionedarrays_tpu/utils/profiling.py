"""Profiling / tracing helpers.

The reference's observability layer is PTimer plus "gather per-rank
timings" (src/p_timer.jl; docs/src/usage.md Benchmarking).  On a device
the meaningful tool is the XLA profiler: these helpers wrap ``jax.profiler``
so users can capture device traces of solver runs and annotate phases.
"""
from __future__ import annotations

import contextlib
from typing import Iterator, Optional


@contextlib.contextmanager
def trace(log_dir: str = "/tmp/partitionedarrays_tpu_trace") -> Iterator[None]:
    """Capture a device trace viewable in TensorBoard/Perfetto."""
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """Named region in the trace (shows up around the enclosed dispatches)."""
    import jax

    with jax.profiler.TraceAnnotation(name):
        yield


def device_memory_stats() -> Optional[dict]:
    import jax

    dev = jax.devices()[0]
    if hasattr(dev, "memory_stats"):
        try:
            return dev.memory_stats()
        except Exception:
            return None
    return None
