"""Test configuration: force an 8-virtual-device CPU platform.

This is the test-tier analogue of the reference's DebugArray/MPI suites
(reference: test/runtests.jl, test/debug_array/, test/mpi_array/): the same
test bodies run on (a) the serial vmap backend and (b) a real 8-device CPU
mesh via shard_map — multi-shard semantics without accelerator hardware.
"""
import os

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")

import jax

# tests run on the CPU even where a GPU is present
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np
import pytest

from partitionedarrays_tpu.backends import MeshBackend, SerialBackend


def pytest_addoption(parser):
    parser.addoption(
        "--runslow",
        action="store_true",
        default=False,
        help="run tests marked slow (full HPCG driver protocols etc.)",
    )


def pytest_collection_modifyitems(config, items):
    """Default run excludes ``slow`` tests so the suite can gate every
    commit in minutes; ``--runslow`` restores the full protocol (the
    reference's CI runs its three jobs unconditionally, but its driver
    shapes are tiny — ours exercise real compiled windows)."""
    if config.getoption("--runslow"):
        return
    skip = pytest.mark.skip(reason="slow: use --runslow")
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip)


@pytest.fixture(params=["serial", "mesh"])
def backend4(request):
    """A 4-part backend of each kind (mesh uses 4 of the 8 CPU devices)."""
    if request.param == "serial":
        return SerialBackend(4)
    return MeshBackend(devices=jax.devices()[:4])


@pytest.fixture(params=["serial", "mesh"])
def backend_factory(request):
    def make(n_parts):
        if request.param == "serial":
            return SerialBackend(n_parts)
        assert n_parts <= len(jax.devices())
        return MeshBackend(devices=jax.devices()[:n_parts])

    return make
