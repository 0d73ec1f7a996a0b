"""Test configuration: run everything on a virtual 8-device CPU mesh.

Tests run on the CPU backend with 8 virtual devices so multi-card
sharding paths compile and execute without a GPU (SURVEY.md §4).  x64 is
enabled so host-side golden computations (metric tables, encoder state
arithmetic for K>31 codes) match the C reference's double/long math.
"""

import os

# The tests run on the CPU whatever the environment selects, so assign
# rather than setdefault.
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    flags = (flags + " --xla_force_host_platform_device_count=8").strip()
if "collective_call_terminate" not in flags:
    # 8 virtual device threads time-share 2 physical cores; on long
    # sharded scans (the K=24 Viterbi: 1024 steps x 4 ppermutes) threads
    # drift apart by more than the default 20s/40s rendezvous watchdog,
    # which then aborts the process.  Raise both timeouts.
    flags += (
        " --xla_cpu_collective_call_warn_stuck_timeout_seconds=600"
        " --xla_cpu_collective_call_terminate_timeout_seconds=1500"
    )
os.environ["XLA_FLAGS"] = flags

import jax
import pytest

from isee3_decoder_tpu.backends import enable_compile_cache

# jax may have been imported (and its config read from the environment)
# before this file ran, so update the live config too.
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

# Persistent on-disk compilation cache: the suite compiles hundreds of
# programs (several big fused-chain ones); repeat runs skip nearly all
# of that.  Orthogonal to the per-module jax.clear_caches() below,
# which frees the in-memory executables.
enable_compile_cache()


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_per_module():
    """Free compiled executables between modules.

    A full-suite process accumulates every module's jitted programs; the
    XLA CPU JIT has been observed to segfault compiling the large fused
    receive-chain program only after ~45 prior tests' compilations.
    Dropping caches at module boundaries keeps the process footprint
    bounded (each module recompiles its own programs anyway).
    """
    yield
    jax.clear_caches()
