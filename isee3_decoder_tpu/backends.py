"""Per-platform defaults and the persistent compile cache.

This is the one place that reads ``jax.default_backend()``.  Every
setting whose best value differs between XLA's CPU backend and the GPU
lives in ``PLATFORM_DEFAULTS``, keyed by the backend name.  A platform
without an entry is an error, not a silent fallback: its values have
not been measured.
"""

from __future__ import annotations

import dataclasses
import os
from pathlib import Path

import jax

#: compile cache used when JAX_COMPILATION_CACHE_DIR is not set: a fixed
#: directory in the checkout (the cache key includes the path, so a
#: directory that moves never hits)
DEFAULT_CACHE_DIR = Path(__file__).resolve().parents[1] / "build" / "jax_cache"


@dataclasses.dataclass(frozen=True)
class PlatformDefaults:
    #: Fano walk micro-steps per while_loop iteration (ops/fano.py).
    fano_unroll: int


PLATFORM_DEFAULTS: dict[str, PlatformDefaults] = {
    # XLA's CPU backend fails to alias the register-carried walk's tape
    # across unrolled steps: compile and run time grow super-linearly
    # with the unroll (0.7/1.1/4.0/>500 s compile at 1/2/4/8 under x64).
    "cpu": PlatformDefaults(fano_unroll=2),
    # NVIDIA H100 80GB HBM3 at 700 W, tier-2 walk alone, 256 lanes x
    # 1024 bits: 20.9/14.8/11.6/10.8 us per forward look and 0.7/0.3/
    # 2.8/4.7 s compile at unroll 1/2/4/8.  The whole chain was timed
    # and compiled at 2 only, so 2 stays until it is timed at 8.
    "gpu": PlatformDefaults(fano_unroll=2),
}


def defaults(platform: str | None = None) -> PlatformDefaults:
    """The defaults for ``platform`` (default: JAX's default backend)."""
    platform = platform or jax.default_backend()
    try:
        return PLATFORM_DEFAULTS[platform]
    except KeyError:
        raise ValueError(
            f"no measured defaults for platform {platform!r}"
            f" (known: {sorted(PLATFORM_DEFAULTS)})"
        ) from None


def compile_cache_dir() -> str:
    """JAX_COMPILATION_CACHE_DIR when set, else DEFAULT_CACHE_DIR."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or str(DEFAULT_CACHE_DIR)


def enable_compile_cache() -> str:
    """Point JAX's persistent compile cache at compile_cache_dir() and
    cache every program that takes over half a second to compile."""
    path = compile_cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    return path


def card_name_and_power() -> str:
    """``name, power.limit`` of the first GPU as nvidia-smi reports them
    (a card set below its maximum power runs slower under load, so every
    time should be reported beside this), or why it is unavailable."""
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable: {e}"
    lines = out.stdout.strip().splitlines()
    return lines[0] if lines else f"nvidia-smi failed: {out.stderr.strip()}"
