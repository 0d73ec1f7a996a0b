"""Lightweight tracing/profiling utilities.

Parity with the reference's measurement machinery (SURVEY.md §5.1):
getrusage-style wall/CPU timing around decode calls (vtest224.c:115-120),
bits-per-second reporting, and Fano cycle accounting — plus optional
jax.profiler trace capture for XLA-level inspection.

The ``sync`` helper exists because asynchronous dispatch makes naive
wall timing meaningless: it blocks until x is computed.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field

import jax
import numpy as np


def sync(x):
    """Block until every array in x is computed; returns x."""
    return jax.block_until_ready(x)


@dataclass
class Timer:
    """Accumulating section timer (the rusage pattern, vtest224.c)."""

    sections: dict = field(default_factory=dict)

    @contextlib.contextmanager
    def section(self, name: str, sync_on=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync_on is not None:
                sync(sync_on)
            self.sections[name] = self.sections.get(name, 0.0) + (
                time.perf_counter() - t0
            )

    def report(self) -> str:
        total = sum(self.sections.values())
        lines = [f"total {total:.3f}s"]
        for k, v in sorted(self.sections.items(), key=lambda kv: -kv[1]):
            lines.append(f"  {k:<24} {v:8.3f}s {100*v/max(total,1e-12):5.1f}%")
        return "\n".join(lines)

    def bits_per_second(self, name: str, bits: int) -> float:
        """decoder-speed reporting (vtest224.c:180-182)."""
        return bits / max(self.sections.get(name, 0.0), 1e-12)


@contextlib.contextmanager
def xla_trace(logdir: str):
    """Capture a jax.profiler trace for offline viewing (best effort)."""
    try:
        jax.profiler.start_trace(logdir)
        started = True
    except Exception:
        started = False
    try:
        yield
    finally:
        if started:
            try:
                jax.profiler.stop_trace()
            except Exception:
                pass


def cycle_histogram(cycles: np.ndarray, nbits: int, nbuckets: int = 8) -> dict:
    """Fano cycles-per-bit histogram (the fanotest.c:178-179 cost metric)."""
    per_bit = np.asarray(cycles, np.float64) / nbits
    edges = [1, 1.5, 2, 3, 5, 10, 25, 50, 1e9][: nbuckets + 1]
    out = {}
    for lo, hi in zip(edges[:-1], edges[1:]):
        out[f"[{lo},{hi})"] = int(((per_bit >= lo) & (per_bit < hi)).sum())
    return out
