"""Index-reduction helpers built from max/min + compare.

These express argmax / argmin with plain reductions, which makes the
tie-breaking rule explicit — the reference code cares about it (pmdemod.c:292 keeps the *last* maximal bin via '>=', the decode.c
sync search keeps the *first* via '>').
"""

from __future__ import annotations

import jax.numpy as jnp


def argmax_first(x, axis: int = -1):
    """Index of the first maximum along axis (strict '>' update loop)."""
    m = x.max(axis=axis, keepdims=True)
    n = x.shape[axis]
    idx = jnp.arange(n, dtype=jnp.int32)
    shape = [1] * x.ndim
    shape[axis] = n
    idx = idx.reshape(shape)
    big = jnp.int32(n)
    return jnp.where(x == m, idx, big).min(axis=axis).astype(jnp.int32)


def argmax_last(x, axis: int = -1):
    """Index of the last maximum along axis ('>=' update loop)."""
    m = x.max(axis=axis, keepdims=True)
    n = x.shape[axis]
    idx = jnp.arange(n, dtype=jnp.int32)
    shape = [1] * x.ndim
    shape[axis] = n
    idx = idx.reshape(shape)
    return jnp.where(x == m, idx, jnp.int32(-1)).max(axis=axis).astype(jnp.int32)


def argmin_first(x, axis: int = -1):
    """Index of the first minimum along axis (strict '<' update loop)."""
    return argmax_first(-x, axis=axis)
