"""Frame sync: soft syncword correlation and frame verification.

Capability parity with the framing layer of ``decode.c``: the 34-symbol
soft sync correlator swept over a frame of positions (decode.c:162-193),
and the end-of-frame syncword check (decode.c:237-247).  Also provides
the hard-decision 40-bit shift-register matcher of ``framer.c:61-95`` and
the even/odd phase correlators of ``vdecode.c:110-141``.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from isee3_decoder_tpu.ops.reductions import argmax_first
from isee3_decoder_tpu.config import (
    DEFAULT_CODE,
    FRAMEBITS,
    SYNCBITS,
    SYNCWORD,
    CodeSpec,
    sync_vector,
)


def sync_taps(code: CodeSpec = DEFAULT_CODE) -> np.ndarray:
    """±1 correlation taps from the encoded sync vector (decode.c:170-176:
    add the symbol when sync_vector[k] is 1, subtract when 0)."""
    sv = np.asarray(sync_vector(code), np.int32)
    return 2 * sv - 1


@functools.partial(jax.jit, static_argnames=("npos", "code"))
def sync_correlate(
    symbols: jax.Array, npos: int, code: CodeSpec = DEFAULT_CODE
) -> jax.Array:
    """Soft sync correlation at positions 0..npos-1.

    Args:
      symbols: (B, >= npos+SYNCBITS) uint8 offset-binary soft symbols.
      npos: number of candidate start positions (FRAMESYMBOLS in decode.c).

    Returns:
      (B, npos) int32 correlation sums: sum_k ±(sym[i+k] - 128).
    """
    if symbols.ndim == 1:
        symbols = symbols[None, :]
    if symbols.shape[-1] < npos + SYNCBITS - 1:
        raise ValueError(
            f"sync_correlate needs symbols length >= npos + SYNCBITS - 1"
            f" = {npos + SYNCBITS - 1}, got {symbols.shape[-1]}"
        )
    taps = sync_taps(code)  # host-side ±1 — signs bake into adds/subs
    s = symbols.astype(jnp.int32) - 128
    # SYNCBITS static shifted adds instead of a (B, npos, SYNCBITS)
    # window gather: the overlapping static slices fuse into one
    # streaming pass instead of a per-element gather.
    acc = None
    for k in range(SYNCBITS):
        sl = jax.lax.slice_in_dim(s, k, k + npos, axis=1)
        term = sl if taps[k] > 0 else -sl
        acc = term if acc is None else acc + term
    return acc


@functools.partial(jax.jit, static_argnames=("npos", "code"))
def find_sync(
    symbols: jax.Array, npos: int, code: CodeSpec = DEFAULT_CODE
) -> tuple[jax.Array, jax.Array]:
    """Best sync position per channel (decode.c:165-181).

    The reference updates on strict '>', keeping the earliest maximal
    position.  Returns (sync_start, record_sum).
    """
    corr = sync_correlate(symbols, npos, code)
    best = argmax_first(corr, axis=-1)  # strict '>' keeps the earliest
    return best, jnp.take_along_axis(corr, best[:, None], axis=-1)[:, 0]


@jax.jit
def verify_frame(frame_bits: jax.Array) -> jax.Array:
    """True when the decoded frame ends in the 5-byte syncword
    (decode.c:237-247).

    frame_bits: (B, FRAMEBITS) 0/1 bits.  The 40-bit word is compared as
    two 20-bit halves so this works without 64-bit ints enabled.
    """
    last40 = frame_bits[..., -40:].astype(jnp.int32)
    weights = jnp.int32(1) << jnp.arange(19, -1, -1, dtype=jnp.int32)
    hi = (last40[..., :20] * weights).sum(axis=-1)
    lo = (last40[..., 20:] * weights).sum(axis=-1)
    return (hi == (SYNCWORD >> 20)) & (lo == (SYNCWORD & 0xFFFFF))


@jax.jit
def framer_positions(bits: jax.Array) -> jax.Array:
    """Hard framer: positions p where bits[p-39..p] equal the syncword
    (the framer.c:61-95 shift-register match, vectorized).

    bits: (B, N) 0/1; returns (B, N) bool — True at the *last* bit of a
    syncword match.
    """
    if bits.ndim == 1:
        bits = bits[None, :]
    B, N = bits.shape
    sw = jnp.asarray(
        [(SYNCWORD >> (39 - i)) & 1 for i in range(40)], jnp.int32
    )
    x = bits.astype(jnp.int32)
    # match[p] = all(bits[p-39+k] == sw[k])
    eq = jnp.ones((B, N), bool)
    for k in range(40):
        shifted = jnp.roll(x, 39 - k, axis=-1)
        eq = eq & (shifted == sw[k])
    # positions < 39 cannot hold a full word
    eq = eq & (jnp.arange(N) >= 39)
    return eq


@functools.partial(jax.jit, static_argnames=("code",))
def phase_sync_peaks(
    symbols: jax.Array, code: CodeSpec = DEFAULT_CODE
) -> tuple[jax.Array, jax.Array]:
    """Even/odd-phase sync peaks over a frame of soft symbols — the
    automatic symbol-pair phasing detector of vdecode.c:110-141.

    symbols: (B, FRAMESYMBOLS + SYNCBITS) uint8.
    Returns (peak_even, peak_odd): max correlation ending on even/odd
    symbol indices.
    """
    if symbols.ndim == 1:
        symbols = symbols[None, :]
    npos = symbols.shape[-1] - SYNCBITS
    corr = sync_correlate(symbols, npos, code)
    pos = jnp.arange(npos)
    # vdecode indexes the correlation by the symbol at the *end* of the
    # window (symbols + k - 33); ending parity == (start + 33) % 2
    end_parity = (pos + SYNCBITS - 1) % 2
    neg = jnp.int32(-1_000_000)
    even = jnp.where(end_parity[None, :] == 0, corr, neg).max(axis=-1)
    odd = jnp.where(end_parity[None, :] == 1, corr, neg).max(axis=-1)
    return even, odd
