"""Vectorized convolutional encoder.

Capability parity with ``encode.c:17-35``: data bytes are consumed
MSB-first, two symbols (POLY1 then POLY2, each optionally inverted) are
produced per data bit, and the final K-bit encoder state is returned.

The reference is a sequential shift register.  The batched formulation
observes that each output symbol is a binary correlation of the last K
input bits with the generator taps, so a whole frame (and a whole batch of
frames) encodes as K shifted XOR-accumulations — pure elementwise VPU work
with no sequential dependency.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from isee3_decoder_tpu.config import DEFAULT_CODE, CodeSpec


def bytes_to_bits(data: jax.Array) -> jax.Array:
    """Unpack uint8 bytes to bits, MSB first (encode.c:26 bit order)."""
    data = data.astype(jnp.uint8)
    shifts = jnp.arange(7, -1, -1, dtype=jnp.uint8)
    bits = (data[..., :, None] >> shifts) & 1
    return bits.reshape(*data.shape[:-1], data.shape[-1] * 8)


def bits_to_bytes(bits: jax.Array) -> jax.Array:
    """Pack bits (MSB first) into uint8 bytes; inverse of bytes_to_bits."""
    n = bits.shape[-1] // 8
    b = bits.reshape(*bits.shape[:-1], n, 8).astype(jnp.uint8)
    weights = (jnp.uint8(1) << jnp.arange(7, -1, -1, dtype=jnp.uint8))
    return (b * weights).sum(axis=-1).astype(jnp.uint8)


def _poly_taps(poly: int, kb: int) -> tuple[int, ...]:
    """Tap positions (delays) where the polynomial has a 1 bit.

    Bit j of the polynomial multiplies the input bit from j steps ago
    (encstate bit j after the shift at encode.c:27).  ``kb`` is the
    EFFECTIVE width (CodeSpec.kbits): the reference's state is an
    unmasked 64-bit word, so polynomials longer than K (J50) still tap.
    """
    return tuple(j for j in range(kb) if (poly >> j) & 1)


def encode_bits(
    bits: jax.Array,
    encstate: jax.Array | int = 0,
    code: CodeSpec = DEFAULT_CODE,
) -> tuple[jax.Array, jax.Array]:
    """Encode a block of data bits.

    Args:
      bits: (..., nbits) array of 0/1 data bits, transmitted in order.
      encstate: (...,) or scalar starting encoder state (low kbits used;
        bit j holds the input bit from j+1 steps before the block).
        Host ints of any width split exactly; device arrays carry at
        most 32 bits (enough for every code whose kbits <= 32).
      code: static code spec.

    Returns:
      (symbols, final_state): symbols is (..., 2*nbits) uint8 with the
      POLY1 symbol at even indices and POLY2 at odd (encode.c:28-29);
      final_state is the kbits-wide encoder state after the block
      (encode.c:33-34).
    """
    bits = jnp.asarray(bits)
    kb = code.kbits  # effective width — see _poly_taps
    # History bits must be materialized OUTSIDE the jitted core: a host
    # int of arbitrary width (wide codes) can't survive jit's int32
    # scalar conversion.
    if isinstance(encstate, (int, np.integer)):
        hv = int(encstate)
        hist = jnp.asarray(
            np.array([(hv >> j) & 1 for j in range(kb - 2, -1, -1)], np.int32)
        )
        hist = jnp.broadcast_to(hist, (*bits.shape[:-1], kb - 1))
    else:
        if kb > 32:
            raise ValueError(
                f"{code.name}: device-array encstate carries at most 32"
                " bits; pass a host int for wide codes"
            )
        encstate = jnp.asarray(encstate, jnp.int32)
        shifts = jnp.arange(kb - 2, -1, -1, dtype=jnp.int32)
        hist = (encstate[..., None] >> shifts) & 1
        hist = jnp.broadcast_to(hist, (*bits.shape[:-1], kb - 1))
    return _encode_with_hist(bits, hist, code)


@functools.partial(jax.jit, static_argnames=("code",))
def _encode_with_hist(
    bits: jax.Array, hist: jax.Array, code: CodeSpec
) -> tuple[jax.Array, jax.Array]:
    """Jitted encode core: (kb-1)-bit history already unpacked to bits.

    Extended sequence: kb-1 history bits (oldest first), then the
    block's bits.  Window for output t is x[t : t+kb] reversed.
    """
    bits = bits.astype(jnp.int32)
    nbits = bits.shape[-1]
    kb = code.kbits
    x = jnp.concatenate([hist.astype(jnp.int32), bits], axis=-1)

    def correlate(poly: int, flip: int) -> jax.Array:
        acc = jnp.zeros_like(bits)
        for j in _poly_taps(poly, kb):
            # delay j: contribution of input bit from j steps ago
            acc = acc ^ jax.lax.dynamic_slice_in_dim(x, kb - 1 - j, nbits, axis=-1)
        if flip:
            acc = acc ^ 1
        return acc

    s1 = correlate(code.poly1, code.g1flip)
    s2 = correlate(code.poly2, code.g2flip)
    symbols = jnp.stack([s1, s2], axis=-1).reshape(*bits.shape[:-1], 2 * nbits)

    # Final state: last kb input bits, newest in bit 0.  int32 covers
    # every K<=31 code; wider codes need x64 enabled (CPU/test path).
    sdtype = jnp.int32 if kb <= 31 else jnp.int64
    weights = sdtype(1) << jnp.arange(kb, dtype=sdtype)
    tail = jax.lax.dynamic_slice_in_dim(x, x.shape[-1] - kb, kb, axis=-1)
    final_state = (tail[..., ::-1].astype(sdtype) * weights).sum(axis=-1)
    return symbols.astype(jnp.uint8), final_state


def encode_bytes(
    data: jax.Array,
    encstate: jax.Array | int = 0,
    code: CodeSpec = DEFAULT_CODE,
) -> tuple[jax.Array, jax.Array]:
    """Byte-level wrapper matching the reference API (encode.c:17-22)."""
    return encode_bits(bytes_to_bits(data), encstate, code)


def reencode_symbol_errors(
    decoded_bits: jax.Array,
    soft_symbols: jax.Array,
    encstate: jax.Array | int,
    code: CodeSpec = DEFAULT_CODE,
) -> jax.Array:
    """Re-encode decoded bits and count hard-decision symbol mismatches.

    The production self-check of the reference chain: ``icesync.c:381-390``
    and ``vdecode.c:174-177`` re-encode the decoder output and compare it
    with hard slices (>128) of the received soft symbols to estimate the
    channel symbol error rate.
    """
    symbols, _ = encode_bits(decoded_bits, encstate, code)
    hard = (soft_symbols.astype(jnp.int32) > 128).astype(jnp.uint8)
    return (symbols != hard).sum(axis=-1)
